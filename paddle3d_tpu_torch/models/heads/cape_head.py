"""CAPE / CAPE-T head, torch port of paddle3d_tpu/models/heads/cape_head.py
(_EgoEmb, _MLPFusion, CAPEHead).

Camera-view position embeddings: where PETR embeds every camera's tokens
and the queries in the lidar frame and attends over all cameras at once,
CAPE decodes each camera in its own frame. A camera's key position
embedding is PETR's frustum lifted through img2cam = lidar2cam @ img2lidar
(no ego pose); the queries' reference points are moved into each camera,
clipped into position_range and embedded there; every decoder layer runs
the masked self-attention with the lidar-frame query embedding, then one
cross-attention a camera with that camera's embeddings, each output times
the query's visibility in that camera (its camera z above 0.1), summed in
camera order and divided by the count of cameras that see it (at least
1), then the FFN and the three norms. The cameras are one attention call
(folded into the batch), the per-camera outputs added in camera order
0 ... N-1, as the JAX loop adds them.

CAPE-T (with_time): the view axis holds the current frame's cameras then
the previous frame's. Both frames decode as two query streams in one
doubled batch, each attending to its own frame's cameras, and after every
layer a gated MLP fusion, conditioned on the ego rotation current ->
previous lidar frame (from lidar2cams), mixes the streams. Velocities are
divided by max(time_lag, 1e-2) (default_time_lag when none is given: the
model passes none). With with_prev_aux_loss, the previous stream's outputs
stay in `_prev_outputs` until `loss`, which adds prev_aux_loss_weight x its
Hungarian loss over the first num_query queries (the DN queries left out).
Without lidar2cams the head falls back to PETR's global decode.
"""
import torch
from torch import nn

from ...apis import manager
from ..layers.layer_libs import default_generator
from ..transformers.transformer_layers import layer_norm, linear
from .petr_head import PETRHead, pos2posemb3d

__all__ = ["CAPEHead"]


class _EgoEmb(nn.Module):
    """The 9 entries of the ego rotation -> a sigmoid channel gate."""

    def __init__(self, dim: int, generator: torch.Generator):
        super().__init__()
        self.fc = linear(9, dim, generator)
        self.norm = layer_norm(dim)

    def forward(self, ego_rot):
        """ego_rot [B, 3, 3] -> [B, 1, dim]."""
        return torch.sigmoid(self.norm(self.fc(
            ego_rot.reshape(ego_rot.shape[0], 1, 9))))


class _MLPFusion(nn.Module):
    """Gated fusion of the current and the previous query streams."""

    def __init__(self, dim: int, generator: torch.Generator):
        super().__init__()
        self.proj_k_a = linear(dim, dim, generator)
        self.proj_k_b = linear(dim, dim, generator)
        self.proj_v_a = linear(dim, dim, generator)
        self.proj_v_b = linear(dim, dim, generator)
        self.fc = linear(dim * 2, dim, generator)
        self.norm = layer_norm(dim)
        self.ego = _EgoEmb(dim, generator)

    def forward(self, cur, prev, ego_rot):
        """cur, prev [B, Q, C]; ego_rot [B, 3, 3] -> the fused (cur,
        prev)."""
        k_a = self.proj_k_a(cur)
        k_b = self.proj_k_b(prev) * self.ego(ego_rot)
        w = torch.sigmoid(self.norm(self.fc(torch.cat([k_a, k_b], dim=-1))))
        return w * self.proj_v_a(cur), (1 - w) * self.proj_v_b(prev)


@manager.HEADS.add_component
class CAPEHead(PETRHead):
    """lidar2cams [B, N, 4, 4] maps the lidar frame into each camera's;
    with with_time, N = 2 x the cameras (the current frame first)."""

    # the PETR model hands a head with this flag batch["lidar2cams"]
    wants_lidar2cams = True

    def __init__(self, *args, with_time: bool = False,
                 with_prev_aux_loss: bool = False,
                 prev_aux_loss_weight: float = 0.1,
                 default_time_lag: float = 0.5,
                 generator: torch.Generator = None, **kwargs):
        generator = default_generator(generator)
        super().__init__(*args, generator=generator, **kwargs)
        self.with_time = with_time
        self.with_prev_aux_loss = with_prev_aux_loss
        self.prev_aux_loss_weight = float(prev_aux_loss_weight)
        self.default_time_lag = float(default_time_lag)
        if with_time:
            self.mlp_fusion = nn.ModuleList([
                _MLPFusion(self.embed_dims, generator)
                for _ in range(self.num_layers)])
        # the previous stream's (all_cls, all_bbox), from forward to loss
        self._prev_outputs = None

    # -------------------------------------------------------------- helpers
    def _camera_frame_inputs(self, feats, img2lidars, lidar2cams, dn_ref):
        """feats [B, N, Cin, h, w] -> (tokens and key PE [B, N, h*w, C],
        the queries' camera-frame PE [B, N, Qt, C], visible [B, N, Qt]
        (0 / 1), the lidar-frame query PE [B, Qt, C], ref [B, Qt, 3])."""
        b, n, c, h, w = feats.shape
        x = self.input_proj(feats.reshape(b * n, c, h, w))
        tokens = x.reshape(b, n, -1, h * w).transpose(2, 3)
        img2cams = torch.einsum("bnij,bnjk->bnik", lidar2cams, img2lidars)
        key_pos = self._position_embedding(h, w, img2cams).reshape(
            b, n, h * w, -1)
        ref = self.query_reference_points(b, dn_ref)          # [B, Qt, 3]
        pc = torch.tensor(self.pc_range, dtype=ref.dtype, device=ref.device)
        ref_world = ref * (pc[3:] - pc[:3]) + pc[:3]
        homo = torch.cat([ref_world, torch.ones_like(ref_world[..., :1])],
                         dim=-1)
        cam_pts = torch.einsum("bnij,bqj->bnqi", lidar2cams.to(ref.dtype),
                               homo)[..., :3]
        pr = torch.tensor(self.position_range, dtype=ref.dtype,
                          device=ref.device)
        cam_ref = ((cam_pts - pr[:3]) / (pr[3:] - pr[:3])).clamp(0., 1.)
        q_pos_cam = self.query_embedding(pos2posemb3d(
            cam_ref, self.embed_dims // 2))                  # [B, N, Qt, C]
        visible = (cam_pts[..., 2] > 0.1).to(ref.dtype)      # [B, N, Qt]
        q_pos_global = self.query_embedding(pos2posemb3d(
            ref, self.embed_dims // 2))
        return tokens, key_pos, q_pos_cam, visible, q_pos_global, ref

    def _decode_layers(self, tokens, key_pos, q_pos_cam, visible,
                       q_pos_global, attn_mask, fusion_ego=None):
        """The decoder over each camera in its frame -> every layer's
        post-normed queries [L, B, Qt, C]. With fusion_ego [B', 3, 3] the
        batch holds the [current ++ previous] streams, fused after every
        layer."""
        b, n, t, c = tokens.shape
        qt = q_pos_global.shape[1]
        query = torch.zeros_like(q_pos_global)
        denom = visible.sum(dim=1).clamp(min=1.)[..., None]  # [B, Qt, 1]
        flat_tokens = tokens.reshape(b * n, t, c)
        flat_key_pos = key_pos.reshape(b * n, t, c)
        flat_q_pos = q_pos_cam.reshape(b * n, qt, c)
        inter = []
        for li, layer in enumerate(self.decoder.layers):
            q = query + layer.attns[0](query, query, query,
                                       query_pos=q_pos_global,
                                       key_pos=q_pos_global,
                                       attn_mask=attn_mask)
            q = layer.norms[0](q)
            # every camera's cross-attention in its own frame, one call
            out = layer.attns[1](
                q[:, None].expand(b, n, qt, c).reshape(b * n, qt, c),
                flat_tokens, flat_tokens, query_pos=flat_q_pos,
                key_pos=flat_key_pos).reshape(b, n, qt, c)
            out = out * visible[..., None]
            cross = out[:, 0]
            for cam in range(1, n):
                cross = cross + out[:, cam]
            q = layer.norms[1](q + cross / denom)
            query = layer.norms[2](layer.ffn(q))
            if fusion_ego is not None:
                half = query.shape[0] // 2
                cur, prev = self.mlp_fusion[li](query[:half], query[half:],
                                                fusion_ego)
                query = torch.cat([cur, prev], dim=0)
            inter.append(query if self.decoder.post_norm is None
                         else self.decoder.post_norm(query))
        return torch.stack(inter)

    def _branches(self, inter, ref, time_lag=None):
        cls, bbox = self.branches(inter, ref)
        if self.with_time and bbox.shape[-1] > 8:
            lag = time_lag if time_lag is not None else self.default_time_lag
            lag = torch.as_tensor(lag, dtype=torch.float32).clamp(min=1e-2)
            bbox = torch.cat([bbox[..., :8], bbox[..., 8:] / lag.to(
                bbox.device)], dim=-1)
        return cls, bbox

    # --------------------------------------------------------------- forward
    def forward(self, feats, img2lidars, lidar2cams=None, dn_ref=None,
                attn_mask=None, time_lag=None):
        """feats [B, N, Cin, h, w], img2lidars and lidar2cams [B, N, 4, 4]
        -> (all_cls [L, B, Qt, C], all_bbox [L, B, Qt, code_size]) as
        PETRHead.forward gives them."""
        if lidar2cams is None:
            return super().forward(feats, img2lidars, dn_ref=dn_ref,
                                   attn_mask=attn_mask)
        inputs = self._camera_frame_inputs(feats, img2lidars, lidar2cams,
                                           dn_ref)
        tokens, key_pos, q_pos_cam, visible, q_pos_global, ref = inputs
        if not self.with_time:
            inter = self._decode_layers(tokens, key_pos, q_pos_cam, visible,
                                        q_pos_global, attn_mask)
            return self._branches(inter, ref)

        # the doubled view axis -> the [current ++ previous] streams
        b = feats.shape[0]
        n = feats.shape[1] // 2

        def split_cat(x):                   # [B, 2N, ...] -> [2B, N, ...]
            return torch.cat([x[:, :n], x[:, n:]], dim=0)

        # the ego motion current -> previous lidar frame, from the rig
        ego = torch.matmul(torch.linalg.inv(lidar2cams[:, 0]),
                           lidar2cams[:, n])[:, :3, :3]
        inter2 = self._decode_layers(
            split_cat(tokens), split_cat(key_pos), split_cat(q_pos_cam),
            split_cat(visible), torch.cat([q_pos_global] * 2, dim=0),
            attn_mask, fusion_ego=ego.to(tokens.dtype))
        out = self._branches(inter2[:, :b], ref, time_lag)
        if self.with_prev_aux_loss:
            self._prev_outputs = self._branches(inter2[:, b:], ref, time_lag)
        return out

    # ------------------------------------------------------------------ loss
    def loss(self, all_cls, all_bbox, gt_boxes, gt_labels,
             dn_meta=None) -> dict:
        """PETRHead.loss, plus the previous stream's weighted Hungarian
        loss (loss_cls_prev, loss_bbox_prev) when forward kept it."""
        out = super().loss(all_cls, all_bbox, gt_boxes, gt_labels,
                           dn_meta=dn_meta)
        prev = self._prev_outputs
        if self.with_prev_aux_loss and prev is not None:
            q = self.num_query
            aux = super().loss(prev[0][:, :, :q], prev[1][:, :, :q],
                               gt_boxes, gt_labels)
            w = self.prev_aux_loss_weight
            out["loss_cls_prev"] = w * aux["loss_cls"]
            out["loss_bbox_prev"] = w * aux["loss_bbox"]
            out["loss"] = (out["loss"] + out["loss_cls_prev"] +
                           out["loss_bbox_prev"])
            self._prev_outputs = None
        return out
