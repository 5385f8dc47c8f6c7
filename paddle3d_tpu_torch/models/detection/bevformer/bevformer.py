"""BEVFormer multi-view 3-D detector, torch port of
paddle3d_tpu/models/detection/bevformer/bevformer.py (BEVFormerEncoderLayer,
BEVFormer).

The images of a frame run the backbone and the neck as one NCHW batch;
the neck's first level, projected (cam_proj), is each camera's tokens. A
learned BEV grid of queries (bev_embedding, plus the CAN-bus embedding)
goes through the encoder layers: temporal self-attention over the current
and the previous BEV (ops/ms_deform_attn), spatial cross-attention over
the cameras that see each query's pillar, an FFN, each followed by a
LayerNorm. The previous BEV is explicit batch state (prev_bev), rotated by
the yaw delta and sampled through a grid shifted by the ego's translation
when a can_bus is given. A DETR decoder over the BEV tokens
(BEVFormerHead, or any PETRHead) predicts the boxes; training matches them
to the gt by Hungarian matching. BEVFormer reaches no hand-written kernel.

Batch contract (fixed shapes):
    img:        [B, N, H, W, 3] NHWC images (normalised by the dataset)
    lidar2imgs: [B, N, 4, 4] lidar -> [0, 1] image coordinates (u, v
                times depth, depth, 1)
    can_bus:    [B, 18] (optional): [0] dx, [1] dy (m, this frame less the
                previous), [-2] the ego's yaw, [-1] the yaw delta (rad)
    prev_bev:   [B, bev_h * bev_w, C] (optional) the previous frame's
                bev_feature
    img_queue:  [B, T, N, H, W, 3] with lidar2imgs_queue [B, T, N, 4, 4]
                and can_bus_queue [B, T, 18] (optional, training): history
                frames encoded without gradient, oldest first
    gt_boxes:   [B, G, 7|9] bottom-z boxes (+ vx, vy), gt_labels [B, G]
                (-1 padded), to train
test_forward refuses a model in train mode and returns bev_feature, the
carry for the next frame.

postprocess_to_samples is PETR's, as in the JAX package. Not ported: the
JAX model's knobs that no config of the repo sets (pts_bbox_head, video_test_mode, use_grid_mask, a head's
transformer spec).
"""
from typing import Sequence

import torch
from torch import nn

from ....apis import manager
from ...base.base_model import BaseMultiViewModel, raise_if_training
from ...layers.layer_libs import Sequential, default_generator
from ...transformers.attentions import (SpatialCrossAttention,
                                        TemporalSelfAttention)
from ...transformers.transformer_layers import FFN, layer_norm, linear
from ..petr.petr3d import PETR

__all__ = ["BEVFormer", "BEVFormerEncoderLayer"]


class BEVFormerEncoderLayer(nn.Module):
    def __init__(self, embed_dims, num_heads, pc_range, *, generator):
        super().__init__()
        self.tsa = TemporalSelfAttention(embed_dims, num_heads, num_levels=1,
                                         generator=generator)
        self.sca = SpatialCrossAttention(embed_dims, num_heads,
                                         pc_range=pc_range,
                                         generator=generator)
        self.norm1 = layer_norm(embed_dims)
        self.norm2 = layer_norm(embed_dims)
        self.norm3 = layer_norm(embed_dims)
        self.ffn = FFN(embed_dims, embed_dims * 4, generator=generator)

    def forward(self, bev, cam_tokens, bev_ref, cam_shapes, lidar2imgs,
                prev_bev, bev_shape, shift=None):
        x = bev + self.tsa(bev, reference_points=bev_ref[None].expand(
            bev.shape[0], -1, -1), spatial_shapes=(bev_shape,),
            prev_bev=prev_bev, shift=shift)
        x = self.norm1(x)
        x = x + self.sca(x, cam_tokens, bev_ref, lidar2imgs, cam_shapes)
        x = self.norm2(x)
        return self.norm3(self.ffn(x))


@manager.MODELS.add_component
class BEVFormer(BaseMultiViewModel):
    def __init__(self,
                 backbone,
                 neck,
                 head,
                 bev_h: int = 50,
                 bev_w: int = 50,
                 embed_dims: int = 256,
                 num_heads: int = 8,
                 encoder_layers: int = 3,
                 pc_range: Sequence[float] = (-51.2, -51.2, -5., 51.2, 51.2,
                                              3.),
                 generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        # a head that carries the BEV grid's size sets it
        if getattr(head, "bev_h", None):
            bev_h, bev_w = head.bev_h, head.bev_w
        self.backbone = backbone
        self.neck = neck
        self.head = head
        self.bev_h = bev_h
        self.bev_w = bev_w
        self.embed_dims = embed_dims
        self.pc_range = list(map(float, pc_range))

        self.bev_embedding = nn.Parameter(torch.randn(
            (bev_h * bev_w, embed_dims), generator=generator) * 0.02)
        # the CAN-bus signal's embedding, added to every BEV query
        self.can_bus_mlp = Sequential(
            linear(18, embed_dims // 2, generator), nn.ReLU(),
            linear(embed_dims // 2, embed_dims, generator), nn.ReLU(),
            layer_norm(embed_dims))
        neck_c = getattr(neck, "out_channels", None)
        if not isinstance(neck_c, int):
            neck_c = getattr(backbone, "out_channels", [256])[-1]
        self.cam_proj = linear(neck_c, embed_dims, generator)
        self.encoder = nn.ModuleList([
            BEVFormerEncoderLayer(embed_dims, num_heads, self.pc_range,
                                  generator=generator)
            for _ in range(encoder_layers)])

    # -------------------------------------------------- ego-motion alignment
    def _rotate_prev_bev(self, prev_bev, angles):
        """Each sample's BEV map [B, H*W, C] rotated by its yaw delta angles
        [B] (rad) about the map's centre: bilinear from the inverse-rotated
        cell, the corner indices clipped into the map, the fractions clipped
        to [0, 1], and 0 where the source lies outside the map."""
        h, w = self.bev_h, self.bev_w
        b = prev_bev.shape[0]
        maps = prev_bev.reshape(b, h * w, -1)
        dt, dev = prev_bev.dtype, prev_bev.device
        yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                             device=dev),
                                torch.arange(w, dtype=torch.float32,
                                             device=dev), indexing="ij")
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        a = -angles.to(dt)[:, None, None]
        cos, sin = torch.cos(a), torch.sin(a)
        sx = cx + cos * (xx - cx) - sin * (yy - cy)            # [B, H, W]
        sy = cy + sin * (xx - cx) + cos * (yy - cy)
        x0 = torch.floor(sx).long().clamp(0, w - 1)
        y0 = torch.floor(sy).long().clamp(0, h - 1)
        x1 = (x0 + 1).clamp(0, w - 1)
        y1 = (y0 + 1).clamp(0, h - 1)
        fx = (sx - x0).clamp(0., 1.)[..., None]
        fy = (sy - y0).clamp(0., 1.)[..., None]

        def at(yi, xi):
            idx = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1,
                                                          maps.shape[-1])
            return torch.gather(maps, 1, idx).reshape(b, h, w, -1)
        out = (at(y0, x0) * (1 - fx) * (1 - fy) +
               at(y0, x1) * fx * (1 - fy) +
               at(y1, x0) * (1 - fx) * fy +
               at(y1, x1) * fx * fy)
        inside = ((sx >= 0) & (sx <= w - 1) & (sy >= 0) &
                  (sy <= h - 1))[..., None]
        return torch.where(inside, out, 0.).reshape(b, h * w, -1)

    def _can_bus_shift(self, can_bus):
        """The ego's translation between frames in normalised BEV-grid
        units [B, 2] (x, y), from can_bus [B, 18]."""
        dx, dy = can_bus[:, 0], can_bus[:, 1]
        ego_angle = can_bus[:, -2]
        grid_len_y = (self.pc_range[4] - self.pc_range[1]) / self.bev_h
        grid_len_x = (self.pc_range[3] - self.pc_range[0]) / self.bev_w
        translation = torch.sqrt(dx ** 2 + dy ** 2)
        bev_angle = ego_angle - torch.atan2(dy, dx)
        shift_y = translation * torch.cos(bev_angle) / grid_len_y / self.bev_h
        shift_x = translation * torch.sin(bev_angle) / grid_len_x / self.bev_w
        return torch.stack([shift_x, shift_y], dim=-1)

    def camera_tokens(self, imgs):
        """imgs [B, N, H, W, 3] -> (tokens [B, N, h*w, C], (h, w))."""
        b, n, h, w, c = imgs.shape
        feats = self.backbone(imgs.reshape(b * n, h, w, c).permute(
            0, 3, 1, 2).contiguous())
        if self.neck is not None:
            feats = self.neck(feats)
        f = feats[0] if isinstance(feats, (tuple, list)) else feats
        fc, fh, fw = f.shape[1:]
        tokens = f.reshape(b, n, fc, fh * fw).transpose(2, 3)
        return self.cam_proj(tokens), (fh, fw)

    def bev_reference(self):
        """The BEV cells' centres in [0, 1], [bev_h * bev_w, 2] (x, y), in
        the BEV embedding's dtype."""
        like = self.bev_embedding
        ys = (torch.arange(self.bev_h, dtype=like.dtype, device=like.device)
              + 0.5) / self.bev_h
        xs = (torch.arange(self.bev_w, dtype=like.dtype, device=like.device)
              + 0.5) / self.bev_w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)

    def get_bev_features(self, imgs, lidar2imgs, prev_bev=None,
                         can_bus=None):
        """-> the encoded BEV [B, bev_h * bev_w, embed_dims]."""
        return self.encode(*self.camera_tokens(imgs), lidar2imgs, prev_bev,
                           can_bus)

    def encode(self, cam_tokens, cam_shape, lidar2imgs, prev_bev=None,
               can_bus=None):
        """The BEV queries through the encoder layers over the cameras'
        tokens [B, N, h*w, C] -> [B, bev_h * bev_w, embed_dims]."""
        b = cam_tokens.shape[0]
        bev_ref = self.bev_reference()
        bev = self.bev_embedding[None].expand(b, -1, -1)
        shift = None
        if can_bus is not None:
            bev = bev + self.can_bus_mlp(can_bus.to(bev.dtype))[:, None, :]
            if prev_bev is not None:
                # the previous BEV in this frame's ego frame: rotated by the
                # yaw delta, sampled through a grid shifted by the motion
                prev_bev = self._rotate_prev_bev(prev_bev, can_bus[:, -1])
                shift = self._can_bus_shift(can_bus)
        if prev_bev is None:
            prev_bev = bev
        for layer in self.encoder:
            bev = layer(bev, cam_tokens, bev_ref, (cam_shape,), lidar2imgs,
                        prev_bev, (self.bev_h, self.bev_w), shift=shift)
        return bev

    @torch.no_grad()
    def obtain_history_bev(self, img_queue, lidar2imgs_queue,
                           can_bus_queue=None):
        """The history queue's BEV, frame by frame, each aligned to the one
        before, without gradient (train-mode BN still updates its running
        stats, frame by frame)."""
        prev_bev = None
        for i in range(img_queue.shape[1]):
            cb = can_bus_queue[:, i] if can_bus_queue is not None else None
            prev_bev = self.get_bev_features(
                img_queue[:, i], lidar2imgs_queue[:, i], prev_bev, cb)
        return prev_bev

    def train_forward(self, batch) -> dict:
        """-> {"loss" (the total), "loss_cls", "loss_bbox"}."""
        prev_bev = batch.get("prev_bev")
        if prev_bev is None and "img_queue" in batch:
            prev_bev = self.obtain_history_bev(
                batch["img_queue"], batch["lidar2imgs_queue"],
                batch.get("can_bus_queue"))
        bev = self.get_bev_features(batch["img"], batch["lidar2imgs"],
                                    prev_bev, batch.get("can_bus"))
        all_cls, all_bbox = self.head.decode_over_tokens(
            bev, (self.bev_h, self.bev_w))
        gt_boxes = batch["gt_boxes"].clone()
        gt_boxes[..., 2] += batch["gt_boxes"][..., 5] / 2   # bottom -> centre
        return self.head.loss(all_cls, all_bbox, gt_boxes,
                              batch["gt_labels"])

    @torch.no_grad()
    def test_forward(self, batch) -> dict:
        """-> box3d_lidar [B, K, 7|9] (bottom z), scores [B, K],
        label_preds [B, K], bev_feature [B, bev_h * bev_w, embed_dims]."""
        raise_if_training(self)
        bev = self.get_bev_features(batch["img"], batch["lidar2imgs"],
                                    batch.get("prev_bev"),
                                    batch.get("can_bus"))
        out = self.head.predict(*self.head.decode_over_tokens(
            bev, (self.bev_h, self.bev_w)))
        out["bev_feature"] = bev
        return out

    postprocess_to_samples = staticmethod(PETR.postprocess_to_samples)
