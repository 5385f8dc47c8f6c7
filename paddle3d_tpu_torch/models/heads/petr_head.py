"""PETR head, torch port of paddle3d_tpu/models/heads/petr_head.py
(pos2posemb3d, inverse_sigmoid, PETRHead).

3-D position-embedded DETR head: each camera's feature-map pixels are
lifted along depth_num LID depth bins through the camera's img2lidar
matrix (normalised [0, 1] image coordinates), clipped into
position_range and encoded by an MLP into a position embedding added to
the image tokens' keys; learned 3-D reference points, through a sine
embedding and an MLP, are the queries' positions; a stack of post-norm
decoder layers (self-attention, cross-attention over every camera's
tokens, FFN) returns every layer's queries, and each layer's class and
box branches are supervised through Hungarian matching. The decode is
NMS-free: the last layer's top max_num scores over queries x classes.

Feature maps arrive NCHW per camera, [B, N, C, h, w]; tokens flatten in
(camera, y, x) order with channels last, as the JAX package's NHWC maps
do. The decode's top-k is a stable descending sort (ties keep the lower
index, as jax.lax.top_k) and gathers with torch.gather: PETR reaches no
hand-written kernel. The JAX head's reference-YAML knobs (a nested
transformer spec, loss and coder objects, with_time / with_denoise /
scalar) arrive with the reference type names (models/aliases.py,
ROADMAP.md, queue 1, item 5): no config of the repo sets them.
"""
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...apis import manager
from ..layers.layer_libs import Sequential, default_generator, lecun_normal_
from ..losses.weighted_loss import sigmoid_focal_loss
from ..transformers.transformer_layers import (BaseTransformerLayer,
                                               MultiHeadAttention,
                                               TransformerLayerSequence,
                                               linear)
from .target_assigners import HungarianAssigner3D

__all__ = ["PETRHead", "pos2posemb3d", "inverse_sigmoid", "encode_gt",
           "set_loss", "nms_free_decode"]


def pos2posemb3d(pos: torch.Tensor, num_feats: int = 128,
                 temperature: int = 10000) -> torch.Tensor:
    """[..., 3] normalised positions -> [..., 3 * num_feats] sine
    embedding (per axis: the sines of the even frequencies, then the
    cosines of the odd ones)."""
    pos = pos * (2 * math.pi)
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / num_feats)
    out = []
    for i in range(3):
        p = pos[..., i:i + 1] / dim_t
        out.append(torch.cat([torch.sin(p[..., 0::2]),
                              torch.cos(p[..., 1::2])], dim=-1))
    return torch.cat(out, dim=-1)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def encode_gt(gt_boxes: torch.Tensor, code_size: int) -> torch.Tensor:
    """[..., G, 7|9] boxes (centre z) -> [..., G, code_size] targets [cx,
    cy, cz, log w, log l, log h, sin, cos, (vx, vy)]."""
    logs = torch.log(gt_boxes[..., 3:6].clamp(min=1e-3))
    yaw = gt_boxes[..., 6:7]
    parts = [gt_boxes[..., :3], logs, torch.sin(yaw), torch.cos(yaw)]
    if code_size > 8:
        parts.append(gt_boxes[..., 7:9] if gt_boxes.shape[-1] > 7 else
                     gt_boxes.new_zeros(gt_boxes.shape[:-1] + (2,)))
    return torch.cat(parts, dim=-1)


def set_loss(assigner, all_cls, all_bbox, gt_enc, gt_labels,
             code_weights, num_classes):
    """The Hungarian set loss of every layer (one host solve a layer for
    the batch): all_cls [L, B, Q, C], all_bbox [L, B, Q, code], gt_enc [B,
    G, code] (encode_gt), gt_labels [B, G] (-1 pad) -> (the focal class
    loss and the weighted L1 box loss, each over the matched queries,
    averaged over the batch, summed over the layers)."""
    cw = torch.tensor(code_weights, dtype=all_bbox.dtype,
                      device=all_bbox.device)
    code = gt_enc.shape[-1]
    total_cls = total_reg = 0.
    for cls_l, bbox_l in zip(all_cls, all_bbox):
        assigned, is_fg = assigner.assign(bbox_l, cls_l, gt_enc, gt_labels)
        safe = assigned.clamp(min=0)
        tgt_label = torch.where(is_fg, torch.gather(gt_labels.long(), 1,
                                                    safe), num_classes)
        onehot = F.one_hot(tgt_label, num_classes + 1)[
            ..., :num_classes].to(cls_l.dtype)
        num_fg = is_fg.sum(dim=1).clamp(min=1)
        cls_loss = sigmoid_focal_loss(cls_l, onehot).sum(dim=(1, 2)) / num_fg
        tgt_box = torch.gather(gt_enc, 1, safe[..., None].expand(-1, -1,
                                                                 code))
        reg_l1 = torch.abs(bbox_l - tgt_box) * cw
        reg_loss = torch.where(is_fg[..., None], reg_l1, 0.).sum(
            dim=(1, 2)) / num_fg
        total_cls = total_cls + cls_loss.mean()
        total_reg = total_reg + reg_loss.mean()
    return total_cls, total_reg


def nms_free_decode(cls, bbox, num_classes, code_size, max_num,
                    score_threshold) -> dict:
    """One layer's NMS-free decode: cls [B, Q, C], bbox [B, Q, code] ->
    the top max_num scores over queries x classes (a stable descending
    sort: ties keep the lower index, as jax.lax.top_k), box3d_lidar [B, K,
    7|9] as (x, y, z bottom, w, l, h, yaw, [vx, vy]), scores [B, K] and
    label_preds [B, K], -1 where a score is not above the threshold."""
    b = cls.shape[0]
    scores = torch.sigmoid(cls).reshape(b, -1)
    k = min(max_num, scores.shape[1])
    top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    qi = idx // num_classes
    labels = idx % num_classes
    box = torch.gather(bbox, 1, qi[..., None].expand(-1, -1,
                                                      bbox.shape[-1]))
    yaw = torch.atan2(box[..., 6], box[..., 7])
    dims = torch.exp(box[..., 3:6])
    cols = [box[..., 0:2], (box[..., 2] - dims[..., 2] / 2)[..., None],
            dims, yaw[..., None]]
    if code_size > 8:
        cols.append(box[..., 8:10])
    valid = top > score_threshold
    return {"box3d_lidar": torch.cat(cols, dim=-1),
            "scores": torch.where(valid, top, -1.),
            "label_preds": torch.where(valid, labels, -1)}


def _mlp(cin, mid, cout, generator):
    return Sequential(linear(cin, mid, generator), nn.ReLU(),
                      linear(mid, cout, generator))


@manager.HEADS.add_component
class PETRHead(nn.Module):
    def __init__(self,
                 num_classes: int = 10,
                 in_channels: int = 256,
                 embed_dims: int = 256,
                 num_query: int = 900,
                 num_heads: int = 8,
                 num_layers: int = 6,
                 depth_num: int = 64,
                 depth_start: float = 1.0,
                 position_range: Sequence[float] = (-61.2, -61.2, -10.0,
                                                    61.2, 61.2, 10.0),
                 pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2,
                                              51.2, 3.0),
                 code_size: int = 10,
                 code_weights: Sequence[float] = None,
                 cls_weight: float = 2.0,
                 reg_weight: float = 0.25,
                 generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        self.num_classes = num_classes
        self.embed_dims = embed_dims
        self.num_query = num_query
        self.depth_num = depth_num
        self.depth_start = depth_start
        self.position_range = list(map(float, position_range))
        self.pc_range = list(map(float, pc_range))
        self.code_size = code_size
        self.code_weights = list(code_weights) if code_weights else \
            [1.0] * 8 + [0.2] * (code_size - 8)
        self.cls_weight = cls_weight
        self.reg_weight = reg_weight
        self.num_layers = num_layers

        self.input_proj = nn.utils.skip_init(nn.Conv2d, in_channels,
                                             embed_dims, 1)
        lecun_normal_(self.input_proj.weight, generator)
        nn.init.zeros_(self.input_proj.bias)
        # the frustum's D x 3 coordinates of a pixel -> its embedding
        self.position_encoder = _mlp(depth_num * 3, embed_dims * 4,
                                     embed_dims, generator)
        self.reference_points = nn.Parameter(
            torch.rand((num_query, 3), generator=generator))
        self.query_embedding = _mlp(embed_dims * 3 // 2, embed_dims,
                                    embed_dims, generator)
        layers = [
            BaseTransformerLayer(
                attns=[MultiHeadAttention(embed_dims, num_heads,
                                          generator=generator)
                       for _ in range(2)],
                embed_dims=embed_dims, feedforward_channels=embed_dims * 4,
                operation_order=("self_attn", "norm", "cross_attn", "norm",
                                 "ffn", "norm"),
                generator=generator) for _ in range(num_layers)]
        self.decoder = TransformerLayerSequence(
            layers, return_intermediate=True, post_norm=True,
            embed_dims=embed_dims)
        self.cls_branch = _mlp(embed_dims, embed_dims, num_classes,
                               generator)
        nn.init.constant_(self.cls_branch.layers[2].bias, -2.19)
        self.reg_branch = _mlp(embed_dims, embed_dims, code_size, generator)
        self.assigner = HungarianAssigner3D()

    # ----------------------------------------------------------- 3D position
    def _position_embedding(self, h: int, w: int,
                            img2lidars: torch.Tensor) -> torch.Tensor:
        """The position embedding of an h x w feature map under each camera
        of img2lidars [B, N, 4, 4] -> [B, N, h, w, embed_dims]: pixel
        centres x LID depths lifted to lidar space, normalised into
        position_range and clipped to [0, 1], as (D, 3) per pixel through
        position_encoder."""
        b, n = img2lidars.shape[:2]
        pr = self.position_range
        dev = img2lidars.device
        f32 = dict(dtype=torch.float32, device=dev)
        ys = (torch.arange(h, **f32) + 0.5) / h
        xs = (torch.arange(w, **f32) + 0.5) / w
        d_idx = torch.arange(self.depth_num, **f32)
        bin_size = 2 * (pr[3] - self.depth_start) / (
            self.depth_num * (1 + self.depth_num))
        depths = self.depth_start + bin_size * d_idx * (d_idx + 1) / 2
        grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")    # [h, w]
        d = depths[:, None, None]
        pts = torch.stack([grid_x * d, grid_y * d, d.expand(-1, h, w),
                           torch.ones((self.depth_num, h, w), **f32)],
                          dim=-1)                                # [D, h, w, 4]
        mats = img2lidars[..., :3, :]
        coords = torch.einsum("bnij,dhwj->bnhwdi", mats, pts.to(mats.dtype))
        lo = torch.tensor(pr[:3], dtype=coords.dtype, device=dev)
        hi = torch.tensor(pr[3:], dtype=coords.dtype, device=dev)
        coords = ((coords - lo) / (hi - lo)).clamp(0., 1.)
        return self.position_encoder(coords.reshape(b, n, h, w, -1))

    # --------------------------------------------------------------- forward
    def tokens(self, feats: torch.Tensor, img2lidars: torch.Tensor):
        """feats [B, N, Cin, h, w] -> (tokens, their position embeddings),
        both [B, N·h·w, embed_dims] in (camera, y, x) order."""
        b, n, c, h, w = feats.shape
        x = self.input_proj(feats.reshape(b * n, c, h, w))
        tokens = x.reshape(b, n, -1, h, w).permute(0, 1, 3, 4, 2).reshape(
            b, n * h * w, -1)
        pe = self._position_embedding(h, w, img2lidars)
        return tokens, pe.reshape(b, n * h * w, -1)

    def forward(self, feats, img2lidars, dn_ref=None, attn_mask=None):
        """feats [B, N, Cin, h, w], img2lidars [B, N, 4, 4] -> (all_cls
        [L, B, Q, C], all_bbox [L, B, Q, code_size]: boxes as [cx, cy, cz,
        log w, log l, log h, sin, cos, vx, vy]). With dn_ref [B, Qdn, 3]
        the denoising queries follow the matching ones, and attn_mask [Qt,
        Qt] (True = may attend) gates the self-attention."""
        tokens, key_pos = self.tokens(feats, img2lidars)
        return self._decode(tokens, key_pos, dn_ref=dn_ref,
                            attn_mask=attn_mask)

    def decode_over_tokens(self, tokens, token_shape=None):
        """The DETR decode over tokens encoded elsewhere (BEVFormer's BEV
        tokens [B, T, embed_dims]), with no key position embedding ->
        (all_cls, all_bbox) as forward gives them."""
        return self._decode(tokens, None)

    def query_reference_points(self, batch_size: int, dn_ref=None):
        """[B, Qt, 3] matching (then DN) reference points in [0, 1]."""
        ref = torch.sigmoid(inverse_sigmoid(
            self.reference_points.clamp(1e-3, 1 - 1e-3)))
        ref = ref[None].expand(batch_size, -1, -1)
        if dn_ref is not None:
            ref = torch.cat([ref, dn_ref.to(ref.dtype)], dim=1)
        return ref

    def _decode(self, tokens, key_pos, dn_ref=None, attn_mask=None):
        """tokens and key_pos [B, T, embed_dims] (key_pos None: the keys
        carry no position embedding)."""
        b = tokens.shape[0]
        ref = self.query_reference_points(b, dn_ref)
        query_pos = self.query_embedding(pos2posemb3d(ref,
                                                      self.embed_dims // 2))
        query = torch.zeros((b, ref.shape[1], self.embed_dims),
                            dtype=tokens.dtype, device=tokens.device)
        inter = self.decoder(query, key=tokens, value=tokens,
                             query_pos=query_pos, key_pos=key_pos,
                             attn_masks=attn_mask)             # [L, B, Q, C]
        return self.branches(inter, ref)

    def branches(self, inter, ref):
        """Every layer's queries inter [L, B, Q, C] and their reference
        points ref [B, Q, 3] -> (all_cls [L, B, Q, num_classes], all_bbox
        [L, B, Q, code_size])."""
        cls = self.cls_branch(inter)
        reg = self.reg_branch(inter)
        pc = self.pc_range
        ref_inv = inverse_sigmoid(ref)
        cx = torch.sigmoid(reg[..., 0:1] + ref_inv[..., 0:1])
        cy = torch.sigmoid(reg[..., 1:2] + ref_inv[..., 1:2])
        cz = torch.sigmoid(reg[..., 4:5] + ref_inv[..., 2:3])
        cx = cx * (pc[3] - pc[0]) + pc[0]
        cy = cy * (pc[4] - pc[1]) + pc[1]
        cz = cz * (pc[5] - pc[2]) + pc[2]
        # the branch's [cx, cy, w, l, cz, h, sin, cos, vx, vy] -> [cx, cy,
        # cz, w, l, h, sin, cos, vx, vy]
        bbox = torch.cat([cx, cy, cz, reg[..., 2:4], reg[..., 5:6],
                          reg[..., 6:]], dim=-1)
        return cls, bbox

    # ------------------------------------------------------------------ loss
    def _encode_gt(self, gt_boxes: torch.Tensor) -> torch.Tensor:
        return encode_gt(gt_boxes, self.code_size)

    def loss(self, all_cls, all_bbox, gt_boxes, gt_labels,
             dn_meta=None) -> dict:
        """gt_boxes [B, G, 7|9] (centre z), gt_labels [B, G] (-1 pad).
        Each layer's matching queries get the Hungarian loss (set_loss);
        with dn_meta the queries past num_query get the known-assignment
        DN loss (heads/denoising.py)."""
        gt_enc = self._encode_gt(gt_boxes)
        out_dn = None
        if dn_meta is not None:
            from .denoising import dn_loss
            out_dn = dn_loss(all_cls[:, :, self.num_query:],
                             all_bbox[:, :, self.num_query:], dn_meta,
                             gt_enc, self.code_weights, self.num_classes)
            all_cls = all_cls[:, :, :self.num_query]
            all_bbox = all_bbox[:, :, :self.num_query]
        total_cls, total_reg = set_loss(self.assigner, all_cls, all_bbox,
                                        gt_enc, gt_labels, self.code_weights,
                                        self.num_classes)
        out = {"loss_cls": self.cls_weight * total_cls,
               "loss_bbox": self.reg_weight * total_reg}
        if out_dn is not None:
            out["loss_cls_dn"] = self.cls_weight * out_dn[0]
            out["loss_bbox_dn"] = self.reg_weight * out_dn[1]
        out["loss"] = sum(out.values())
        return out

    # --------------------------------------------------------------- predict
    def predict(self, all_cls, all_bbox, max_num: int = 300,
                score_threshold: float = 0.0) -> dict:
        """The last layer's NMS-free decode (nms_free_decode)."""
        return nms_free_decode(all_cls[-1], all_bbox[-1], self.num_classes,
                               self.code_size, max_num, score_threshold)
