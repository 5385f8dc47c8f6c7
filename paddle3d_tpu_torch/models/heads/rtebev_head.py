"""RTEBev head, torch port of paddle3d_tpu/models/heads/rtebev_head.py
(_RTEBevDecoderLayer, RTEBevHead).

A hybrid-matching (H-DETR) NMS-free query head over the BEV map: learned
3-D reference points, num_queries_one2one of them matched one to one
against the gt, the rest (training only) one to many against the gt tiled
k_one2many times, the two groups kept apart by a block-diagonal
self-attention mask. Each decoder layer runs the masked self-attention,
a single-level deformable cross-attention over the BEV tokens (in (y, x)
order, ops/ms_deform_attn) and the FFN, each followed by a LayerNorm; the
class and box branches are shared by the layers. Serving decodes the last
layer's one-to-one queries NMS-free (petr_head.nms_free_decode: a stable
descending sort for jax.lax.top_k), boxes with a bottom z.

The BEV arrives NCHW, [B, C, gy, gx], as the BEV encoder's neck gives it.
The JAX head's reference-YAML knobs (a nested `transformer:` spec, a
bbox_coder's pc_range and max_num) are read as its __init__ reads them.
"""
from typing import Sequence

import torch
from torch import nn

from ...apis import manager
from ..layers.layer_libs import Sequential, default_generator
from ..transformers.attentions import MSDeformableAttention
from ..transformers.transformer_layers import (FFN, MultiHeadAttention,
                                               layer_norm, linear)
from .petr_head import (encode_gt, inverse_sigmoid, nms_free_decode,
                        pos2posemb3d, set_loss)
from .target_assigners import HungarianAssigner3D

__all__ = ["RTEBevHead"]


class _RTEBevDecoderLayer(nn.Module):
    """self_attn (masked) -> norm -> deformable cross_attn over the BEV ->
    norm -> ffn -> norm."""

    def __init__(self, embed_dims, num_heads, feedforward_channels,
                 num_points=4, generator=None):
        super().__init__()
        self.self_attn = MultiHeadAttention(embed_dims, num_heads,
                                            generator=generator)
        self.cross_attn = MSDeformableAttention(
            embed_dims, num_heads, num_levels=1, num_points=num_points,
            generator=generator)
        self.norms = nn.ModuleList([layer_norm(embed_dims)
                                    for _ in range(3)])
        self.ffn = FFN(embed_dims, feedforward_channels,
                       generator=generator)

    def forward(self, query, bev_tokens, query_pos, ref_2d, spatial_shapes,
                attn_mask=None):
        query = query + self.self_attn(query, query, query,
                                       query_pos=query_pos,
                                       key_pos=query_pos,
                                       attn_mask=attn_mask)
        query = self.norms[0](query)
        query = query + self.cross_attn(query + query_pos, bev_tokens,
                                        ref_2d, spatial_shapes)
        query = self.norms[1](query)
        return self.norms[2](self.ffn(query))


@manager.HEADS.add_component
class RTEBevHead(nn.Module):
    def __init__(self,
                 num_classes: int = 10,
                 in_channels: int = 256,
                 embed_dims: int = 256,
                 num_query: int = 1536,
                 num_queries_one2one: int = 512,
                 k_one2many: int = 4,
                 lambda_one2many: float = 1.0,
                 num_layers: int = 2,
                 num_heads: int = 8,
                 feedforward_channels: int = 512,
                 bev_h: int = 128,
                 bev_w: int = 128,
                 pc_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2,
                                              51.2, 3.0),
                 code_size: int = 10,
                 code_weights: Sequence[float] = None,
                 cls_weight: float = 2.0,
                 reg_weight: float = 0.25,
                 transformer: dict = None,
                 bbox_coder=None,
                 generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        if transformer:
            embed_dims = transformer.get("embed_dims", embed_dims)
            dec = transformer.get("decoder", {}) or {}
            num_layers = dec.get("num_layers", num_layers)
            tl = dec.get("transformerlayers", {}) or {}
            feedforward_channels = tl.get("feedforward_channels",
                                          feedforward_channels)
        if getattr(bbox_coder, "pc_range", None):
            pc_range = bbox_coder.pc_range
        self.max_num = getattr(bbox_coder, "max_num", 300)
        self.num_classes = num_classes
        self.embed_dims = embed_dims
        self.num_query = num_query
        self.num_queries_one2one = num_queries_one2one
        self.k_one2many = k_one2many
        self.lambda_one2many = float(lambda_one2many)
        self.bev_h, self.bev_w = bev_h, bev_w
        self.pc_range = list(map(float, pc_range))
        self.code_size = code_size
        self.code_weights = list(code_weights) if code_weights else \
            [1.0] * 8 + [0.2] * (code_size - 8)
        self.cls_weight = cls_weight
        self.reg_weight = reg_weight

        self.input_proj = (linear(in_channels, embed_dims, generator)
                           if in_channels != embed_dims else None)
        self.reference_points = nn.Parameter(torch.rand(
            (num_queries_one2one, 3), generator=generator))
        self.reference_points_12m = nn.Parameter(torch.rand(
            (max(num_query - num_queries_one2one, 1), 3),
            generator=generator))
        self.query_embedding = Sequential(
            linear(embed_dims * 3 // 2, embed_dims, generator), nn.ReLU(),
            linear(embed_dims, embed_dims, generator))
        self.layers = nn.ModuleList([
            _RTEBevDecoderLayer(embed_dims, num_heads, feedforward_channels,
                                generator=generator)
            for _ in range(num_layers)])
        self.cls_branch = Sequential(
            linear(embed_dims, embed_dims, generator),
            layer_norm(embed_dims), nn.ReLU(),
            linear(embed_dims, embed_dims, generator),
            layer_norm(embed_dims), nn.ReLU(),
            linear(embed_dims, num_classes, generator))
        nn.init.constant_(self.cls_branch.layers[6].bias, -2.19)
        self.reg_branch = Sequential(
            linear(embed_dims, embed_dims, generator), nn.ReLU(),
            linear(embed_dims, embed_dims, generator), nn.ReLU(),
            linear(embed_dims, code_size, generator))
        self.assigner = HungarianAssigner3D()

    # --------------------------------------------------------------- forward
    def forward(self, bev, training: bool = False):
        """bev [B, C, gy, gx] -> (all_cls [L, B, Qt, num_classes],
        all_bbox [L, B, Qt, code_size]): Qt = num_query in training
        (one2one, then one2many), else num_queries_one2one; boxes [cx, cy,
        cz, log w, log l, log h, sin, cos, vx, vy]."""
        b, _, gy, gx = bev.shape
        tokens = bev.flatten(2).transpose(1, 2)          # (y, x) order
        if self.input_proj is not None:
            tokens = self.input_proj(tokens)
        ref = self.reference_points
        attn_mask = None
        if training and self.k_one2many > 0:
            ref = torch.cat([ref, self.reference_points_12m], dim=0)
            # True = may attend: each group sees only itself
            one2one = torch.arange(ref.shape[0], device=ref.device) < \
                self.num_queries_one2one
            attn_mask = one2one[:, None] == one2one[None, :]
        ref = ref.clamp(1e-3, 1 - 1e-3)
        ref_b = ref[None].expand(b, -1, -1).to(tokens.dtype)
        query_pos = self.query_embedding(pos2posemb3d(ref_b,
                                                      self.embed_dims // 2))
        query = torch.zeros_like(query_pos)
        outs = []
        for layer in self.layers:
            query = layer(query, tokens, query_pos, ref_b[..., :2],
                          ((gy, gx),), attn_mask=attn_mask)
            outs.append(query)
        inter = torch.stack(outs)
        cls = self.cls_branch(inter)
        reg = self.reg_branch(inter)
        pc = self.pc_range
        ref_inv = inverse_sigmoid(ref_b)
        cx = torch.sigmoid(reg[..., 0:1] + ref_inv[..., 0:1])
        cy = torch.sigmoid(reg[..., 1:2] + ref_inv[..., 1:2])
        cz = torch.sigmoid(reg[..., 4:5] + ref_inv[..., 2:3])
        cx = cx * (pc[3] - pc[0]) + pc[0]
        cy = cy * (pc[4] - pc[1]) + pc[1]
        cz = cz * (pc[5] - pc[2]) + pc[2]
        bbox = torch.cat([cx, cy, cz, reg[..., 2:4], reg[..., 5:6],
                          reg[..., 6:]], dim=-1)
        return cls, bbox

    # ------------------------------------------------------------------ loss
    def loss(self, all_cls, all_bbox, gt_boxes, gt_labels) -> dict:
        """gt_boxes [B, G, 7|9] (centre z), gt_labels [B, G] (-1 pad):
        the one2one queries' Hungarian loss against the gt, and with the
        one2many queries present, theirs against the gt tiled k_one2many
        times, weighted by lambda_one2many."""
        q1 = self.num_queries_one2one
        cls_o, reg_o = set_loss(
            self.assigner, all_cls[:, :, :q1], all_bbox[:, :, :q1],
            encode_gt(gt_boxes, self.code_size), gt_labels,
            self.code_weights, self.num_classes)
        out = {"loss_cls": self.cls_weight * cls_o,
               "loss_bbox": self.reg_weight * reg_o}
        if self.k_one2many > 0 and all_cls.shape[2] > q1:
            k = self.k_one2many
            cls_m, reg_m = set_loss(
                self.assigner, all_cls[:, :, q1:], all_bbox[:, :, q1:],
                encode_gt(gt_boxes.repeat(1, k, 1), self.code_size),
                gt_labels.repeat(1, k), self.code_weights, self.num_classes)
            lam = self.lambda_one2many
            out["loss_cls_one2many"] = lam * self.cls_weight * cls_m
            out["loss_bbox_one2many"] = lam * self.reg_weight * reg_m
        out["loss"] = sum(out.values())
        return out

    # --------------------------------------------------------------- predict
    def predict(self, all_cls, all_bbox, max_num: int = None,
                score_threshold: float = 0.0) -> dict:
        """The last layer's one2one queries decoded NMS-free
        (petr_head.nms_free_decode)."""
        q1 = self.num_queries_one2one
        return nms_free_decode(all_cls[-1, :, :q1], all_bbox[-1, :, :q1],
                               self.num_classes, self.code_size,
                               max_num or self.max_num, score_threshold)
