"""BEVFormer's detection head, torch port of
paddle3d_tpu/models/heads/bevformer_head.py (BEVFormerHead).

PETRHead's decoder, loss and NMS-free decode over BEV tokens, with a class
and a box branch per decoder layer (`cls_branches` / `reg_branches`, the
JAX package's lists of nnx.Sequential) and, with with_box_refine, the
reference points refined layer by layer: each layer's box output moves the
points (detached) that the next layer's query position embedding is
derived from. PETRHead's own branches, input projection and position
encoder stay unused, so that the JAX state carries across whole. The head
carries the BEV grid's size (bev_h, bev_w) for the model to read.
"""
import torch
from torch import nn

from ...apis import manager
from ..layers.layer_libs import default_generator
from .petr_head import PETRHead, _mlp, inverse_sigmoid, pos2posemb3d

__all__ = ["BEVFormerHead"]


@manager.HEADS.add_component
class BEVFormerHead(PETRHead):
    def __init__(self, with_box_refine: bool = True, bev_h: int = None,
                 bev_w: int = None, generator: torch.Generator = None,
                 **kwargs):
        generator = default_generator(generator)
        super().__init__(generator=generator, **kwargs)
        self.with_box_refine = with_box_refine
        self.bev_h, self.bev_w = bev_h, bev_w
        e = self.embed_dims
        self.cls_branches = nn.ModuleList()
        self.reg_branches = nn.ModuleList()
        for _ in range(self.num_layers):
            cls = _mlp(e, e, self.num_classes, generator)
            nn.init.constant_(cls.layers[2].bias, -2.19)
            self.cls_branches.append(cls)
            self.reg_branches.append(_mlp(e, e, self.code_size, generator))

    def decode_over_tokens(self, tokens, token_shape=None):
        """tokens [B, H*W, embed_dims] -> (all_cls [L, B, Q, classes],
        all_bbox [L, B, Q, code_size]), each layer through its own
        branches, the reference points refined between layers."""
        b = tokens.shape[0]
        pc = self.pc_range
        ref = self.reference_points.clamp(1e-3, 1 - 1e-3)[None].expand(
            b, -1, -1)
        query = tokens.new_zeros((b, self.num_query, self.embed_dims))
        all_cls, all_bbox = [], []
        for lid, layer in enumerate(self.decoder.layers):
            query_pos = self.query_embedding(
                pos2posemb3d(ref, self.embed_dims // 2))
            query = layer(query, key=tokens, value=tokens,
                          query_pos=query_pos)
            out = query if self.decoder.post_norm is None else \
                self.decoder.post_norm(query)
            cls = self.cls_branches[lid](out)
            reg = self.reg_branches[lid](out)
            ref_inv = inverse_sigmoid(ref)
            cx_n = torch.sigmoid(reg[..., 0:1] + ref_inv[..., 0:1])
            cy_n = torch.sigmoid(reg[..., 1:2] + ref_inv[..., 1:2])
            cz_n = torch.sigmoid(reg[..., 4:5] + ref_inv[..., 2:3])
            bbox = torch.cat([cx_n * (pc[3] - pc[0]) + pc[0],
                              cy_n * (pc[4] - pc[1]) + pc[1],
                              cz_n * (pc[5] - pc[2]) + pc[2],
                              reg[..., 2:4], reg[..., 5:6], reg[..., 6:]],
                             dim=-1)
            all_cls.append(cls)
            all_bbox.append(bbox)
            if self.with_box_refine:
                ref = torch.cat([cx_n, cy_n, cz_n], dim=-1).detach()
        return torch.stack(all_cls), torch.stack(all_bbox)
