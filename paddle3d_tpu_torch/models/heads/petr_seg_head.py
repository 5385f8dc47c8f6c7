"""PETRv2 BEV segmentation head, torch port of
paddle3d_tpu/models/heads/petr_seg_head.py (PETRSegHead).

Seg queries anchored at fixed BEV patch centres (z = 0.5) cross-attend to
the 3-D position-embedded camera tokens through PETRHead's decoder; the
last layer's queries each decode one patch_size² patch of the BEV map.
It is a PETRHead, so it carries that head's reference points, class and
box branches and assigner, which its forward leaves unused, as the JAX
package's does (their state travels with it).
"""
import torch
from torch import nn

from ...apis import manager
from ..layers.layer_libs import Sequential, default_generator
from ..transformers.transformer_layers import linear
from .petr_head import PETRHead, pos2posemb3d

__all__ = ["PETRSegHead"]


@manager.HEADS.add_component
class PETRSegHead(PETRHead):
    """bev_size cells in (bev / patch)² queries, one a patch. The gt batch
    key: gt_semantic_map [B, bev_h, bev_w, num_classes] in {0, 1}."""

    def __init__(self, num_classes: int = 3, bev_size=(256, 256),
                 patch_size: int = 16, seg_weight: float = 1.0,
                 generator: torch.Generator = None, **kwargs):
        bev_h, bev_w = bev_size
        if bev_h % patch_size or bev_w % patch_size:
            raise ValueError("bev_size {} is not a multiple of patch_size "
                             "{}".format(bev_size, patch_size))
        ph, pw = bev_h // patch_size, bev_w // patch_size
        super().__init__(num_classes=num_classes, num_query=ph * pw,
                         generator=generator, **kwargs)
        self.bev_h, self.bev_w = int(bev_h), int(bev_w)
        self.patch_size = int(patch_size)
        self.seg_weight = float(seg_weight)
        gen = default_generator(generator)
        self.seg_branch = Sequential(
            linear(self.embed_dims, self.embed_dims, gen), nn.ReLU(),
            linear(self.embed_dims, patch_size * patch_size * num_classes,
                   gen))

    def _patch_centers(self, dtype, device) -> torch.Tensor:
        """The patch centres in [0, 1]³ (z = 0.5) -> [Q, 3]."""
        ph = self.bev_h // self.patch_size
        pw = self.bev_w // self.patch_size
        f32 = dict(dtype=torch.float32, device=device)
        ys = (torch.arange(ph, **f32) + 0.5) / ph
        xs = (torch.arange(pw, **f32) + 0.5) / pw
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        return torch.stack([gx.reshape(-1), gy.reshape(-1),
                            torch.full((ph * pw,), 0.5, **f32)],
                           dim=-1).to(dtype)

    def forward(self, feats, img2lidars):
        """feats [B, N, Cin, h, w] -> seg logits [B, bev_h, bev_w, ncls]."""
        b = feats.shape[0]
        tokens, key_pos = self.tokens(feats, img2lidars)
        ref = self._patch_centers(tokens.dtype, tokens.device)
        q_pos = self.query_embedding(pos2posemb3d(ref, self.embed_dims // 2))
        q_pos = q_pos[None].expand(b, -1, -1)
        query = torch.zeros((b, self.num_query, self.embed_dims),
                            dtype=tokens.dtype, device=tokens.device)
        inter = self.decoder(query, key=tokens, value=tokens,
                             query_pos=q_pos, key_pos=key_pos)
        logits = self.seg_branch(inter[-1])       # [B, Q, p * p * ncls]
        p = self.patch_size
        logits = logits.reshape(b, self.bev_h // p, self.bev_w // p, p, p,
                                self.num_classes)
        return logits.permute(0, 1, 3, 2, 4, 5).reshape(
            b, self.bev_h, self.bev_w, self.num_classes)

    def loss(self, seg_logits, gt_semantic_map) -> dict:
        """Class-balanced BCE (positives and negatives averaged apart) +
        dice."""
        gt = gt_semantic_map.to(seg_logits.dtype)
        bce = (seg_logits.clamp(min=0) - seg_logits * gt +
               torch.log1p(torch.exp(-torch.abs(seg_logits))))
        pos = gt > 0.5
        n_pos = pos.sum().clamp(min=1)
        n_neg = (~pos).sum().clamp(min=1)
        bce_loss = (torch.where(pos, bce, 0.).sum() / n_pos +
                    torch.where(~pos, bce, 0.).sum() / n_neg)
        prob = torch.sigmoid(seg_logits)
        inter = torch.sum(prob * gt, dim=(1, 2))
        denom = torch.sum(prob, dim=(1, 2)) + torch.sum(gt, dim=(1, 2))
        dice = 1.0 - torch.mean((2 * inter + 1.0) / (denom + 1.0))
        return {"loss_seg_bce": self.seg_weight * bce_loss,
                "loss_seg_dice": self.seg_weight * dice,
                "loss_seg": self.seg_weight * (bce_loss + dice)}

    def predict(self, seg_logits) -> dict:
        return {"seg_probs": torch.sigmoid(seg_logits)}
