"""RoI-grid refinement head of the two-stage detectors, torch port of
paddle3d_tpu/models/heads/roi_head.py (`_grid_points`, `pool`, the
forward, `refine_loss`).

Each proposal is covered by a G^3 grid of points; features are aggregated
around the grid points with ball queries over a support point set (PV-RCNN:
keypoints from VoxelSetAbstraction; Voxel-RCNN: sparse voxel centres) and
fed to the cls/reg refinement MLPs. Fixed capacities everywhere.
"""
from typing import Sequence

import torch
from torch import nn

from ...apis import manager
from ..common.pointnet2_modules import PointMLP, group_max, linear
from ..layers.layer_libs import default_generator
from ..losses.weighted_loss import smooth_l1_loss

__all__ = ["RoIGridHead", "optax_sigmoid_ce"]


@manager.HEADS.add_component
class RoIGridHead(nn.Module):
    def __init__(self,
                 in_channels,
                 grid_size: int = 6,
                 mlps: Sequence[int] = (64, 64),
                 radii: Sequence[float] = (0.8, 1.6),
                 nsamples: Sequence[int] = (16, 16),
                 head_fc: Sequence[int] = (256, 256),
                 generator: torch.Generator = None):
        """`in_channels` int = all radii pool one support set (PV-RCNN
        keypoints); list = one support set per radius level (Voxel-RCNN
        multi-level voxel query)."""
        super().__init__()
        g = default_generator(generator)
        self.grid_size = grid_size
        self.radii = list(radii)
        self.nsamples = list(nsamples)
        if isinstance(in_channels, (list, tuple)):
            ins = list(in_channels)
            assert len(ins) == len(self.radii)
        else:
            ins = [in_channels] * len(self.radii)
        self.scale_mlps = nn.ModuleList([
            PointMLP([ins[i] + 3] + list(mlps), generator=g)
            for i in range(len(self.radii))
        ])
        agg_ch = len(radii) * mlps[-1]
        g3 = grid_size ** 3
        self.fc = PointMLP([g3 * agg_ch] + list(head_fc), generator=g)
        self.cls_out = linear(head_fc[-1], 1, g)
        self.reg_out = linear(head_fc[-1], 7, g)

    def _grid_points(self, rois):
        """rois [..., P, 7] (bottom-z) -> [..., P, G^3, 3] global grid
        points."""
        g = self.grid_size
        lin = (torch.arange(g, dtype=torch.float32, device=rois.device)
               + 0.5) / g - 0.5
        zz, yy, xx = torch.meshgrid(lin, lin, lin, indexing="ij")
        unit = torch.stack([xx.reshape(-1), yy.reshape(-1), zz.reshape(-1)],
                           dim=-1)  # [G^3, 3] in [-.5, .5]
        local = unit * rois[..., None, 3:6]
        yaw = rois[..., 6]
        c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
        rx = c * local[..., 0] - s * local[..., 1]
        ry = s * local[..., 0] + c * local[..., 1]
        center = torch.cat([rois[..., :2],
                            (rois[..., 2] + rois[..., 5] / 2)[..., None]],
                           dim=-1)
        return torch.stack([rx, ry, local[..., 2]],
                           dim=-1) + center[..., None, :]

    def pool(self, rois, supports):
        """rois [B,P,7]; supports = ONE (xyz [B,S,3], feats [B,S,C],
        mask [B,S]) pooled at every radius, or a LIST of per-radius support
        sets (multi-level voxel query) -> [B, P, head_fc[-1]]."""
        if not isinstance(supports, (list, tuple)) or \
                (len(supports) == 3 and not
                 isinstance(supports[0], (list, tuple))):
            supports = [supports] * len(self.radii)
        b, p = rois.shape[:2]
        flat = self._grid_points(rois).reshape(b, -1, 3)    # [B, P*G3, 3]
        outs = [group_max(mlp, radius, nsample, sxyz, sfeat, smask, flat)
                for (sxyz, sfeat, smask), radius, nsample, mlp in zip(
                    supports, self.radii, self.nsamples, self.scale_mlps)]
        pooled = torch.cat(outs, dim=-1).reshape(b, p, -1)
        return self.fc(pooled)

    def forward(self, rois, supports):
        shared = self.pool(rois, supports)
        return self.cls_out(shared)[..., 0], self.reg_out(shared)

    @staticmethod
    def refine_loss(cls_pred, reg_pred, targets: dict):
        """The refinement loss on proposal_targets' outputs -> (cls, reg):
        binary CE against rcnn_cls_labels (soft or hard; entries < 0
        ignored), averaged over the cared slots; smooth L1 of the residual
        to the matched gt in the coding `_refine` decodes (centre offset
        over half the RoI's BEV diagonal, log size ratio, yaw difference),
        summed over the code and averaged over reg_valid_mask."""
        rois = targets["rois"]
        cls_labels = targets["rcnn_cls_labels"]
        reg_mask = targets["reg_valid_mask"]
        gt = targets["gt_of_rois"]

        cls_valid = cls_labels >= 0
        ce = optax_sigmoid_ce(cls_pred,
                              torch.clamp(cls_labels, min=0.).to(
                                  cls_pred.dtype))
        cls_loss = torch.where(cls_valid, ce, 0.).sum() / torch.clamp(
            cls_valid.sum(), min=1)

        diag = 0.5 * torch.sqrt(rois[..., 3] ** 2 + rois[..., 4] ** 2)

        def centre(boxes):
            return torch.cat([boxes[..., :2], (boxes[..., 2] +
                                               boxes[..., 5] / 2)[..., None]],
                             dim=-1)
        residual = torch.cat([
            (centre(gt) - centre(rois)) /
            torch.clamp(diag, min=1e-3)[..., None],
            torch.log(torch.clamp(gt[..., 3:6], min=1e-3) /
                      torch.clamp(rois[..., 3:6], min=1e-3)),
            gt[..., 6:7] - rois[..., 6:7],
        ], dim=-1)
        l1 = smooth_l1_loss(reg_pred, residual).sum(dim=-1)
        reg_loss = torch.where(reg_mask, l1, 0.).sum() / torch.clamp(
            reg_mask.sum(), min=1)
        return cls_loss, reg_loss


def optax_sigmoid_ce(logits, labels):
    """optax.sigmoid_binary_cross_entropy as the JAX package writes it:
    max(x, 0) - x * y + log1p(exp(-|x|))."""
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(
        torch.exp(-torch.abs(logits)))
