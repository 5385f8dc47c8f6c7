"""Set-matching target assignment for DETR-style heads, torch port of
paddle3d_tpu/models/heads/target_assigners.py (FocalLossCost,
BBox3DL1Cost, _solve_host, hungarian_match, HungarianAssigner3D).

The costs are built on the tensors' device for a whole batch at once
([B, Q, G]); the Hungarian solve runs on the host with scipy's
linear_sum_assignment, one copy to the host a call for the whole batch
(the JAX package calls back once a sample). As there, the cost goes to
the host as f32, whatever the dtype of the step, and the solve is a
discrete choice outside autograd: gradients flow through the chosen pairs
only. ClassificationCost, BBoxL1Cost, IoUCost, MaxIoUAssigner and the
samplers arrive with the families that use them (ROADMAP.md, queue 1,
item 9).
"""
from typing import Tuple

import numpy as np
import torch

from ...apis import manager

__all__ = ["FocalLossCost", "BBox3DL1Cost", "HungarianAssigner3D",
           "hungarian_match"]


@manager.MATCH_COSTS.add_component
class FocalLossCost:
    def __init__(self, weight: float = 1., alpha: float = 0.25,
                 gamma: float = 2., eps: float = 1e-12):
        self.weight = weight
        self.alpha = alpha
        self.gamma = gamma
        self.eps = eps

    def __call__(self, cls_pred: torch.Tensor,
                 gt_labels: torch.Tensor) -> torch.Tensor:
        """cls_pred [..., Q, C] logits, gt_labels [..., G] -> [..., Q, G]:
        the focal positive cost minus the negative cost at each gt's class;
        padded gt columns (label < 0) cost 1e9."""
        prob = torch.sigmoid(cls_pred)
        neg_cost = (-torch.log(1 - prob + self.eps) * (1 - self.alpha) *
                    prob ** self.gamma)
        pos_cost = (-torch.log(prob + self.eps) * self.alpha *
                    (1 - prob) ** self.gamma)
        safe = gt_labels.clamp(min=0)
        idx = safe.unsqueeze(-2).expand(*prob.shape[:-1], safe.shape[-1])
        cost = torch.gather(pos_cost, -1, idx) - torch.gather(neg_cost, -1,
                                                              idx)
        cost = torch.where((gt_labels < 0).unsqueeze(-2),
                           torch.tensor(1e9, dtype=cost.dtype,
                                        device=cost.device), cost)
        return cost * self.weight


@manager.MATCH_COSTS.add_component
class BBox3DL1Cost:
    def __init__(self, weight: float = 1.):
        self.weight = weight

    def __call__(self, bbox_pred: torch.Tensor,
                 gt_bboxes: torch.Tensor) -> torch.Tensor:
        """[..., Q, D] x [..., G, D] -> [..., Q, G] L1 distance."""
        return torch.sum(torch.abs(bbox_pred.unsqueeze(-2) -
                                   gt_bboxes.unsqueeze(-3)), dim=-1) * \
            self.weight


def _solve_host(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """One sample's rectangular assignment on the host: cost [Q, G],
    valid [G] -> the gt index of each query [Q] (-1 none)."""
    from scipy.optimize import linear_sum_assignment
    out = np.full((cost.shape[0],), -1, np.int32)
    idx = np.where(valid)[0]
    if len(idx) == 0:
        return out
    rows, cols = linear_sum_assignment(cost[:, idx])
    out[rows] = idx[cols]
    return out


def hungarian_match(cost: torch.Tensor, gt_valid: torch.Tensor
                    ) -> torch.Tensor:
    """cost [B, Q, G] and validity [B, G] -> the gt index of each query
    [B, Q] int64 (-1 none) on cost's device: one copy of the batch's costs
    to the host as f32, a scipy solve a sample."""
    host = cost.detach().to(torch.float32).cpu().numpy()
    valid = gt_valid.cpu().numpy()
    out = np.stack([_solve_host(c, v) for c, v in zip(host, valid)])
    return torch.from_numpy(out).to(device=cost.device, dtype=torch.int64)


@manager.BBOX_ASSIGNERS.add_component
class HungarianAssigner3D:
    def __init__(self, cls_cost=None, reg_cost=None, pc_range=None):
        self.cls_cost = cls_cost or FocalLossCost(weight=2.0)
        self.reg_cost = reg_cost or BBox3DL1Cost(weight=0.25)
        self.pc_range = pc_range

    def assign(self, bbox_pred: torch.Tensor, cls_pred: torch.Tensor,
               gt_bboxes: torch.Tensor, gt_labels: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A batch: bbox_pred [B, Q, D] (encoded), cls_pred [B, Q, C]
        logits, gt_bboxes [B, G, D], gt_labels [B, G] (-1 pad) -> (the gt
        of each query [B, Q] (-1 = background), its foreground mask)."""
        with torch.no_grad():
            gt_valid = gt_labels >= 0
            cost = (self.cls_cost(cls_pred, gt_labels) +
                    self.reg_cost(bbox_pred[..., :8], gt_bboxes[..., :8]))
            cost = torch.where(gt_valid.unsqueeze(-2), cost,
                               torch.tensor(1e8, dtype=cost.dtype,
                                            device=cost.device))
            assigned = hungarian_match(cost, gt_valid)
        return assigned, assigned >= 0
