"""Rotated-IoU proposal-target assignment for two-stage RoI heads, torch
port of paddle3d_tpu/models/heads/proposal_target_layer.py.

Fixed-shape as in the JAX package: every RoI is matched to its best
(same-class) gt by rotated 3-D IoU (ops/iou3d_nms.boxes_iou3d, the K11
kernel on the card), then `roi_per_image` slots are filled with fg (IoU >=
min(reg_fg, cls_fg), at most round(fg_ratio * roi_per_image)), hard bg
(cls_bg_thresh_lo <= IoU < reg_fg) and easy bg (IoU < cls_bg_thresh_lo) in
hard_bg_ratio proportion, each pool drawn by a priority top-k over uniform
draws with wrap-around reuse when a pool is short. The batch is a leading
dimension (the JAX package vmaps one sample), and every output is detached.

The draws: three uniforms a RoI and sample, [B, 3, P] (fg, hard, easy), as
the JAX package draws them from its split key. The caller passes them (the
model draws them from its own torch.Generator), so that a test can feed in
the JAX package's own draws.
"""
from typing import NamedTuple

import math

import torch

from ...ops.iou3d_nms import boxes_iou3d
from ...ops.pointnet2 import first_argmax, gather_operation, topk_stable

__all__ = ["ProposalTargetConfig", "match_rois_to_gt", "sample_rois_for_rcnn",
           "proposal_targets"]


class ProposalTargetConfig(NamedTuple):
    roi_per_image: int = 128
    fg_ratio: float = 0.5
    reg_fg_thresh: float = 0.55
    cls_fg_thresh: float = 0.75
    cls_bg_thresh: float = 0.25
    cls_bg_thresh_lo: float = 0.1
    hard_bg_ratio: float = 0.8
    cls_score_type: str = "roi_iou"
    sample_roi_by_each_class: bool = True


def _centre_z(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 7+] bottom-z boxes -> [..., 7] with z at the box centre."""
    return torch.cat([boxes[..., :2],
                      (boxes[..., 2] + boxes[..., 5] / 2)[..., None],
                      boxes[..., 3:7]], dim=-1)


def match_rois_to_gt(rois, roi_mask, roi_labels, gt_boxes, gt_labels,
                     by_class: bool = True):
    """rois [B, P, 7] x gt_boxes [B, G, 7+] (both bottom-z) -> (max_iou
    [B, P], gt_assignment [B, P] int64): each RoI's best 3-D IoU with a
    valid gt (of its class when by_class), the first such gt on ties; 0 for
    masked RoIs."""
    iou = boxes_iou3d(_centre_z(rois), _centre_z(gt_boxes))       # [B, P, G]
    ok = (gt_labels >= 0)[..., None, :]
    if by_class:
        ok = ok & (roi_labels[..., :, None] == gt_labels[..., None, :])
    iou = torch.where(ok, iou, -1.0)
    gt_assignment = first_argmax(iou, dim=-1)
    max_iou = torch.clamp(iou.max(dim=-1).values, min=0.0)
    return torch.where(roi_mask, max_iou, 0.0), gt_assignment


def _priority_select(priority, take, capacity: int):
    """The top-`capacity` candidates by priority with wrap-around reuse:
    slot j holds the (j mod n_avail)-th best, valid while j < take.
    priority [B, P] (-inf for non-candidates), take [B] -> (idx [B,
    capacity], valid [B, capacity])."""
    n_avail = torch.isfinite(priority).sum(dim=-1)                 # [B]
    k = min(capacity, priority.shape[-1])
    order = topk_stable(priority, k)[1]
    if k < capacity:
        order = torch.nn.functional.pad(order, (0, capacity - k))
    j = torch.arange(capacity, device=priority.device)
    wrapped = torch.where(n_avail[:, None] > 0,
                          j % torch.clamp(n_avail, min=1)[:, None], 0)
    idx = torch.gather(order, 1, wrapped)
    valid = (j < take[:, None]) & (n_avail > 0)[:, None]
    return idx, valid


def sample_rois_for_rcnn(draws, rois, roi_mask, roi_labels, roi_scores,
                         gt_boxes, gt_labels, cfg: ProposalTargetConfig):
    """Batched fixed-shape subsampling. draws [B, 3, P] uniforms (fg, hard,
    easy priorities). -> dict of rois / roi_labels / roi_scores / roi_ious
    / gt_of_rois / gt_label_of_rois / valid, each [B, M, ...], M =
    cfg.roi_per_image, and pool_sizes [B, 3] (the fg, hard-bg and easy-bg
    RoIs the draws chose from)."""
    m = cfg.roi_per_image
    max_iou, gt_assignment = match_rois_to_gt(
        rois, roi_mask, roi_labels, gt_boxes, gt_labels,
        by_class=cfg.sample_roi_by_each_class)

    fg_thresh = min(cfg.reg_fg_thresh, cfg.cls_fg_thresh)
    fg_mask = roi_mask & (max_iou >= fg_thresh)
    easy_mask = roi_mask & (max_iou < cfg.cls_bg_thresh_lo)
    hard_mask = roi_mask & (max_iou < cfg.reg_fg_thresh) & \
        (max_iou >= cfg.cls_bg_thresh_lo)

    n_fg, n_hard, n_easy = (mask.sum(dim=-1)
                            for mask in (fg_mask, hard_mask, easy_mask))
    n_bg = n_hard + n_easy
    fg_cap = int(round(cfg.fg_ratio * m))
    zero = torch.zeros_like(n_fg)
    # fg count: capped when bg exists, fills all M when there is no bg
    fg_take = torch.where(n_bg > 0, torch.clamp(n_fg, max=fg_cap),
                          torch.where(n_fg > 0, m, zero))
    bg_take = m - fg_take
    # hard / easy split: proportional when both pools are non-empty, else
    # whichever exists takes all
    hard_take = torch.where(
        (n_hard > 0) & (n_easy > 0),
        torch.minimum((bg_take * cfg.hard_bg_ratio).to(torch.int64), n_hard),
        torch.where(n_hard > 0, bg_take, zero))
    hard_take = torch.where(n_bg > 0, hard_take, zero)
    easy_take = torch.where(n_easy > 0, bg_take - hard_take, zero)

    neg = -math.inf
    fg_idx, fg_ok = _priority_select(
        torch.where(fg_mask, draws[:, 0], neg), fg_take, m)
    hard_idx, hard_ok = _priority_select(
        torch.where(hard_mask, draws[:, 1], neg), hard_take, m)
    easy_idx, easy_ok = _priority_select(
        torch.where(easy_mask, draws[:, 2], neg), easy_take, m)

    # pack [fg | hard | easy] into the M slots
    j = torch.arange(m, device=rois.device)[None]
    fg_end = fg_take[:, None]
    hard_end = fg_end + hard_take[:, None]
    hard_slot = torch.clamp(j - fg_end, 0, m - 1)
    easy_slot = torch.clamp(j - hard_end, 0, m - 1)
    sel = torch.where(j < fg_end, fg_idx,
                      torch.where(j < hard_end,
                                  torch.gather(hard_idx, 1, hard_slot),
                                  torch.gather(easy_idx, 1, easy_slot)))
    valid = torch.where(
        j < fg_end, fg_ok,
        torch.where(j < hard_end, torch.gather(hard_ok, 1, hard_slot),
                    torch.gather(easy_ok, 1, easy_slot) &
                    (j < hard_end + easy_take[:, None])))
    sel = torch.where(valid, sel, 0)

    gt_sel = torch.gather(gt_assignment, 1, sel)
    vb = valid[..., None]
    return {
        "rois": torch.where(vb, gather_operation(rois, sel), 0.),
        "roi_labels": torch.where(valid, gather_operation(roi_labels, sel),
                                  -1),
        "roi_scores": torch.where(valid, gather_operation(roi_scores, sel),
                                  0.),
        "roi_ious": torch.where(valid, gather_operation(max_iou, sel), 0.),
        "gt_of_rois": torch.where(vb, gather_operation(gt_boxes, gt_sel), 0.),
        "gt_label_of_rois": torch.where(
            valid, gather_operation(gt_labels, gt_sel), -1),
        "valid": valid,
        "pool_sizes": torch.stack([n_fg, n_hard, n_easy], dim=-1),
    }


@torch.no_grad()
def proposal_targets(draws, rois, roi_mask, roi_labels, roi_scores, gt_boxes,
                     gt_labels, cfg: ProposalTargetConfig) -> dict:
    """Batched targets: sample_rois_for_rcnn plus reg_valid_mask (IoU >
    reg_fg_thresh on a valid slot) and rcnn_cls_labels ('cls': hard labels,
    -1 between the bg and fg thresholds; 'roi_iou': the soft interval
    (iou - bg) / (fg - bg); -1 on empty slots). Constants for the loss:
    computed without autograd."""
    out = sample_rois_for_rcnn(draws, rois, roi_mask, roi_labels, roi_scores,
                               gt_boxes, gt_labels, cfg)
    ious = out["roi_ious"]
    reg_valid = (ious > cfg.reg_fg_thresh) & out["valid"]
    if cfg.cls_score_type == "cls":
        cls_labels = (ious > cfg.cls_fg_thresh).to(torch.float32)
        ignore = (ious > cfg.cls_bg_thresh) & (ious < cfg.cls_fg_thresh)
        cls_labels = torch.where(ignore, -1.0, cls_labels)
    elif cfg.cls_score_type == "roi_iou":
        fg = ious > cfg.cls_fg_thresh
        bg = ious < cfg.cls_bg_thresh
        soft = (ious - cfg.cls_bg_thresh) / \
            (cfg.cls_fg_thresh - cfg.cls_bg_thresh)
        cls_labels = torch.where(fg, 1.0, torch.where(bg, 0.0, soft))
    else:
        raise NotImplementedError(cfg.cls_score_type)
    out["reg_valid_mask"] = reg_valid
    out["rcnn_cls_labels"] = torch.where(out["valid"], cls_labels, -1.0)
    return out
