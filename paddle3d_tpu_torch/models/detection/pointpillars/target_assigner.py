"""On-device anchor target assignment, torch port of
paddle3d_tpu/models/detection/pointpillars/target_assigner.py.

Batched over B directly (the JAX package vmaps a single-sample function):
the similarity at KITTI is [B, 107136, G]. Where the JAX package gathers by
one-hot matmuls (a TPU workaround), the port gathers; both are exact.

Semantics: label -1 = ignore, 0 = background, c > 0 = class c; similarity
is the axis-aligned IoU of the nearest ("near") BEV boxes; each gt
force-matches its best anchors (ties included) even below threshold,
unless it overlaps nothing; an anchor takes the FIRST gt of its maximal
IoU, as jnp.argmax does.
"""
import math

import torch

from ....ops.box_ops import limit_period, second_box_encode

__all__ = ["assign_targets", "nearest_iou_similarity"]


def _rbbox_to_near_bbox(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 5] (cx, cy, dx, dy, yaw) -> [..., 4] axis-aligned
    (x1, y1, x2, y2)."""
    rots = torch.abs(limit_period(boxes[..., 4], 0.5, math.pi))
    cond = (rots > math.pi / 4)[..., None]
    dims = torch.where(cond, boxes[..., [3, 2]], boxes[..., [2, 3]])
    centers = boxes[..., :2]
    return torch.cat([centers - dims / 2, centers + dims / 2], dim=-1)


def nearest_iou_similarity(anchors: torch.Tensor,
                           gt_boxes: torch.Tensor) -> torch.Tensor:
    """[A, 7] anchors x [B, G, 7] gt -> [B, A, G] nearest-bbox IoU."""
    a = _rbbox_to_near_bbox(anchors[:, [0, 1, 3, 4, 6]])[None, :, None]
    g = _rbbox_to_near_bbox(gt_boxes[..., [0, 1, 3, 4, 6]])[:, None]
    lt = torch.maximum(a[..., :2], g[..., :2])
    rb = torch.minimum(a[..., 2:], g[..., 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_g = (g[..., 2] - g[..., 0]) * (g[..., 3] - g[..., 1])
    return inter / torch.clamp(area_a + area_g - inter, min=1e-8)


def assign_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_labels: torch.Tensor,
                   matched_thresholds: torch.Tensor,
                   unmatched_thresholds: torch.Tensor,
                   anchors_mask: torch.Tensor = None):
    """Batched assignment.

    Args:
        anchors: [A, 7].
        gt_boxes: [B, G, 7] padded.
        gt_labels: [B, G] int; classes 0..C-1, padding rows -1.
        matched/unmatched_thresholds: [A].
        anchors_mask: [B, A] bool or None.
    Returns:
        labels: [B, A] int32 (-1 ignore / 0 bg / 1..C fg class + 1).
        reg_targets: [B, A, 7] encoded residuals (0 for non-fg).
    """
    gt_valid = gt_labels >= 0                                  # [B, G]
    iou = nearest_iou_similarity(anchors, gt_boxes)            # [B, A, G]
    iou = torch.where(gt_valid[:, None, :], iou, -1.)
    if anchors_mask is not None:
        iou = torch.where(anchors_mask[..., None], iou, -1.)

    anchor_to_gt_max = iou.max(dim=2).values                   # [B, A]
    anchor_to_gt_argmax = torch.argmax(iou, dim=2)   # first max, as jnp's
    gt_to_anchor_max = iou.max(dim=1).values                   # [B, G]
    # a gt that overlaps nothing does not force-match
    gt_to_anchor_max = torch.where(gt_to_anchor_max <= 0, -1.,
                                   gt_to_anchor_max)
    force = (iou == gt_to_anchor_max[:, None, :]) & gt_valid[:, None, :]
    fg = (anchor_to_gt_max >= matched_thresholds) | force.any(dim=2)
    neg = anchor_to_gt_max < unmatched_thresholds

    cls_of_assigned = torch.gather(gt_labels + 1, 1,
                                   anchor_to_gt_argmax).to(torch.int32)
    labels = torch.where(neg, 0, -1).to(torch.int32)
    labels = torch.where(fg, cls_of_assigned, labels)
    if anchors_mask is not None:
        labels = torch.where(anchors_mask, labels, -1)
        fg = fg & anchors_mask

    assigned_boxes = torch.gather(
        gt_boxes, 1,
        anchor_to_gt_argmax[..., None].expand(-1, -1, gt_boxes.shape[-1]))
    reg_targets = second_box_encode(assigned_boxes,
                                    anchors.to(gt_boxes.dtype))
    reg_targets = torch.where(fg[..., None], reg_targets, 0.)
    return labels, reg_targets
