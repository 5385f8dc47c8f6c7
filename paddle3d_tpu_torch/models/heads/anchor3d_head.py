"""Dense anchor-based RPN head of the two-stage detectors, torch port of
paddle3d_tpu/models/heads/anchor3d_head.py (__init__ on the
`anchor_configs` surface, the forward, `loss`, `proposals`).

Reuses the PointPillars anchor lattice and its target assignment (per-anchor
matched / unmatched thresholds of each class) and emits fixed-capacity
proposals for the RoI stage. The mmdet-style `anchor_generator` surface
(BEVFusion's) raises: ROADMAP.md, queue 1, item 9.
"""
from typing import List, Sequence

import torch
from torch import nn

from ...apis import manager
from ...ops.box_ops import second_box_decode
from ...ops.iou3d_nms import nms_bev
from ...ops.pointnet2 import first_argmax, gather_operation
from ..detection.pointpillars.anchors import AnchorGenerator
from ..detection.pointpillars.target_assigner import assign_targets
from ..layers.layer_libs import default_generator, uniform_
from ..losses.weighted_loss import sigmoid_focal_loss, smooth_l1_loss

__all__ = ["Anchor3DHead"]


@manager.HEADS.add_component
class Anchor3DHead(nn.Module):
    def __init__(self,
                 num_classes: int = None,
                 feature_channels: int = None,
                 anchor_configs: List[dict] = None,
                 point_cloud_range: Sequence[float] = None,
                 voxel_size: Sequence[float] = None,
                 output_stride_factor: int = 8,
                 num_proposals: int = 128,
                 nms_pre: int = 1024,
                 nms_thresh: float = 0.8,
                 anchor_generator: dict = None,
                 bbox_coder=None,
                 in_channels: int = None,
                 feat_channels: int = None,
                 test_cfg: dict = None,
                 generator: torch.Generator = None,
                 **folded):
        super().__init__()
        del folded, bbox_coder
        if anchor_generator is not None and anchor_configs is None:
            raise NotImplementedError(
                "the mmdet-style anchor_generator surface (BEVFusion's "
                "pts_bbox_head) arrives with ROADMAP.md, queue 1, item 9; "
                "give anchor_configs")
        if feature_channels is None:
            feature_channels = feat_channels or in_channels
        if test_cfg:
            num_proposals = min(int(test_cfg.get("max_num",
                                                 num_proposals)), 512)
            nms_pre = int(test_cfg.get("nms_pre", nms_pre))
            nms_thresh = float(test_cfg.get("nms_thr", nms_thresh))
        g = default_generator(generator)
        self.num_classes = num_classes
        self.num_proposals = num_proposals
        self.nms_pre = nms_pre
        self.nms_thresh = nms_thresh

        self.anchor_generator = AnchorGenerator(
            output_stride_factor=output_stride_factor,
            point_cloud_range=point_cloud_range,
            voxel_size=voxel_size,
            anchor_configs=anchor_configs)
        self.register_buffer(
            "_anchors", torch.from_numpy(self.anchor_generator.anchors),
            persistent=False)
        for name in ("matched", "unmatched"):
            self.register_buffer("_" + name, torch.from_numpy(getattr(
                self.anchor_generator, name + "_thresholds")),
                persistent=False)
        k = self.anchor_generator.num_anchors_per_loc

        def conv1x1(cout):
            conv = nn.utils.skip_init(nn.Conv2d, feature_channels, cout, 1)
            uniform_(conv.weight, feature_channels, g)
            uniform_(conv.bias, feature_channels, g)
            return conv

        self.cls_head = conv1x1(k * num_classes)
        self.box_head = conv1x1(k * 7)
        self.dir_head = conv1x1(k * 2)

    def forward(self, feats: torch.Tensor) -> dict:
        """feats [B, C, H, W] -> flat per-anchor predictions in the JAX
        package's (y, x, anchor) order: NCHW outputs go to NHWC before the
        reshape."""
        b = feats.shape[0]

        def flat(t, c):
            return t.permute(0, 2, 3, 1).reshape(b, -1, c)

        return {
            "cls_preds": flat(self.cls_head(feats), self.num_classes),
            "box_preds": flat(self.box_head(feats), 7),
            "dir_preds": flat(self.dir_head(feats), 2),
        }

    def loss(self, preds, gt_boxes, gt_labels) -> dict:
        """gt_boxes [B, G, 7] (bottom-z), gt_labels [B, G] (classes from 0,
        -1 padded) -> {"loss_rpn_cls", "loss_rpn_reg"}: the sigmoid focal
        loss over cared anchors and the smooth-L1 residual loss (x 2) over
        fg anchors, both normalised by each scan's fg count and averaged
        over the batch."""
        labels, reg_targets = assign_targets(
            self._anchors.to(gt_boxes.dtype), gt_boxes, gt_labels,
            self._matched, self._unmatched)
        fg = (labels > 0).to(torch.float32)
        num_fg = torch.clamp(fg.sum(dim=1, keepdim=True), min=1.)
        cared = labels >= 0
        onehot = torch.nn.functional.one_hot(
            torch.where(cared, labels, 0).long(),
            self.num_classes + 1)[..., 1:].to(torch.float32)
        cls_w = cared.to(torch.float32) / num_fg
        b = preds["cls_preds"].shape[0]
        cls_loss = torch.sum(sigmoid_focal_loss(preds["cls_preds"], onehot) *
                             cls_w[..., None]) / b
        reg_w = fg / num_fg
        reg_loss = torch.sum(smooth_l1_loss(preds["box_preds"], reg_targets) *
                             reg_w[..., None]) / b
        return {"loss_rpn_cls": cls_loss, "loss_rpn_reg": 2.0 * reg_loss}

    def proposals(self, preds):
        """-> (rois [B, P, 7], roi_scores [B, P], roi_labels [B, P] int32,
        -1 where a slot is empty): decode every anchor, keep the nms_pre
        best-scored, rotated NMS down to num_proposals."""
        boxes = second_box_decode(preds["box_preds"],
                                  self._anchors.to(preds["box_preds"].dtype))
        conf = torch.sigmoid(preds["cls_preds"])
        score = conf.max(dim=-1).values
        label = first_argmax(conf, dim=-1)
        bev = boxes[..., [0, 1, 3, 4, 6]]
        keep, _ = nms_bev(bev, score, self.nms_thresh,
                          pre_max_size=self.nms_pre,
                          post_max_size=self.num_proposals)
        kept = keep >= 0
        safe = torch.where(kept, keep, 0)
        return (torch.where(kept[..., None], gather_operation(boxes, safe),
                            0.),
                torch.where(kept, gather_operation(score, safe), 0.),
                torch.where(kept, gather_operation(label, safe),
                            -1).to(torch.int32))
