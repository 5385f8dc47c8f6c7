"""PointPillars, torch port of
paddle3d_tpu/models/detection/pointpillars/pointpillars.py.

points [B, N, C] → fused pillar canvas with an occupancy side channel
(ops/pillar_ops.py: the fused PFN and sorted-scatter kernels, with their
backward kernels in train) → SecondBackbone → SecondFPN → SSDHead, then
decode + rotated NMS (test) or on-device target assignment + loss (train),
all on the device and at fixed shapes. The canvas keeps the JAX package's
NHWC layout and goes to NCHW only around the conv stack.
"""
import math

import torch

from ....apis import manager
from ....ops.box_ops import limit_period
from ....ops.pillar_ops import fused_pillar_canvas
from ...base.base_model import BaseLidarModel, raise_if_training
from ...middle_encoders.pillar_scatter import PointPillarsScatter
from ...voxel_encoders.pillar_encoder import PillarFeatureNet
from .anchors import AnchorGenerator
from .target_assigner import assign_targets

__all__ = ["PointPillars"]


@manager.MODELS.add_component
class PointPillars(BaseLidarModel):
    def __init__(self,
                 voxelizer,
                 pillar_encoder,
                 middle_encoder,
                 backbone,
                 neck,
                 head,
                 loss,
                 anchor_configs,
                 anchor_area_threshold: float = 1,
                 pretrained: str = None,
                 box_with_velocity: bool = False):
        super().__init__()
        if not (isinstance(pillar_encoder, PillarFeatureNet)
                and isinstance(middle_encoder, PointPillarsScatter)):
            raise NotImplementedError(
                "the port runs the fused pillar path only: a "
                "PillarFeatureNet over a PointPillarsScatter")
        self.voxelizer = voxelizer
        self.pillar_encoder = pillar_encoder
        self.middle_encoder = middle_encoder
        self.backbone = backbone
        self.neck = neck
        self.head = head
        self.loss = loss
        self.pretrained = pretrained

        self.anchor_generator = AnchorGenerator(
            output_stride_factor=(self.backbone.downsample_strides[0] //
                                  self.neck.upsample_strides[0]),
            point_cloud_range=self.voxelizer.point_cloud_range,
            voxel_size=self.voxelizer.voxel_size,
            anchor_configs=anchor_configs,
            anchor_area_threshold=anchor_area_threshold)
        # static, not parameters; they move with the module
        gen = self.anchor_generator
        for name, arr in (("anchors", gen.anchors),
                          ("matched_thr", gen.matched_thresholds),
                          ("unmatched_thr", gen.unmatched_thresholds)):
            self.register_buffer(name, torch.from_numpy(arr),
                                 persistent=False)

    def _extract_feats(self, points, training: bool):
        """-> (neck feats [B, C, H, W], live-anchor mask [B, A])."""
        canvas, occupancy = fused_pillar_canvas(
            self.voxelizer, self.pillar_encoder, self.middle_encoder, points,
            training, with_occupancy=True)
        # one NCHW copy of the canvas: a channels-last view costs cuDNN a
        # layout conversion around every f32 conv (the copy measured +8 %
        # scans/s on an H100 80GB HBM3 at a 700 W limit, see PERF.md)
        feats = self.neck(self.backbone(
            canvas.permute(0, 3, 1, 2).contiguous()))
        return feats, self.anchor_generator.anchors_mask_dense(occupancy)

    def train_forward(self, batch) -> dict:
        """batch {"data": points [B, N, C], "gt_boxes" [B, G, 7],
        "gt_labels" [B, G] (-1 padded)} -> loss dict ("loss" the total).
        Train-mode BN: the PFN and conv BNs use batch statistics and update
        their running stats."""
        feats, anchors_mask = self._extract_feats(batch["data"], True)
        preds = self.head(feats)
        gt_boxes = batch["gt_boxes"]
        # wrap yaw to [-pi, pi) as the reference does before assignment
        gt_boxes = torch.cat([gt_boxes[..., :-1], limit_period(
            gt_boxes[..., -1:], 0.5, 2 * math.pi)], dim=-1)
        labels, reg_targets = assign_targets(
            self.anchors, gt_boxes, batch["gt_labels"], self.matched_thr,
            self.unmatched_thr, anchors_mask)
        if self.head.use_direction_classifier:
            return self.loss(preds["box_preds"], preds["cls_preds"],
                             reg_targets, labels, preds["dir_preds"],
                             self.anchors)
        return self.loss(preds["box_preds"], preds["cls_preds"], reg_targets,
                         labels)

    @torch.no_grad()
    def test_forward(self, batch) -> dict:
        """batch {"data": points [B, N, C] f32, NaN or out-of-range padded}
        -> box3d_lidar [B, K, 7], scores [B, K], label_preds [B, K].
        The model must be in eval mode (`.eval()`)."""
        raise_if_training(self)
        feats, anchors_mask = self._extract_feats(batch["data"], False)
        preds = self.head(feats)
        return self.head.post_process(preds, self.anchors, anchors_mask)
