"""PointPillars, torch port of
paddle3d_tpu/models/detection/pointpillars/pointpillars.py (inference).

points [B, N, C] → fused pillar canvas with an occupancy side channel
(ops/pillar_ops.py: the fused PFN and sorted-scatter kernels) →
SecondBackbone → SecondFPN → SSDHead → decode + rotated NMS, all on the
device and at fixed shapes. The canvas keeps the JAX package's NHWC
layout and goes to NCHW only around the conv stack.
"""
import torch

from ....apis import manager
from ....ops.pillar_ops import fused_pillar_canvas
from ...base.base_model import BaseLidarModel
from ...middle_encoders.pillar_scatter import PointPillarsScatter
from ...voxel_encoders.pillar_encoder import PillarFeatureNet
from .anchors import AnchorGenerator

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
        self.pretrained = pretrained

        self.anchor_generator = AnchorGenerator(
            output_stride_factor=(self.backbone.downsample_strides[0] //
                                  self.neck.upsample_strides[0]),
            point_cloud_range=self.voxelizer.point_cloud_range,
            voxel_size=self.voxelizer.voxel_size,
            anchor_configs=anchor_configs,
            anchor_area_threshold=anchor_area_threshold)
        # static, not a parameter; moves with the module
        self.register_buffer(
            "anchors", torch.from_numpy(self.anchor_generator.anchors),
            persistent=False)

    def _extract_feats(self, points):
        """-> (neck feats [B, C, H, W], live-anchor mask [B, A])."""
        canvas, occupancy = fused_pillar_canvas(
            self.voxelizer, self.pillar_encoder, self.middle_encoder, points,
            with_occupancy=True)
        # one NCHW copy of the canvas: a channels-last view costs cuDNN a
        # layout conversion around every f32 conv (the copy measured +8 %
        # scans/s on an H100 80GB HBM3 at a 700 W limit, see PERF.md)
        feats = self.neck(self.backbone(
            canvas.permute(0, 3, 1, 2).contiguous()))
        return feats, self.anchor_generator.anchors_mask_dense(occupancy)

    def train_forward(self, batch) -> dict:
        raise NotImplementedError(
            "PointPillars training arrives with the PointPillars-train item "
            "(ROADMAP.md, queue 1, item 4)")

    @torch.no_grad()
    def test_forward(self, batch) -> dict:
        """batch {"data": points [B, N, C] f32, NaN or out-of-range padded}
        -> box3d_lidar [B, K, 7], scores [B, K], label_preds [B, K]."""
        feats, anchors_mask = self._extract_feats(batch["data"])
        preds = self.head(feats)
        return self.head.post_process(preds, self.anchors, anchors_mask)
