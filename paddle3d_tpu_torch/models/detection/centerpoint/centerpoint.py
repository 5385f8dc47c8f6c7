"""CenterPoint, torch port of
paddle3d_tpu/models/detection/centerpoint/centerpoint.py (serving).

points [B, N, C] → fused pillar canvas (ops/pillar_ops.py: the two-layer
fused PFN kernel, then on a dense scan such as nuScenes 10-sweep the
channel-major sorted scatter, on a sparse one the row-major) →
SecondBackbone → SecondFPN → CenterHead → decode + rotated NMS, all on the
device and at fixed shapes. The canvas keeps the JAX package's NHWC layout
and goes to NCHW only around the conv stack.

Training (the on-device gaussian target generator, the CenterNet losses,
OneCycleAdam) and `postprocess_to_samples` (Sample / BBoxes3D records) are
not ported yet: ROADMAP.md, queue 1, items 6b and 5.
"""
import torch

from ....apis import manager
from ....ops.pillar_ops import fused_pillar_canvas
from ...base.base_model import BaseLidarModel
from ...middle_encoders.pillar_scatter import PointPillarsScatter
from ...voxel_encoders.pillar_encoder import PillarFeatureNet

__all__ = ["CenterPoint"]


@manager.MODELS.add_component
class CenterPoint(BaseLidarModel):
    def __init__(self,
                 voxelizer,
                 voxel_encoder,
                 middle_encoder,
                 backbone,
                 neck,
                 bbox_head,
                 test_cfg: dict = None,
                 target_assign_cfg: dict = None,
                 pretrained: str = None,
                 box_with_velocity: bool = False):
        super().__init__()
        self.voxelizer = voxelizer
        self.voxel_encoder = voxel_encoder
        self.middle_encoder = middle_encoder
        self.backbone = backbone
        self.neck = neck
        self.bbox_head = bbox_head
        self.test_cfg = dict(test_cfg or {})
        self.pretrained = pretrained
        if not self._can_fuse():
            raise NotImplementedError(
                "the port runs the fused pillar path only: a "
                "PillarFeatureNet over a PointPillarsScatter (the voxel "
                "configs arrive with ROADMAP.md, queue 1, item 7)")
        # kept for the target generator of the training slice
        self.target_assign_cfg = dict(target_assign_cfg or {})
        self.down_ratio = self._resolve_down_ratio(self.target_assign_cfg)

    def _derived_down_ratio(self):
        """Feature-map stride vs. the voxel grid, derived from the network:
        middle-encoder BEV stride × first backbone stage stride ÷ first neck
        upsample stride (all FPN branches land on the branch-0
        resolution)."""
        mid = getattr(self.middle_encoder, "bev_stride", None)
        if mid is None:
            return None
        backbone = self.backbone
        blocks = getattr(backbone, "blocks", None)
        ds = getattr(blocks, "downsample_strides",
                     getattr(backbone, "downsample_strides", None))
        fuse = getattr(backbone, "fuse", self.neck)
        us = getattr(fuse, "upsample_strides",
                     getattr(self.neck, "upsample_strides", None))
        if not ds or not us:
            return None
        ratio = mid * ds[0] / us[0]
        return int(ratio) if ratio == int(ratio) else None

    def _resolve_down_ratio(self, ta: dict) -> int:
        configured = ta.get("down_ratio", self.test_cfg.get("down_ratio"))
        derived = self._derived_down_ratio()
        if derived is not None and configured is not None \
                and int(configured) != derived:
            raise ValueError(
                "target_assign_cfg/test_cfg down_ratio={} does not match the "
                "network's actual BEV stride {} (middle encoder bev_stride="
                "{}); the heatmap target grid would not align with the "
                "head's feature map.".format(
                    configured, derived,
                    getattr(self.middle_encoder, "bev_stride", "?")))
        if configured is not None:
            return int(configured)
        return derived if derived is not None else 1

    def _can_fuse(self) -> bool:
        """Pillar configs (PillarFeatureNet → PointPillarsScatter) take the
        fused sorted pipeline."""
        return (isinstance(self.voxel_encoder, PillarFeatureNet)
                and isinstance(self.middle_encoder, PointPillarsScatter))

    def _extract_feats(self, points):
        """points [B, N, C] -> neck features [B, C, H, W]."""
        canvas = fused_pillar_canvas(self.voxelizer, self.voxel_encoder,
                                     self.middle_encoder, points)
        return self.neck(self.backbone(
            canvas.permute(0, 3, 1, 2).contiguous()))

    def train_forward(self, batch) -> dict:
        raise NotImplementedError(
            "CenterPoint training (target generator, CenterNet losses, "
            "OneCycleAdam, the two-layer PFN train path) arrives with "
            "ROADMAP.md, queue 1, item 6b")

    @torch.no_grad()
    def test_forward(self, batch) -> dict:
        """batch {"data": points [B, N, C] f32, NaN or out-of-range padded}
        -> box3d_lidar [B, K, 7|9] (bottom-z), scores [B, K], label_preds
        [B, K] (-1 padded), K = num_tasks · nms_post_max_size."""
        preds = self.bbox_head(self._extract_feats(batch["data"]))
        return self.bbox_head.predict(preds, self.test_cfg)
