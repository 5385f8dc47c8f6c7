"""CenterPoint, torch port of
paddle3d_tpu/models/detection/centerpoint/centerpoint.py.

points [B, N, C] → BEV canvas → SecondBackbone → SecondFPN → CenterHead →
decode + rotated NMS (test) or the on-device gaussian targets and the
CenterNet losses (train), all on the device and at fixed shapes. Two canvas
paths, as in the JAX package:
  * pillar configs (PillarFeatureNet over PointPillarsScatter): the fused
    pillar canvas (ops/pillar_ops.py: in eval the fused PFN kernel, then on
    a dense scan such as nuScenes 10-sweep the channel-major sorted scatter,
    on a sparse one the row-major; in train the two-layer PFN row by row
    with the segmented window max kernel, then the row-major scatter);
  * voxel configs (VoxelMean over SparseResNet3D or SparseNet3D): the fused
    voxelize + mean (ops/voxelize.voxel_mean_batch), then the sparse middle
    encoder (in eval the sparse conv kernel per conv, in train the gather
    route under autograd with batch-statistics BN), then the dense BEV
    through the sorted segment sum (K7 or K2 by the density rule, with the
    table gather K5 as its VJP).
The canvas keeps the JAX package's NHWC layout and goes to NCHW only
around the conv stack.
"""
import math

import torch

from ....apis import manager
from ....ops.box_ops import limit_period
from ....ops.pillar_ops import fused_pillar_canvas
from ....ops.voxelize import voxel_mean_batch
from ...base.base_model import BaseLidarModel, raise_if_training
from ...middle_encoders.pillar_scatter import PointPillarsScatter
from ...middle_encoders.sparse_resnet import SparseNet3D, SparseResNet3D
from ...voxel_encoders.pillar_encoder import PillarFeatureNet
from ...voxel_encoders.voxel_encoder import VoxelMean
from .centerpoint_target import CenterPointTargetGenerator

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
        if not (self._can_fuse() or self._is_voxel_mean()):
            raise NotImplementedError(
                "the port runs a PillarFeatureNet over a "
                "PointPillarsScatter, or a VoxelMean over a SparseResNet3D "
                "or SparseNet3D; got {} over {} (HardVFE arrives with "
                "ROADMAP.md, queue 1, item 8b)".format(
                    type(voxel_encoder).__name__,
                    type(middle_encoder).__name__))
        ta = dict(target_assign_cfg or {})
        self.down_ratio = self._resolve_down_ratio(ta)
        self.target_generator = CenterPointTargetGenerator(
            tasks=self.bbox_head.tasks_cfg,
            down_ratio=self.down_ratio,
            point_cloud_range=self.voxelizer.point_cloud_range,
            voxel_size=self.voxelizer.voxel_size,
            gaussian_overlap=ta.get("gaussian_overlap", 0.1),
            max_objs=ta.get("max_objs", 500),
            min_radius=ta.get("min_radius", 2),
            with_velocity=self.bbox_head.with_velocity)

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

    def _is_voxel_mean(self) -> bool:
        """Voxel configs: VoxelMean → a sparse middle encoder."""
        return (isinstance(self.voxel_encoder, VoxelMean)
                and isinstance(self.middle_encoder,
                               (SparseResNet3D, SparseNet3D)))

    def _canvas(self, points, training: bool):
        """points [B, N, C] -> BEV canvas [B, H, W, C'] (NHWC); `training`
        picks the voxel cap and the canvas branch, as in the JAX package.
        The sparse middle encoder's layers take their route and BN mode
        from their module mode, so a voxel canvas refuses a flag that
        disagrees with it."""
        if self._can_fuse():
            return fused_pillar_canvas(self.voxelizer, self.voxel_encoder,
                                       self.middle_encoder, points, training)
        feats, coords, _, vmask = voxel_mean_batch(
            points, self.voxelizer.voxel_size,
            self.voxelizer.point_cloud_range,
            self.voxelizer.max_num_points_in_voxel,
            self.voxelizer.max_num_voxels_for(training),
            self.voxel_encoder.in_channels)
        if training != self.middle_encoder.training:
            mode = "train" if training else "eval"
            raise RuntimeError(
                "this entry point runs the voxel canvas in {0} mode: call "
                ".{0}() on the model first".format(mode))
        return self.middle_encoder(feats, coords, vmask)

    def _extract_feats(self, points, training: bool):
        """points [B, N, C] -> neck features [B, C, H, W]."""
        canvas = self._canvas(points, training)
        return self.neck(self.backbone(
            canvas.permute(0, 3, 1, 2).contiguous()))

    def train_forward(self, batch) -> dict:
        """batch {"data": points [B, N, C], "gt_boxes" [B, G, 7|9] (bottom
        z; velocity in columns 7:9), "gt_labels" [B, G] (-1 padded)} ->
        {"loss" (the total), "hm_loss_i", "loc_loss_i" per task}.
        Train-mode BN: batch statistics, running stats updated; a voxel
        config needs the model in train mode (`.train()`)."""
        preds = self.bbox_head(self._extract_feats(batch["data"], True))
        gt_boxes = batch["gt_boxes"]
        gt_boxes = torch.cat([
            gt_boxes[..., :6],
            limit_period(gt_boxes[..., 6:7], 0.5, 2 * math.pi),
            gt_boxes[..., 7:]], dim=-1)
        targets = self.target_generator(gt_boxes, batch["gt_labels"])
        return self.bbox_head.loss(preds, targets)

    @torch.no_grad()
    def test_forward(self, batch) -> dict:
        """batch {"data": points [B, N, C] f32, NaN or out-of-range padded}
        -> box3d_lidar [B, K, 7|9] (bottom-z), scores [B, K], label_preds
        [B, K] (-1 padded), K = num_tasks · nms_post_max_size. The model must
        be in eval mode (`.eval()`)."""
        raise_if_training(self)
        preds = self.bbox_head(self._extract_feats(batch["data"], False))
        return self.bbox_head.predict(preds, self.test_cfg)
