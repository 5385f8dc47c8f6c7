"""BEVFusion (pillars + camera), torch port of
paddle3d_tpu/models/detection/bevfusion/bevfusion.py (SE_Block, BEVFusion).

  * the lidar stream, fully encoded before the fusion: points -> hard
    voxelization into [V, P, C] buffers (ops/voxelize) -> the buffer
    PillarFeatureNet -> PointPillarsScatter (the row-major sorted segment
    sum onto the BEV canvas: K7 for a dense scan, K2 for a sparse one, by
    the density rule; its VJP the table gather K5) -> pts_backbone ->
    pts_neck;
  * the camera stream: the image backbone (and neck) -> the LSS view
    transformer (its frustum pool on K7 / K2, VJP K5), the image features
    detached under freeze_img;
  * the fusion: the camera BEV resized onto the lidar BEV's grid where the
    two differ (jax.image.resize's bilinear: antialiased when it shrinks,
    which torch's antialias=True gives in both directions), the channels
    concatenated (lidar first), a 3 x 3 ConvBNReLU and the optional SE
    channel gate, then the optional BEV backbone and neck;
  * CenterHead: the CenterPoint targets and losses with the yaw wrapped by
    limit_period(., 0.5, 2 pi), plus the camera's depth-distribution loss
    (KLD or MSE against a per-patch target) in training; decode + rotated
    NMS in test_forward.
Either stream may be left out (the lidar-only and camera-only configs).
The BEVs run NCHW through the convolutions; the canvas and the camera BEV
leave their ops NHWC, as in the JAX package.

Batch contract (fixed shapes):
    data:       [B, N, C] points (NaN or out-of-range rows are padding)
    img:        [B, Ncam, H, W, 3] NHWC images
    rots, trans, cam2imgs, post_rots, post_trans, bda: the LSS camera
                matrices (models/detection/bevdet/bevdet.py's contract)
    gt_boxes:   [B, G, 7|9] bottom-z boxes (+ vx, vy), gt_labels [B, G]
                (-1 padded), to train
    img_depth:  [B, Ncam, h, w, 1 + D] (optional, training): channel 0 a
                feature patch's least depth, then its depth-bin target

postprocess_to_samples is CenterPoint's, as in the JAX package. Not
ported, each raising where a config would reach it: the anchor-head branch
and the MVX img_rpn_head / img_roi_head hooks (no config of the repo fills
them; ROADMAP.md, queue 1, item 9).
"""
import math

import torch
import torch.nn.functional as F
from torch import nn

from ....apis import manager
from ....ops.box_ops import limit_period
from ...base.base_model import BaseMultiViewModel, raise_if_training
from ...layers.layer_libs import ConvBNReLU, default_generator
from ...transformers.transformer_layers import linear
from ..centerpoint.centerpoint import CenterPoint
from ..centerpoint.centerpoint_target import CenterPointTargetGenerator

__all__ = ["BEVFusion", "SE_Block", "resize_bilinear"]


def _item9(what):
    return NotImplementedError(
        "BEVFusion: {} is not ported; no config of the repo reaches it "
        "(ROADMAP.md, queue 1, item 9)".format(what))


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """jax.image.resize(x, ..., "bilinear") of an NCHW map to size (H, W):
    half-pixel centres, the triangle kernel widened by the scale where the
    map shrinks (antialiased) and plain bilinear interpolation where it
    grows, the weights renormalised at the borders."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=True)


class SE_Block(nn.Module):
    """Global-average channel gate: x * sigmoid(fc(mean over H, W))."""

    def __init__(self, channels, generator: torch.Generator = None):
        super().__init__()
        self.fc = linear(channels, channels, default_generator(generator))

    def forward(self, x):
        """x [B, C, H, W]."""
        g = torch.sigmoid(self.fc(x.mean(dim=(2, 3))))
        return x * g[:, :, None, None]


@manager.MODELS.add_component
class BEVFusion(BaseMultiViewModel):
    def __init__(self,
                 bbox_head=None,
                 test_cfg: dict = None,
                 point_cloud_range=None,
                 voxel_size=None,
                 lidar_voxelizer=None,
                 lidar_voxel_encoder=None,
                 lidar_middle_encoder=None,
                 pts_backbone=None,
                 pts_neck=None,
                 img_backbone=None,
                 img_neck=None,
                 img_view_transformer=None,
                 img_rpn_head=None,
                 img_roi_head=None,
                 fusion_channels: int = 256,
                 lidar_channels: int = 0,
                 camera_channels: int = 0,
                 se: bool = False,
                 freeze_img: bool = False,
                 camera_depth_range=None,
                 img_depth_loss_weight: float = 1.0,
                 img_depth_loss_method: str = "kld",
                 bev_backbone=None,
                 bev_neck=None,
                 target_assign_cfg: dict = None,
                 pretrained: str = None,
                 pts_voxel_layer: dict = None,
                 pts_voxel_encoder=None,
                 pts_middle_encoder=None,
                 pts_bbox_head=None,
                 camera_stream: bool = False,
                 lss: bool = False,
                 grid: float = 0.6,
                 num_views: int = 6,
                 final_dim=(900, 1600),
                 pc_range=(-50, -50, -5, 50, 50, 3),
                 downsample: int = 4,
                 imc: int = 256,
                 lic: int = 384,
                 generator: torch.Generator = None,
                 **folded):
        super().__init__()
        del folded, lss, num_views
        generator = default_generator(generator)
        # the reference BEVFFasterRCNN surface: pts_voxel_layer ->
        # HardVoxelizer, pts_* -> the lidar stream, camera_stream -> an
        # LSS view transformer on the pool
        if pts_voxel_layer is not None and lidar_voxelizer is None:
            from ...voxelizers import HardVoxelizer
            point_cloud_range = pts_voxel_layer.get("point_cloud_range",
                                                    point_cloud_range)
            voxel_size = pts_voxel_layer.get("voxel_size", voxel_size)
            lidar_voxelizer = HardVoxelizer(
                voxel_size, point_cloud_range,
                pts_voxel_layer.get("max_num_points_in_voxel", 32),
                pts_voxel_layer.get("max_num_voxels", (30000, 40000)))
        if pts_voxel_encoder is not None and lidar_voxel_encoder is None:
            lidar_voxel_encoder = pts_voxel_encoder
        if pts_middle_encoder is not None and lidar_middle_encoder is None:
            lidar_middle_encoder = pts_middle_encoder
        if pts_bbox_head is not None and bbox_head is None:
            bbox_head = pts_bbox_head
        if camera_stream and img_view_transformer is None:
            from ...transformers.bevdet_transformer import LSSViewTransformer
            d0, d1, dd = (camera_depth_range or (4.0, 45.0, 1.0))
            img_view_transformer = LSSViewTransformer(
                grid_config=dict(
                    x=[pc_range[0], pc_range[3], grid],
                    y=[pc_range[1], pc_range[4], grid],
                    z=[pc_range[2], pc_range[5], pc_range[5] - pc_range[2]],
                    depth=[d0, d1, dd]),
                input_size=tuple(final_dim), downsample=downsample,
                in_channels=imc, out_channels=imc, generator=generator)
            camera_channels = camera_channels or imc
        if lidar_voxelizer is not None and lidar_channels == 0:
            lidar_channels = lic
            fusion_channels = lic
        if img_rpn_head is not None or img_roi_head is not None:
            raise _item9("the MVX img_rpn_head / img_roi_head hooks")
        if not hasattr(bbox_head, "tasks_cfg"):
            raise _item9("the anchor-head branch ({})".format(
                type(bbox_head).__name__))
        self.lidar_voxelizer = lidar_voxelizer
        self.lidar_voxel_encoder = lidar_voxel_encoder
        self.lidar_middle_encoder = lidar_middle_encoder
        self.pts_backbone = pts_backbone
        self.pts_neck = pts_neck
        self.img_backbone = img_backbone
        self.img_neck = img_neck
        self.img_view_transformer = img_view_transformer
        self.bev_backbone = bev_backbone
        self.bev_neck = bev_neck
        self.bbox_head = bbox_head
        self.test_cfg = dict(test_cfg or {})
        self.pretrained = pretrained
        self.freeze_img = freeze_img
        self.camera_depth_range = (list(map(float, camera_depth_range))
                                   if camera_depth_range else None)
        self.img_depth_loss_weight = float(img_depth_loss_weight)
        self.img_depth_loss_method = img_depth_loss_method

        self.fuse_conv = ConvBNReLU(lidar_channels + camera_channels,
                                    fusion_channels, 3, generator=generator)
        self.seblock = SE_Block(fusion_channels, generator) if se else None

        ta = dict(target_assign_cfg or {})
        self.target_generator = CenterPointTargetGenerator(
            tasks=self.bbox_head.tasks_cfg,
            down_ratio=ta.get("down_ratio", 1),
            point_cloud_range=point_cloud_range,
            voxel_size=voxel_size,
            gaussian_overlap=ta.get("gaussian_overlap", 0.1),
            max_objs=ta.get("max_objs", 500),
            min_radius=ta.get("min_radius", 2),
            with_velocity=self.bbox_head.with_velocity)

    # -------------------------------------------------------------- streams
    def lidar_canvas(self, points, training: bool):
        """points [B, N, C] -> the pillar canvas [B, ny, nx, C] (NHWC): the
        voxelizer's train or eval cap, the buffer PFN, the scatter."""
        voxels, coords, num_points, vmask = self.lidar_voxelizer(
            points, training=training)
        feats = self.lidar_voxel_encoder(voxels, num_points, coords)
        feats = feats * vmask[..., None].to(feats.dtype)
        return self.lidar_middle_encoder(feats, coords, vmask)

    def lidar_bev(self, points, training: bool):
        """points [B, N, C] -> the lidar BEV [B, C, H, W], encoded by
        pts_backbone and pts_neck."""
        x = self.lidar_canvas(points, training).permute(0, 3, 1, 2)
        x = x.contiguous()
        if self.pts_backbone is not None:
            x = self.pts_backbone(x)
            if self.pts_neck is not None:
                x = self.pts_neck(x)
            if isinstance(x, (tuple, list)):
                x = x[0] if len(x) == 1 else torch.cat(x, dim=1)
        return x

    def image_features(self, imgs):
        """imgs [B, N, H, W, 3] -> [B, N, C, h, w], detached under
        freeze_img."""
        b, n, h, w, c = imgs.shape
        x = self.img_backbone(imgs.reshape(b * n, h, w, c).permute(
            0, 3, 1, 2).contiguous())
        if self.img_neck is not None:
            x = self.img_neck(x)
        f = x[0] if isinstance(x, (tuple, list)) else x
        if self.freeze_img:
            f = f.detach()
        return f.reshape((b, n) + tuple(f.shape[1:]))

    def camera_bev(self, batch):
        """-> (the camera BEV [B, gy, gx, C] NHWC, depth probabilities
        [B, N, D, h, w])."""
        return self.img_view_transformer(
            self.image_features(batch["img"]), batch["rots"], batch["trans"],
            batch["cam2imgs"], batch["post_rots"], batch["post_trans"],
            batch["bda"])

    def fused_feats(self, batch, training: bool):
        """-> (the head's input [B, C, H, W], depth or None)."""
        bevs = []
        depth = None
        if self.lidar_voxelizer is not None and "data" in batch:
            bevs.append(self.lidar_bev(batch["data"], training))
        if self.img_view_transformer is not None and "img" in batch:
            cam, depth = self.camera_bev(batch)
            cam = cam.permute(0, 3, 1, 2)
            if bevs and cam.shape[-2:] != bevs[0].shape[-2:]:
                cam = resize_bilinear(cam, bevs[0].shape[-2:])
            bevs.append(cam)
        fused = self.fuse_conv(torch.cat(bevs, dim=1).contiguous())
        if self.seblock is not None:
            fused = self.seblock(fused)
        if self.bev_backbone is not None:
            feats = self.bev_backbone(fused)
            fused = self.bev_neck(feats) if self.bev_neck is not None else \
                feats[-1]
        return fused, depth

    # ---------------------------------------------------------- depth loss
    def depth_dist_loss(self, depth_pred, img_depth):
        """depth_pred [B, N, D, h, w] probabilities; img_depth [B, N, h, w,
        1 + D] (channel 0 a patch's least depth, then the target). Patches
        whose least depth lies in camera_depth_range count; KLD (or MSE)
        over their D bins, times img_depth_loss_weight."""
        d = depth_pred.shape[2]
        pred = depth_pred.permute(0, 1, 3, 4, 2).reshape(-1, d)
        min_depth = img_depth[..., 0].reshape(-1)
        tgt = img_depth[..., 1:1 + d].reshape(-1, d)
        lo, hi = self.camera_depth_range[0], self.camera_depth_range[1]
        mf = ((min_depth >= lo) & (min_depth <= hi)).to(pred.dtype)[:, None]
        denom = torch.clamp(mf.sum() * d, min=1.0)
        if self.img_depth_loss_method == "mse":
            loss = (((pred - tgt) ** 2) * mf).sum() / denom
        else:
            p = torch.clamp(pred, 1e-6, 1.0)
            t = torch.clamp(tgt, 0.0, 1.0)
            kld = t * (torch.log(torch.clamp(t, 1e-6, 1.0)) - torch.log(p))
            loss = (kld * mf).sum() / denom
        return self.img_depth_loss_weight * loss

    # --------------------------------------------------------------- fwd
    def train_forward(self, batch) -> dict:
        """-> {"loss" (the total), the head's losses, and img_depth_loss
        with a camera stream, camera_depth_range and an img_depth}.
        Train-mode BN: batch statistics, running stats updated; the train
        voxel cap."""
        feats, depth = self.fused_feats(batch, True)
        preds = self.bbox_head(feats)
        gt_boxes = batch["gt_boxes"]
        gt_boxes = torch.cat([
            gt_boxes[..., :6],
            limit_period(gt_boxes[..., 6:7], 0.5, 2 * math.pi),
            gt_boxes[..., 7:]], dim=-1)
        losses = self.bbox_head.loss(
            preds, self.target_generator(gt_boxes, batch["gt_labels"]))
        if (depth is not None and self.camera_depth_range is not None and
                "img_depth" in batch):
            dl = self.depth_dist_loss(depth, batch["img_depth"])
            losses["img_depth_loss"] = dl
            losses["loss"] = losses["loss"] + dl
        return losses

    @torch.no_grad()
    def test_forward(self, batch) -> dict:
        """-> box3d_lidar [B, K, 7|9] (bottom z), scores [B, K],
        label_preds [B, K] (-1 padded). The model must be in eval mode."""
        raise_if_training(self)
        feats, _ = self.fused_feats(batch, False)
        return self.bbox_head.predict(self.bbox_head(feats), self.test_cfg)

    postprocess_to_samples = staticmethod(CenterPoint.postprocess_to_samples)
