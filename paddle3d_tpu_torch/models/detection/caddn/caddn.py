"""CADDN monocular 3-D detector, torch port of
paddle3d_tpu/models/detection/caddn/caddn.py (CADDN).

Image -> camera backbone (ResNet or HRNet, optionally an OCRNet /
DeepLabV3 class head's pre-logit features) -> FFE (a depth-bin head and a
channel reduce) -> the frustum-to-BEV pool -> BEV net -> CenterHead (or
an Anchor3DHead) -> decode + rotated NMS (test) or the CenterPoint targets
and losses plus the optional depth-bin loss (train), at fixed shapes.

The frustum pool is the JAX package's factored scatter-add: each
(depth bin, pixel) cell of the frustum carries depth_prob x its pixel's
reduced feature into the BEV cell its 3-D point falls in
(ops/scatter.bev_pool_sorted: the scalar payloads sorted, the rows rebuilt
by a gather, reduced on the card by K7 for a dense scan or K2 for a sparse
one, with K5 as its VJP). Images arrive as the JAX package takes them,
NHWC [B, H, W, 3] in [0, 255]; the convs run NCHW, the pooled table is
NHWC [B, gy, gx, C] as there and goes to NCHW once for the BEV net.

The frustum's voxel indices and the depth bins are floors of computed
values: the port computes them in the arithmetic XLA compiles the JAX
package's to under jit on the CPU, in the dtype of the input (its linspace
and the reciprocal of a constant divisor from ops/xla_arith; each
coordinate as the pairwise sum (p0 + p1) + (p2 + p3) of its four
products, as XLA's dot sums them; a correctly rounded square root), so
that a point on a voxel face or a depth on a bin edge lands on the same
side.

`postprocess_to_samples` is the LiDAR detectors' (BaseLidarModel's): the
JAX model takes CenterPoint's (caddn.py:293), and the predictions are
lidar-frame boxes that KittiDepthMetric converts through the calib.
"""
import math
from typing import Sequence

import torch
from torch import nn

from ....apis import manager
from ....ops import xla_arith
from ....ops.box_ops import limit_period
from ....ops.scatter import bev_pool_sorted
from ...backbones.second_backbone import SecondBackbone
from ...base.base_model import (BaseLidarModel, BaseMonoModel,
                                raise_if_training)
from ...layers.layer_libs import (ConvBNReLU, default_generator,
                                  uniform_bias_init, uniform_init)
from ...necks.second_fpn import SecondFPN
from ..centerpoint.centerpoint_target import CenterPointTargetGenerator

__all__ = ["CADDN"]


class _BEVNet(nn.Module):
    """The BEV net a reference `bev_cfg` block describes: SecondBackbone
    then SecondFPN, as `net` and `fpn` (the JAX package's names)."""

    def __init__(self, cfg: dict, generator: torch.Generator):
        super().__init__()
        filters = list(cfg.get("num_filters", (64, 128, 256)))
        self.net = SecondBackbone(
            in_channels=cfg.get("input_channels", 64), out_channels=filters,
            layer_nums=list(cfg.get("layer_nums", (10,) * 3)),
            downsample_strides=list(cfg.get("layer_strides", (2, 2, 2))),
            generator=generator)
        self.fpn = SecondFPN(
            in_channels=filters,
            out_channels=list(cfg.get("num_upsample_filters", (128,) * 3)),
            upsample_strides=list(cfg.get("upsample_strides", (1, 2, 4))),
            generator=generator)

    def forward(self, x):
        return self.fpn(self.net(x))


@manager.MODELS.add_component
class CADDN(BaseMonoModel):
    def __init__(self,
                 backbone=None,
                 bev_backbone=None,
                 bbox_head=None,
                 test_cfg: dict = None,
                 point_cloud_range: Sequence[float] = None,
                 voxel_size: Sequence[float] = None,
                 backbone_3d=None,
                 dense_head=None,
                 bev_cfg: dict = None,
                 ffe_cfg: dict = None,
                 f2v_cfg: dict = None,
                 disc_cfg: dict = None,
                 post_process_cfg: dict = None,
                 map_to_bev_cfg: dict = None,
                 depth_bins: int = 80,
                 depth_range: Sequence[float] = (2.0, 46.8),
                 depth_mode: str = "LID",
                 feat_channels: int = 64,
                 backbone_channels: int = 256,
                 downsample: int = 8,
                 image_size: Sequence[int] = (375, 1242),
                 depth_loss_weight: float = 3.0,
                 class_head=None,
                 target_assign_cfg: dict = None,
                 pretrained: str = None,
                 generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        # the reference YAML's surface (configs/caddn/*.yml), translated as
        # the JAX package does: backbone_3d, dense_head, f2v_cfg, disc_cfg,
        # ffe_cfg, bev_cfg and post_process_cfg map onto the flat
        # parameters; map_to_bev_cfg is folded by design (the pool sums
        # over z); a head without `tasks_cfg` (the AnchorHeadSingle shim's
        # Anchor3DHead) selects the anchor mode
        if backbone_3d is not None:
            backbone = backbone_3d
        if dense_head is not None:
            bbox_head = dense_head
        if f2v_cfg:
            point_cloud_range = f2v_cfg.get("pc_range", point_cloud_range)
            voxel_size = f2v_cfg.get("voxel_size", voxel_size)
        if disc_cfg:
            depth_mode = disc_cfg.get("mode", depth_mode)
            depth_bins = disc_cfg.get("num_bins", depth_bins)
            depth_range = (disc_cfg.get("depth_min", depth_range[0]),
                           disc_cfg.get("depth_max", depth_range[1]))
        if ffe_cfg:
            cr = ffe_cfg.get("channel_reduce_cfg", {}) or {}
            backbone_channels = cr.get("in_channels", backbone_channels)
            feat_channels = cr.get("out_channels", feat_channels)
            downsample = ffe_cfg.get("downsample_factor", downsample)
            depth_loss_weight = (ffe_cfg.get("ddn_loss", {}) or {}).get(
                "weight", depth_loss_weight)
        if bev_cfg and bev_backbone is None:
            bev_backbone = _BEVNet(bev_cfg, generator)
        if post_process_cfg and test_cfg is None:
            nmsc = post_process_cfg.get("nms_config", {}) or {}
            test_cfg = dict(
                score_threshold=post_process_cfg.get("score_thresh", 0.1),
                nms=dict(
                    nms_pre_max_size=nmsc.get("nms_pre_maxsize", 1024),
                    nms_post_max_size=min(
                        nmsc.get("nms_post_maxsize", 500), 500),
                    nms_iou_threshold=nmsc.get("nms_thresh", 0.01)))
        self.backbone = backbone
        self.class_head = class_head
        self.bev_backbone = bev_backbone
        self.bbox_head = bbox_head
        self.test_cfg = dict(test_cfg or {})
        self.pretrained = pretrained
        self.pc_range = list(map(float, point_cloud_range))
        self.voxel_size = list(map(float, voxel_size))
        self.grid_size = [
            int(round((self.pc_range[i + 3] - self.pc_range[i]) /
                      self.voxel_size[i])) for i in range(3)]
        self.depth_bins = depth_bins
        self.depth_range = tuple(map(float, depth_range))
        self.depth_mode = depth_mode
        self.downsample = downsample
        self.image_size = tuple(image_size)
        self.depth_loss_weight = depth_loss_weight
        self.feat_channels = feat_channels

        # FFE: depth logits (D + 1: the last bin is beyond range) and the
        # channel reduce
        self.depth_head = nn.utils.skip_init(nn.Conv2d, backbone_channels,
                                             depth_bins + 1, 1)
        uniform_init(self.depth_head.weight, generator)
        uniform_bias_init(self.depth_head.bias, backbone_channels, generator)
        self.chan_reduce = ConvBNReLU(backbone_channels, feat_channels, 3,
                                      generator=generator)

        self.anchor_mode = not hasattr(self.bbox_head, "tasks_cfg")
        if self.anchor_mode:
            self.target_generator = None
        else:
            ta = dict(target_assign_cfg or {})
            self.target_generator = CenterPointTargetGenerator(
                tasks=self.bbox_head.tasks_cfg,
                down_ratio=ta.get("down_ratio", 1),
                point_cloud_range=self.pc_range,
                voxel_size=self.voxel_size,
                gaussian_overlap=ta.get("gaussian_overlap", 0.1),
                max_objs=ta.get("max_objs", 100),
                min_radius=ta.get("min_radius", 2),
                with_velocity=self.bbox_head.with_velocity)

    # ------------------------------------------------------------- frustum
    def _bin_depths(self) -> torch.Tensor:
        """The depth-bin centres [D] f32 (the reference F2V's LID or
        uniform discretisation), in the f32 arithmetic XLA compiles the
        JAX package's to under jit."""
        d0, d1 = self.depth_range
        d = self.depth_bins
        i = torch.arange(d, dtype=torch.float32)
        if self.depth_mode == "LID":
            bin_size = 2 * (d1 - d0) / (d * (1 + d))
            return d0 + bin_size / 2 * (i * (i + 1) + i + 1)
        # XLA folds (d1 - d0) / d into one f32 constant
        return d0 + (i + 0.5) * (torch.tensor(d1 - d0) *
                                 xla_arith.reciprocal(d, i))

    def frustum_ranks(self, img2lidars: torch.Tensor, h: int, w: int):
        """img2lidars [B, 4, 4] (image pixel x depth -> lidar) and the
        feature map's size -> (rank [B, D, h, w] int32, y * gx + x of the
        BEV cell, and valid [B, D, h, w] bool, inside the voxel grid), the
        frustum cell (d, i, j) at pixel (u_j, v_i) of the image_size grid
        and depth bin d. Computed in img2lidars' dtype."""
        dtype, dev = img2lidars.dtype, img2lidars.device
        h_in, w_in = self.image_size
        z = self._bin_depths().to(dtype=dtype, device=dev)[:, None, None]
        uu = xla_arith.jax_linspace(w_in - 1, w, dtype).to(dev)[None, None, :]
        vv = xla_arith.jax_linspace(h_in - 1, h, dtype).to(dev)[None, :, None]
        pts = [uu * z, vv * z, z.expand(-1, h, w)]
        m = img2lidars[:, :3, :, None, None, None]            # [B,3,4,1,1,1]
        lo = torch.tensor(self.pc_range[:3], dtype=dtype, device=dev)
        vox = []
        for a in range(3):
            # xyz_a = m_a0 (u z) + m_a1 (v z) + m_a2 z + m_a3 · 1, summed in
            # pairs as XLA's CPU dot sums the einsum's four products
            xyz = (m[:, a, 0] * pts[0] + m[:, a, 1] * pts[1]) + (
                m[:, a, 2] * pts[2] + m[:, a, 3])
            cell = torch.floor((xyz - lo[a:a + 1]) * xla_arith.reciprocal(
                self.voxel_size[a], xyz))
            # far points saturate past the grid rather than wrap
            vox.append(cell.clamp(-1, self.grid_size[a]).to(torch.int32))
        valid = torch.ones_like(vox[0], dtype=torch.bool)
        for a in range(3):
            valid &= (vox[a] >= 0) & (vox[a] < self.grid_size[a])
        return vox[1] * self.grid_size[0] + vox[0], valid

    def pool_inputs(self, feats, depth_prob, img2lidars):
        """feats [B, C, h, w] (NCHW); depth_prob [B, D, h, w]; img2lidars
        [B, 4, 4] -> bev_pool_sorted's arguments but the cell count: the
        NHWC table [B, h*w, C], the pixel [B, D*h*w] int32, the depth
        weight, the rank and valid of every frustum row."""
        b, c, h, w = feats.shape
        rank, valid = self.frustum_ranks(img2lidars, h, w)
        feat_tab = feats.permute(0, 2, 3, 1).reshape(b, h * w, c)
        pix = torch.arange(h * w, dtype=torch.int32, device=feats.device
                           ).repeat(self.depth_bins)[None].expand(b, -1)
        return (feat_tab, pix, depth_prob.reshape(b, -1), rank.reshape(b, -1),
                valid.reshape(b, -1))

    def _frustum_to_bev(self, feats, depth_prob, img2lidars):
        """feats [B, C, h, w] (NCHW); depth_prob [B, D, h, w]; img2lidars
        [B, 4, 4] -> the pooled BEV table [B, gy, gx, C] (NHWC)."""
        b, c = feats.shape[:2]
        gx, gy, _ = self.grid_size
        bev = bev_pool_sorted(*self.pool_inputs(feats, depth_prob,
                                                img2lidars), gy * gx)
        return bev.reshape(b, gy, gx, c)

    # ---------------------------------------------------------------- model
    def _image_features(self, images):
        """NHWC images in [0, 255] -> the FFE's input [B, C, h, w]."""
        feats = self.backbone(images.permute(0, 3, 1, 2).contiguous() /
                              255.0)
        if self.class_head is not None:
            return self.class_head.features(feats)
        return feats[0] if isinstance(feats, (tuple, list)) else feats

    def _forward_bev(self, batch):
        """-> (BEV net features [B, C, H, W], depth logits [B, D + 1, h,
        w])."""
        f = self._image_features(batch["data"])
        depth_logits = self.depth_head(f)
        # the last bin (beyond the range) takes part in the softmax and
        # is dropped from the pool
        depth_prob = torch.softmax(depth_logits, dim=1)[:, :-1]
        bev = self._frustum_to_bev(self.chan_reduce(f), depth_prob,
                                   batch["img2lidars"])
        feats = self.bev_backbone(bev.permute(0, 3, 1, 2).contiguous())
        if isinstance(feats, (tuple, list)):
            feats = feats[-1]
        return feats, depth_logits

    def _depth_to_bin(self, depth_map: torch.Tensor) -> torch.Tensor:
        """Depths -> bin ids (int64), D for a depth outside the range."""
        d0, d1 = self.depth_range
        d = self.depth_bins
        x = depth_map
        if self.depth_mode == "LID":
            bin_size = 2 * (d1 - d0) / (d * (1 + d))
            y = 1 + 8 * (x - d0) * xla_arith.reciprocal(bin_size, x)
            # a correctly rounded square root, as XLA's: torch's f32 one on
            # the CPU is not (sqrt(16640.998) gave 128.99998, not 129.0);
            # through f64 it is
            idx = -0.5 + 0.5 * torch.sqrt(y.to(torch.float64)).to(y.dtype)
        else:
            idx = (x - d0) * xla_arith.reciprocal((d1 - d0) / d, x)
        idx = torch.where((x < d0) | (x > d1), float(d), idx)
        return torch.clamp(idx, 0, d).to(torch.int64)

    def train_forward(self, batch) -> dict:
        """batch {"data": NHWC images [B, H, W, 3] in [0, 255],
        "img2lidars" [B, 4, 4], "gt_boxes" [B, G, 7] (bottom z),
        "gt_labels" [B, G] (-1 padded), optionally "depth_map" [B, h, w] at
        the feature stride} -> {"loss" (the total), the head's losses,
        "loss_depth" with a depth map}. Train-mode BN: batch statistics,
        running stats updated."""
        feats, depth_logits = self._forward_bev(batch)
        preds = self.bbox_head(feats)
        gt_boxes = batch["gt_boxes"]
        gt_boxes = torch.cat([
            gt_boxes[..., :6],
            limit_period(gt_boxes[..., 6:7], 0.5, 2 * math.pi),
            gt_boxes[..., 7:]], dim=-1)
        if self.anchor_mode:
            losses = self.bbox_head.loss(preds, gt_boxes, batch["gt_labels"])
            losses["loss"] = sum(losses.values())
        else:
            targets = self.target_generator(gt_boxes, batch["gt_labels"])
            losses = self.bbox_head.loss(preds, targets)
        if "depth_map" in batch:
            tgt = self._depth_to_bin(batch["depth_map"])
            logp = torch.log_softmax(depth_logits, dim=1)
            nll = -torch.gather(logp, 1, tgt[:, None])[:, 0]
            losses["loss_depth"] = nll.mean() * self.depth_loss_weight
            losses["loss"] = losses["loss"] + losses["loss_depth"]
        return losses

    @torch.no_grad()
    def test_forward(self, batch) -> dict:
        """batch {"data" [B, H, W, 3], "img2lidars" [B, 4, 4]} ->
        box3d_lidar [B, K, 7] (bottom z), scores [B, K], label_preds [B, K]
        (-1 padded). The model must be in eval mode (`.eval()`)."""
        raise_if_training(self)
        feats, _ = self._forward_bev(batch)
        preds = self.bbox_head(feats)
        if self.anchor_mode:
            rois, scores, labels = self.bbox_head.proposals(preds)
            keep = scores > float(self.test_cfg.get("score_threshold", 0.0))
            return {"box3d_lidar": rois,
                    "scores": torch.where(keep, scores, -1.),
                    "label_preds": torch.where(keep, labels, -1)}
        return self.bbox_head.predict(preds, self.test_cfg)

    postprocess_to_samples = staticmethod(
        BaseLidarModel.postprocess_to_samples)
