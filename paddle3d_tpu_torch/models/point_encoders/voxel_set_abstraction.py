"""Voxel Set Abstraction (PV-RCNN's keypoint encoder), torch port of
paddle3d_tpu/models/point_encoders/voxel_set_abstraction.py.

Keypoints are farthest-point-sampled from the raw cloud (ops/fps.py);
their features are gathered from (a) the raw points and (b) every sparse
stage's voxel centres, by ball query and a shared MLP each
(ops/ball_query.py), and from (c) the dense BEV map by bilinear
interpolation. Fixed capacities, the batch axis written out.
"""
from typing import Sequence

import torch
from torch import nn

from ...apis import manager
from ...ops import fps as _fps
from ...ops.pointnet2 import gather_operation
from ..common.pointnet2_modules import PointMLP, group_max
from ..layers.layer_libs import default_generator

__all__ = ["VoxelSetAbstraction", "bev_bilinear"]


def bev_bilinear(bev: torch.Tensor, xy: torch.Tensor, pc_range, voxel_size,
                 stride: int) -> torch.Tensor:
    """bev [B, H, W, C] (NHWC); xy [B, K, 2] world coords -> [B, K, C]:
    cell centres sit at half-integers, taps outside the map count as
    zero."""
    b, h, w, c = bev.shape
    fx = (xy[..., 0] - pc_range[0]) / (voxel_size[0] * stride) - 0.5
    fy = (xy[..., 1] - pc_range[1]) / (voxel_size[1] * stride) - 0.5
    x0f, y0f = torch.floor(fx), torch.floor(fy)
    x0, y0 = x0f.to(torch.int32), y0f.to(torch.int32)
    tx, ty = fx - x0f, fy - y0f
    flat = bev.reshape(b, h * w, c)

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        lin = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        return torch.where(inb[..., None], gather_operation(flat, lin), 0.)

    return (tap(x0, y0) * ((1 - tx) * (1 - ty))[..., None] +
            tap(x0 + 1, y0) * (tx * (1 - ty))[..., None] +
            tap(x0, y0 + 1) * ((1 - tx) * ty)[..., None] +
            tap(x0 + 1, y0 + 1) * (tx * ty)[..., None])


@manager.POINT_ENCODERS.add_component
class VoxelSetAbstraction(nn.Module):
    def __init__(self,
                 num_keypoints: int = 2048,
                 bev_channels: int = 256,
                 bev_stride: int = 8,
                 point_cloud_range: Sequence[float] = (0, -40, -3, 70.4, 40,
                                                       1),
                 voxel_size: Sequence[float] = (0.05, 0.05, 0.1),
                 raw_mlps: Sequence[int] = (16, 16),
                 raw_radius: float = 0.8,
                 raw_nsample: int = 16,
                 stage_channels: Sequence[int] = (),
                 stage_mlps: Sequence[int] = (16, 16),
                 stage_radii: Sequence[float] = (0.8, 1.6, 3.2, 6.4),
                 stage_nsample: int = 16,
                 out_channels: int = 128,
                 model_cfg: dict = None,
                 num_bev_features: int = None,
                 num_rawpoint_features: int = None,
                 generator: torch.Generator = None):
        """`stage_channels` enables the multi-level sparse-conv sources: one
        ball query + shared MLP per sparse stage, grouping stage voxel
        centres around each keypoint.

        `model_cfg` accepts the nested OpenPCDet-style spec (sa_layer with
        per-source mlps / pool_radius / nsample) and maps it onto the flat
        arguments: per-stage MLP widths and the LAST (largest) radius of
        each source's radius list; stage input channels follow the spec's
        MLP widths, which mirror the sparse backbone's stage widths."""
        super().__init__()
        del num_rawpoint_features
        if model_cfg is not None:
            m = dict(model_cfg)
            num_keypoints = int(m.get("num_keypoints", num_keypoints))
            out_channels = int(m.get("out_channels", out_channels))
            if num_bev_features is not None:
                bev_channels = int(num_bev_features)
            sa = m.get("sa_layer", {})
            if "raw_points" in sa:
                raw_mlps = list(sa["raw_points"]["mlps"][0])
                raw_radius = float(sa["raw_points"]["pool_radius"][-1])
                raw_nsample = int(sa["raw_points"]["nsample"][-1])
            convs = sorted(k for k in sa if k.startswith("x_conv"))
            if convs:
                stage_channels = [int(sa[k]["mlps"][0][0]) for k in convs]
                stage_radii = [float(sa[k]["pool_radius"][-1])
                               for k in convs]
                stage_mlps = [list(sa[k]["mlps"][0]) for k in convs]
                stage_nsample = int(sa[convs[-1]]["nsample"][-1])
        g = default_generator(generator)
        self.num_keypoints = num_keypoints
        self.bev_stride = bev_stride
        self.pc_range = list(map(float, point_cloud_range))
        self.voxel_size = list(map(float, voxel_size))
        self.raw_radius = raw_radius
        self.raw_nsample = raw_nsample
        self.raw_mlp = PointMLP([4] + list(raw_mlps), generator=g)
        self.stage_channels = list(stage_channels)
        self.stage_radii = list(stage_radii)
        self.stage_nsample = stage_nsample
        # stage_mlps: flat widths shared by every stage, or one width list
        # per stage (the per-source sa_layer specs)
        if stage_mlps and isinstance(stage_mlps[0], (list, tuple)):
            per_stage = [list(s) for s in stage_mlps]
        else:
            per_stage = [list(stage_mlps) for _ in self.stage_channels]
        self.stage_mlps = nn.ModuleList([
            PointMLP([c + 3] + widths, generator=g)
            for c, widths in zip(self.stage_channels, per_stage)
        ])
        fuse_in = bev_channels + raw_mlps[-1] + \
            sum(widths[-1] for widths in per_stage[:len(self.stage_channels)])
        self.prefuse_channels = fuse_in
        self.fuse = PointMLP([fuse_in, out_channels], generator=g)
        self.out_channels = out_channels

    def forward(self, points, bev, sparse_stages=None, return_prefuse=False):
        """points [B, N, C>=4] (NaN padded); bev [B, H, W, Cb] (NHWC);
        sparse_stages: optional list of (xyz [B,V,3], feats [B,V,C],
        mask [B,V]) per sparse level (len == len(stage_channels)) ->
        (keypoints [B, K, 3], features [B, K, out], mask [B, K])."""
        mask = torch.isfinite(points).all(dim=-1)
        xyz = torch.where(mask[..., None], points[..., :3], 0.)
        kp_idx = _fps.farthest_point_sample_batched(xyz, mask,
                                                    self.num_keypoints)
        kp = gather_operation(xyz, kp_idx)
        kp_mask = gather_operation(mask, kp_idx)
        bevf = bev_bilinear(bev, kp[..., :2], self.pc_range, self.voxel_size,
                            self.bev_stride)

        # raw-point source: offsets to the keypoint and the intensity
        inten = torch.where(mask[..., None],
                            torch.nan_to_num(points[..., 3:4]), 0.)
        parts = [bevf, group_max(self.raw_mlp, self.raw_radius,
                                 self.raw_nsample, xyz, inten, mask, kp)]
        if self.stage_channels and sparse_stages:
            for (sxyz, sfeat, smask), radius, mlp in zip(
                    sparse_stages, self.stage_radii, self.stage_mlps):
                parts.append(group_max(mlp, radius, self.stage_nsample, sxyz,
                                       sfeat, smask, kp))

        prefuse = torch.cat(parts, dim=-1)
        feat = self.fuse(prefuse) * kp_mask[..., None]
        if return_prefuse:
            # the pre-fusion concat, for Predicted Keypoint Weighting
            return kp, feat, kp_mask, prefuse
        return kp, feat, kp_mask
