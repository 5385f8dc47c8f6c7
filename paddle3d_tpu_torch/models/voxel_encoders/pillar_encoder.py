"""PillarFeatureNet, torch port of
paddle3d_tpu/models/voxel_encoders/pillar_encoder.py
(get_paddings_indicator, PFNLayer, PillarFeatureNet).

Two uses. The fused pillar path (ops/pillar_ops.py) folds these layers'
weights, runs their MLPs row by row to train a PFN of two or more layers,
and reads the pillar-centre geometry (vx, vy, x_offset, y_offset). Called,
the module runs the JAX package's [V, P, C] buffer forward on the hard
voxelizer's output (BEVFusion's lidar stream): the points decorated with
their centroid and pillar-centre offsets, every padding slot zeroed, then
the PFN layers over all B * V * P slots, so that train-mode BatchNorm takes
its statistics over the zeroed padding slots too, as in the JAX package
(the fused path's train statistics cover kept rows only).
"""
from typing import Sequence

import torch
from torch import nn

from ...apis import manager
from ..layers.layer_libs import LinearBN1DReLU, default_generator

__all__ = ["PillarFeatureNet", "get_paddings_indicator"]


def get_paddings_indicator(num_points: torch.Tensor,
                           max_num: int) -> torch.Tensor:
    """[..., V] counts -> [..., V, max_num] bool: slot p holds a point."""
    idx = torch.arange(max_num, dtype=num_points.dtype,
                       device=num_points.device)
    return idx < num_points[..., None]


class PFNLayer(nn.Module):
    """Linear -> BN -> ReLU -> masked max over the pillar's points; a layer
    that is not the last concatenates the max to every point's features
    (half of out_channels each)."""

    def __init__(self, in_channels: int, out_channels: int, *,
                 last_layer: bool, generator: torch.Generator):
        super().__init__()
        self.last_vfe = last_layer
        if not last_layer:
            out_channels = out_channels // 2
        self.units = out_channels
        self.mlp = LinearBN1DReLU(in_channels, out_channels,
                                  generator=generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x [B, V, P, C], mask [B, V, P] -> [B, V, units] (last layer) or
        [B, V, P, 2 * units]. The max skips padding slots (-1e9); an empty
        pillar's is 0. amax spreads the gradient over tied maxima, as JAX's
        max does."""
        x = self.mlp(x)
        x_max = torch.where(mask[..., None], x, -1e9).amax(dim=2)
        x_max = torch.where(mask.any(dim=2)[..., None], x_max, 0.)
        if self.last_vfe:
            return x_max
        rep = x_max[:, :, None, :].expand(tuple(x.shape[:3]) + (self.units,))
        return torch.cat([x, rep], dim=-1)


@manager.VOXEL_ENCODERS.add_component
class PillarFeatureNet(nn.Module):
    def __init__(self,
                 in_channels: int = 4,
                 feat_channels: Sequence[int] = (64, ),
                 with_distance: bool = False,
                 max_num_points_in_voxel: int = 20,
                 voxel_size: Sequence[float] = (0.2, 0.2, 4),
                 point_cloud_range: Sequence[float] = (0, -40, -3, 70.4, 40,
                                                       1),
                 legacy: bool = True,
                 generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        self.in_channels = in_channels
        self.with_distance = with_distance
        self.max_num_points_in_voxel = max_num_points_in_voxel
        self.legacy = legacy
        aug_channels = in_channels + 5  # +3 cluster offset, +2 center offset
        if with_distance:
            aug_channels += 1
        channels = [aug_channels] + list(feat_channels)
        self.pfn_layers = nn.ModuleList([
            PFNLayer(channels[i], channels[i + 1],
                     last_layer=(i == len(channels) - 2), generator=generator)
            for i in range(len(channels) - 1)
        ])
        self.vx, self.vy = float(voxel_size[0]), float(voxel_size[1])
        self.x_offset = self.vx / 2 + float(point_cloud_range[0])
        self.y_offset = self.vy / 2 + float(point_cloud_range[1])
        self.voxel_size = list(map(float, voxel_size))
        self.point_cloud_range = list(map(float, point_cloud_range))
        self.out_channels = channels[-1]

    def forward(self, voxels: torch.Tensor, num_points: torch.Tensor,
                coords: torch.Tensor) -> torch.Tensor:
        """voxels [B, V, P, C], num_points [B, V], coords [B, V, 3]
        (z, y, x) -> pillar features [B, V, out_channels]."""
        mask = get_paddings_indicator(num_points,
                                      self.max_num_points_in_voxel)
        fmask = mask[..., None].to(voxels.dtype)
        xyz = voxels[..., :3] * fmask
        feats = [voxels]
        # offset from the pillar's point centroid
        denom = torch.clamp(num_points, min=1).to(voxels.dtype)[
            ..., None, None]
        feats.append(voxels[..., :3] - xyz.sum(dim=2, keepdim=True) / denom)
        # offset from the pillar's geometric centre
        cx = coords[..., 2].to(voxels.dtype) * self.vx + self.x_offset
        cy = coords[..., 1].to(voxels.dtype) * self.vy + self.y_offset
        feats.append(torch.stack([voxels[..., 0] - cx[..., None],
                                  voxels[..., 1] - cy[..., None]], dim=-1))
        if self.with_distance:
            feats.append(torch.linalg.norm(voxels[..., :3], dim=-1,
                                           keepdim=True))
        x = torch.cat(feats, dim=-1) * fmask
        for pfn in self.pfn_layers:
            x = pfn(x, mask)
        return x
