"""PillarFeatureNet parameter and geometry holder, torch port of
paddle3d_tpu/models/voxel_encoders/pillar_encoder.py.

The fused pillar path (ops/pillar_ops.py) folds these layers' weights, runs
their MLPs row by row to train a PFN of two or more layers, and reads the
pillar-centre geometry (vx, vy, x_offset, y_offset); the [V, P, C] buffer
forward is not ported.
"""
from typing import Sequence

import torch
from torch import nn

from ...apis import manager
from ..layers.layer_libs import LinearBN1DReLU, default_generator

__all__ = ["PillarFeatureNet"]


class PFNLayer(nn.Module):
    """Linear -> BN -> ReLU (-> masked max over the pillar's points)."""

    def __init__(self, in_channels: int, out_channels: int, *,
                 last_layer: bool, generator: torch.Generator):
        super().__init__()
        self.last_vfe = last_layer
        if not last_layer:
            out_channels = out_channels // 2
        self.units = out_channels
        self.mlp = LinearBN1DReLU(in_channels, out_channels,
                                  generator=generator)


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
