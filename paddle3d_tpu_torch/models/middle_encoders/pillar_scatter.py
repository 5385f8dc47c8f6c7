"""PointPillarsScatter geometry holder, torch port of
paddle3d_tpu/models/middle_encoders/pillar_scatter.py.

The fused pillar path (ops/pillar_ops.py) scatters straight onto the
[B, ny, nx, C] canvas this module describes.
"""
from torch import nn

from ...apis import manager
from ...ops.pillar_ops import grid_size

__all__ = ["PointPillarsScatter"]


@manager.MIDDLE_ENCODERS.add_component
class PointPillarsScatter(nn.Module):
    #: BEV-plane downsampling vs. the voxel grid (dense scatter keeps it).
    bev_stride = 1

    def __init__(self, in_channels, voxel_size, point_cloud_range):
        super().__init__()
        self.in_channels = in_channels
        grid = grid_size(voxel_size, point_cloud_range)
        self.nx = int(grid[0])
        self.ny = int(grid[1])
