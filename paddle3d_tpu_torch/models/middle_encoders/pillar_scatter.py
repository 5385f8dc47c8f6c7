"""PointPillarsScatter, torch port of
paddle3d_tpu/models/middle_encoders/pillar_scatter.py.

The fused pillar path (ops/pillar_ops.py) scatters straight onto the
[B, ny, nx, C] canvas this module describes. Called, it places the hard
voxelizer's pillar features on that canvas through ops/scatter
.pillar_scatter: on a CUDA tensor the row-major sorted segment sum (K7 for
a dense scan, K2 for a sparse one, by the density rule), its VJP the table
gather K5.
"""
from torch import nn

from ...apis import manager
from ...ops.pillar_ops import grid_size
from ...ops.scatter import pillar_scatter

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

    def forward(self, voxel_features, coords, voxel_mask):
        """[B, V, C] features, [B, V, 3] (z, y, x) coords in the voxelizer's
        ascending key order and [B, V] mask -> the [B, ny, nx, C] canvas
        (NHWC)."""
        return pillar_scatter(voxel_features, coords, voxel_mask, self.ny,
                              self.nx)
