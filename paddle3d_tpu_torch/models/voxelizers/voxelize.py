"""HardVoxelizer, torch port of paddle3d_tpu/models/voxelizers/voxelize.py.

The fused pillar path (ops/pillar_ops.py) reads the grid and the per-mode
voxel cap from here; called, the module voxelizes a batch into the
[V, P, C] buffers of ops/voxelize.hard_voxelize_batch, with the train or
eval voxel cap (BEVFusion's lidar stream).
"""
from typing import Sequence, Union

from torch import nn

from ...apis import manager
from ...ops.voxelize import hard_voxelize_batch

__all__ = ["HardVoxelizer"]


@manager.VOXELIZERS.add_component
class HardVoxelizer(nn.Module):
    def __init__(self, voxel_size: Sequence[float],
                 point_cloud_range: Sequence[float],
                 max_num_points_in_voxel: int,
                 max_num_voxels: Union[int, Sequence[int]]):
        super().__init__()
        self.voxel_size = list(map(float, voxel_size))
        self.point_cloud_range = list(map(float, point_cloud_range))
        self.max_num_points_in_voxel = int(max_num_points_in_voxel)
        if isinstance(max_num_voxels, (tuple, list)):
            self.max_num_voxels = [int(v) for v in max_num_voxels]
        else:
            self.max_num_voxels = [int(max_num_voxels), int(max_num_voxels)]

    def max_num_voxels_for(self, training: bool) -> int:
        return self.max_num_voxels[0 if training else 1]

    def forward(self, points, training: bool = True):
        """points [B, N, C] (NaN padded) -> voxels [B, V, P, C], coords
        [B, V, 3] (z, y, x), num_points [B, V], mask [B, V]; V is the
        train or eval cap (at most N)."""
        return hard_voxelize_batch(points, self.voxel_size,
                                   self.point_cloud_range,
                                   self.max_num_points_in_voxel,
                                   self.max_num_voxels_for(training))
