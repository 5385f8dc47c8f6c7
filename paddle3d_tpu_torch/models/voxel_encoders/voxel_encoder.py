"""VoxelMean, torch port of
paddle3d_tpu/models/voxel_encoders/voxel_encoder.py:VoxelMean.

It has no parameters. CenterPoint's voxel path never builds the [V, P, C]
buffer: it reads `in_channels` and runs the fused voxelize + mean
(ops/voxelize.voxel_mean_batch). The buffer forward is kept for a caller
that holds voxels. HardVFE is not ported yet.
"""
import torch
from torch import nn

from ...apis import manager

__all__ = ["VoxelMean"]


@manager.VOXEL_ENCODERS.add_component
class VoxelMean(nn.Module):
    """Mean of the points in each voxel."""

    def __init__(self, in_channels: int = 4):
        super().__init__()
        self.in_channels = in_channels

    def forward(self, voxels, num_points, coords=None):
        """voxels [B, V, P, C], num_points [B, V] -> [B, V, in_channels]."""
        p = voxels.shape[2]
        mask = torch.arange(p, device=voxels.device) < num_points[..., None]
        total = torch.where(mask[..., None],
                            voxels[..., :self.in_channels], 0.).sum(dim=2)
        return total / num_points.clamp(min=1).to(voxels.dtype)[..., None]
