"""Point → pillar-grid coordinates.

Port of paddle3d_tpu/ops/voxelize.py:points_to_voxel_coords. Works on any
leading batch shape.
"""
from typing import Sequence, Tuple

import torch

__all__ = ["points_to_voxel_coords"]


def points_to_voxel_coords(points: torch.Tensor, voxel_size: Sequence[float],
                           point_cloud_range: Sequence[float]
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map points to integer grid coords (x,y,z order) + validity mask.

    points: [..., N, C>=3] float32; a point is invalid if any coordinate is
    non-finite or falls outside point_cloud_range.
    """
    pc_range = torch.tensor(point_cloud_range, dtype=points.dtype,
                            device=points.device)
    vsize = torch.tensor(voxel_size, dtype=points.dtype, device=points.device)
    grid_size = torch.round((pc_range[3:6] - pc_range[0:3]) / vsize).to(
        torch.int32)
    xyz = points[..., :3]
    finite = torch.isfinite(xyz).all(dim=-1)
    # non-finite rows are zeroed before the int cast (casting NaN to int is
    # undefined); the finite mask drops them anyway
    xyz = torch.where(finite[..., None], xyz, torch.zeros_like(xyz))
    coords = torch.floor((xyz - pc_range[0:3]) / vsize).to(torch.int32)
    in_range = ((coords >= 0) & (coords < grid_size)).all(dim=-1)
    return coords, in_range & finite
