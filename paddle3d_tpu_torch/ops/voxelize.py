"""Point → voxel-grid coordinates, and the fused voxelize + mean.

Port of paddle3d_tpu/ops/voxelize.py: points_to_voxel_coords, and
voxel_mean with its batched entry voxel_mean_batch as one function over a
batch [B, N, C] (the JAX package vmaps the per-sample voxel_mean). Plain
PyTorch: the JAX package runs these as XLA, not as Pallas kernels.
"""
from typing import Sequence, Tuple

import numpy as np
import torch

from .segmented import blocked_cumsum, seg_prefix_sum_bounded

__all__ = ["points_to_voxel_coords", "voxel_mean_batch"]

_EMPTY_KEY = 2**31 - 1


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


def voxel_mean_batch(points: torch.Tensor, voxel_size: Sequence[float],
                     point_cloud_range: Sequence[float],
                     max_points_in_voxel: int, max_voxels: int,
                     in_channels: int = None):
    """Fused hard voxelization + VoxelMean of a batch: the [V, P, C] buffer
    never exists.

    points [B, N, C] (NaN or out-of-range rows are padding) ->
    (feats [B, V, Cm] f32, coords [B, V, 3] (z, y, x) int32, num_points
    [B, V] int32, mask [B, V] bool), V = min(max_voxels, N), Cm =
    in_channels or C.

    The JAX package's semantics: a stable sort by voxel key; the first
    `max_points_in_voxel` points of each voxel in arrival order and the
    first `max_voxels` voxels in ascending-key order; the capped mean, summed
    in f32 by a bounded doubling scan, at each voxel's emission row; the
    emission rows compacted to the front in key order; padding rows with
    coords -1 and zero features."""
    b, n, c = points.shape
    cm = in_channels or c
    p = max_points_in_voxel
    max_voxels = min(max_voxels, n)
    dev = points.device
    coords_xyz, valid = points_to_voxel_coords(points, voxel_size,
                                               point_cloud_range)
    pc = np.asarray(point_cloud_range, np.float32)
    vs = np.asarray(voxel_size, np.float32)
    gx, gy, gz = (int(g) for g in np.round((pc[3:6] - pc[0:3]) / vs))
    sentinel = gx * gy * gz + 1

    key = (coords_xyz[..., 2] * (gy * gx) + coords_xyz[..., 1] * gx +
           coords_xyz[..., 0])
    key = torch.where(valid, key, sentinel).to(torch.int32)
    skey, perm = torch.sort(key, dim=1, stable=True)
    svals = torch.gather(points[..., :cm].to(torch.float32), 1,
                         perm[..., None].expand(-1, -1, cm))

    svalid = skey < sentinel
    first = torch.ones((b, 1), dtype=torch.bool, device=dev)
    head = torch.cat([first, skey[:, 1:] != skey[:, :-1]], dim=1) & svalid
    # the tail from the key boundary: the valid → sentinel transition
    # carries no head flag, so tail flags from heads would lose the last
    # voxel's emission row
    next_key = torch.cat([skey[:, 1:], torch.full_like(skey[:, :1],
                                                       sentinel)], dim=1)
    tail = svalid & (skey != next_key)
    rank = seg_prefix_sum_bounded(torch.ones_like(skey), skey, p + 1) - 1
    voxel_id = blocked_cumsum(head.to(torch.int32)) - 1
    keep = svalid & (rank < p) & (voxel_id < max_voxels)
    emit = keep & (tail | (rank == p - 1))

    # where, not multiply: dropped rows may be NaN padding (NaN * 0 = NaN)
    kept_vals = torch.where(keep[..., None], svals, 0.)
    sums = seg_prefix_sum_bounded(
        torch.cat([kept_vals, keep[..., None].to(torch.float32)], dim=-1),
        skey, p)
    count = sums[..., cm]
    mean = sums[..., :cm] / torch.clamp(count, min=1.)[..., None]

    # compaction: emission rows to the front, ascending-key order kept
    key2 = torch.where(emit, skey, _EMPTY_KEY)
    k2, order = torch.sort(key2, dim=1, stable=True)
    k2, order = k2[:, :max_voxels], order[:, :max_voxels]
    cnt = torch.gather(count, 1, order)
    feats = torch.gather(mean, 1, order[..., None].expand(-1, -1, cm))

    mask = k2 < sentinel
    z = torch.div(k2, gy * gx, rounding_mode="floor")
    rem = k2 - z * (gy * gx)
    y = torch.div(rem, gx, rounding_mode="floor")
    x = rem - y * gx
    coords = torch.where(mask[..., None], torch.stack([z, y, x], dim=-1),
                         -1).to(torch.int32)
    num_points = torch.where(mask, cnt.to(torch.int32), 0)
    feats = torch.where(mask[..., None], feats, 0.).to(points.dtype)
    return feats, coords, num_points, mask
