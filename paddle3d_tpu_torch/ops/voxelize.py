"""Point → voxel-grid coordinates, the hard voxelization into a [V, P, C]
buffer, and the fused voxelize + mean.

Port of paddle3d_tpu/ops/voxelize.py: points_to_voxel_coords,
hard_voxelize with its batched entry hard_voxelize_batch, and voxel_mean
with its batched entry voxel_mean_batch, each batched one as one function
over a batch [B, N, C] (the JAX package vmaps the per-sample functions).
Plain PyTorch: the JAX package runs these as XLA, not as Pallas kernels.
"""
from typing import Sequence, Tuple

import numpy as np
import torch

from .segmented import blocked_cumsum, seg_prefix_sum_bounded

__all__ = ["points_to_voxel_coords", "hard_voxelize_batch",
           "voxel_mean_batch"]

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


def _grid_and_keys(points, voxel_size, point_cloud_range):
    """-> (coords_xyz [B, N, 3] int32, valid [B, N], the z-major cell key
    [B, N] int32 with invalid points at the sentinel, (gx, gy, gz),
    sentinel gx * gy * gz + 1)."""
    coords_xyz, valid = points_to_voxel_coords(points, voxel_size,
                                               point_cloud_range)
    pc = np.asarray(point_cloud_range, np.float32)
    vs = np.asarray(voxel_size, np.float32)
    gx, gy, gz = (int(g) for g in np.round((pc[3:6] - pc[0:3]) / vs))
    sentinel = gx * gy * gz + 1
    key = (coords_xyz[..., 2] * (gy * gx) + coords_xyz[..., 1] * gx +
           coords_xyz[..., 0])
    key = torch.where(valid, key, sentinel).to(torch.int32)
    return coords_xyz, valid, key, (gx, gy, gz), sentinel


def hard_voxelize_batch(points: torch.Tensor, voxel_size: Sequence[float],
                        point_cloud_range: Sequence[float],
                        max_points_in_voxel: int, max_voxels: int):
    """Hard voxelization of a batch into fixed-capacity buffers.

    points [B, N, C] (NaN or out-of-range rows are padding) ->
    (voxels [B, V, P, C] zero padded, coords [B, V, 3] (z, y, x) int32 with
    -1 padding, num_points [B, V] int32 (<= P), voxel_mask [B, V] bool),
    V = min(max_voxels, N), P = max_points_in_voxel.

    The JAX package's semantics: the z-major cell key (invalid points at
    the sentinel gx * gy * gz + 1), a stable sort by it; the first
    max_voxels voxels in ascending key order, the first P points of each
    voxel in input order; the mask is the first min(voxels, V) slots."""
    b, n, c = points.shape
    p = max_points_in_voxel
    v = min(max_voxels, n)
    dev = points.device
    coords_xyz, _, key, _, sentinel = _grid_and_keys(
        points, voxel_size, point_cloud_range)
    skey, order = torch.sort(key, dim=1, stable=True)
    svalid = skey < sentinel
    first = torch.ones((b, 1), dtype=torch.bool, device=dev)
    head = torch.cat([first, skey[:, 1:] != skey[:, :-1]], dim=1) & svalid
    voxel_id = torch.cumsum(head.to(torch.int32), dim=1) - 1
    pos = torch.arange(n, dtype=torch.int32, device=dev).expand(b, n)
    seg_start = torch.cummax(torch.where(head, pos, -1), dim=1).values
    rank = pos - seg_start
    keep = svalid & (voxel_id < v) & (rank < p)

    # every batch row's buffer has a trash slot (v * p) that is sliced away
    row = torch.arange(b, device=dev)[:, None]
    flat = torch.where(keep, voxel_id * p + rank, v * p) + row * (v * p + 1)
    flat = flat.reshape(-1).long()
    spts = torch.gather(points, 1, order[..., None].expand(-1, -1, c))
    voxels = points.new_zeros((b * (v * p + 1), c))
    voxels.index_put_((flat,), spts.reshape(-1, c))
    filled = torch.zeros(b * (v * p + 1), dtype=torch.bool, device=dev)
    filled.index_put_((flat,), keep.reshape(-1))
    voxels = voxels.view(b, v * p + 1, c)[:, :-1].reshape(b, v, p, c)
    num_points = filled.view(b, v * p + 1)[:, :-1].reshape(b, v, p).sum(
        dim=-1, dtype=torch.int32)

    # (z, y, x) at each kept voxel's head
    szyx = torch.gather(coords_xyz, 1, order[..., None].expand(-1, -1, 3))
    szyx = szyx.flip(-1).to(torch.int32)
    slot = torch.where(head & (voxel_id < v), voxel_id, v) + row * (v + 1)
    coords = torch.full((b * (v + 1), 3), -1, dtype=torch.int32, device=dev)
    coords.index_put_((slot.reshape(-1).long(),), szyx.reshape(-1, 3))
    coords = coords.view(b, v + 1, 3)[:, :-1]

    n_vox = head.sum(dim=1, keepdim=True)
    voxel_mask = torch.arange(v, device=dev)[None] < torch.clamp(n_vox,
                                                                max=v)
    return voxels, coords, num_points, voxel_mask


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
    _, _, key, (gx, gy, _), sentinel = _grid_and_keys(
        points, voxel_size, point_cloud_range)
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
