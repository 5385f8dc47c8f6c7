"""Fused pillar pipeline: raw points → BEV canvas (+ occupancy).

Port of paddle3d_tpu/ops/pillar_ops.py (sort_points_by_cell,
pfn_folded_weights, pillar_decorate_sorted, pillar_emit_rows and
fused_pillar_canvas, through _fused_pillar_canvas_pallas in eval,
_fused_pillar_canvas_pallas_train for a one-layer PFN in train and the
multi-layer train branch of fused_pillar_canvas). A stable sort groups
points by pillar cell. In eval the fused PFN kernel (ops/fused_pfn.py) puts
each pillar's feature on one row; a dense scan (nuScenes 10-sweep) hands
the PFN's channel-major rows straight to the channel-major sum (K6), a
sparse one (KITTI) transposes them for the row-major sum (K2), by the JAX
package's density rule. In train a one-layer PFN runs the same kernel with
batch-statistics BN (ops/fused_pfn_train.py); a deeper one runs its layers
row by row, each pillar's max through the segmented window max (K12,
ops/seg_window.py). The rows reach the canvas through the row-major sum (K7
or K2) with its VJP (K5). The [V, P, C] voxel buffer never exists.
"""
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import fused_pfn
from .fused_pfn import _decorate_plain
from .fused_pfn_train import fused_pfn_train_rows
from .seg_window import seg_window_max
from .segmented import seg_prefix_max_bounded
from .sorted_scatter import (is_dense_scan, sorted_segment_sum,
                             sorted_segment_sum_cm, sorted_segment_sum_split)
from .voxelize import points_to_voxel_coords

__all__ = ["sort_points_by_cell", "pfn_folded_weights",
           "pillar_decorate_sorted", "pillar_emit_rows",
           "fused_pillar_canvas", "is_dense_scan"]

_SENTINEL = 2**31 - 1
_NEG = -1e9        # the mask of rows a pillar does not keep


def grid_size(voxel_size: Sequence[float],
              point_cloud_range: Sequence[float]) -> np.ndarray:
    """(nx, ny, nz) of the voxel grid, computed in f32 as the JAX package
    does."""
    pc = np.asarray(point_cloud_range, np.float32)
    vs = np.asarray(voxel_size, np.float32)
    return np.round((pc[3:6] - pc[0:3]) / vs).astype(np.int64)


def sort_points_by_cell(points: torch.Tensor, voxel_size: Sequence[float],
                        point_cloud_range: Sequence[float]):
    """Points [B, N, C] -> (keys [B, N] int32 ascending, sentinel 2^31-1 for
    out-of-range rows; sorted point columns [B, C, N]).

    A stable sort of the keys, then one gather of the points by the
    permutation (a gather is cheap on the GPU, so no multi-operand sort)."""
    nx = int(grid_size(voxel_size, point_cloud_range)[0])
    coords, valid = points_to_voxel_coords(points, voxel_size,
                                           point_cloud_range)
    key = torch.where(valid, coords[..., 1] * nx + coords[..., 0],
                      _SENTINEL).to(torch.int32)
    skey, perm = torch.sort(key, dim=1, stable=True)
    spts = torch.gather(points, 1,
                        perm[..., None].expand(-1, -1, points.shape[-1]))
    return skey, spts.transpose(1, 2).contiguous()


def pillar_decorate_sorted(points: torch.Tensor,
                           voxel_size: Sequence[float],
                           point_cloud_range: Sequence[float],
                           max_points_in_voxel: int, max_voxels: int,
                           with_distance: bool = False) -> dict:
    """Sort each scan's points by pillar cell and build the PFN input rows.

    points [B, N, C >= 3] (NaN or out-of-range padded). Returns a dict of
    [B, N]-aligned tensors: decorated [B, N, C + 5 (+1)] (zero where not
    kept), keys int32 (ascending, 2^31-1 for dropped rows), head / tail
    (segment boundaries), keep (rank < P within the max_voxels cap) and
    emit (the pillar's last kept row). The decoration is the fused PFN
    kernel's plain version, so the rows equal what K1 and K3 see."""
    vx, vy = float(voxel_size[0]), float(voxel_size[1])
    nx = int(grid_size(voxel_size, point_cloud_range)[0])
    keys, pts_t = sort_points_by_cell(points, voxel_size, point_cloud_range)
    x, keep, emit, _, _ = _decorate_plain(
        keys, pts_t.transpose(1, 2), max_points_in_voxel, max_voxels, nx, vx,
        vy, vx / 2 + float(point_cloud_range[0]),
        vy / 2 + float(point_cloud_range[1]), with_distance)
    valid = keys < _SENTINEL
    head = valid & (keys != F.pad(keys[:, :-1], (1, 0), value=-1))
    tail = valid & (keys != F.pad(keys[:, 1:], (0, 1), value=_SENTINEL))
    return dict(decorated=x, keys=keys, head=head, tail=tail, keep=keep,
                emit=emit)


def pillar_emit_rows(feats: torch.Tensor, keys: torch.Tensor,
                     keep: torch.Tensor, emit: torch.Tensor,
                     max_points: int) -> torch.Tensor:
    """Per-point features [B, N, C] -> rows carrying each pillar's max over
    its kept rows at its emission row (its last kept row), zero elsewhere:
    a bounded prefix max covers the kept prefix. The train path computes
    the same rows with the centred window max (K12)."""
    masked = torch.where(keep[..., None], feats, _NEG)
    segmax = seg_prefix_max_bounded(masked, keys, max_points)
    return torch.where(emit[..., None], segmax, 0.)


def pfn_folded_weights(pfn):
    """Eval-mode BN-folded weights for the fused PFN kernel.

    LinearBN1DReLU: y = relu(bn(x W^T)); with running stats the BN is the
    per-channel affine (scale s, shift c), so y = relu(x (W·s)^T + c).
    Returns (w1t [u1, C_dec], b1 [u1, 1], w2t [u2, 2·u1] | None, b2)."""
    def fold(layer):
        w = layer.mlp.linear.weight                         # [u, C_dec]
        bn = layer.mlp.bn
        s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        c = bn.bias - bn.running_mean * s
        return (w * s[:, None]).contiguous(), c[:, None].contiguous()

    w1t, b1 = fold(pfn.pfn_layers[0])
    if len(pfn.pfn_layers) == 2:
        w2t, b2 = fold(pfn.pfn_layers[1])
        return w1t, b1, w2t, b2
    return w1t, b1, None, None


def _place(keys, rows_t, middle_encoder, with_occupancy, dense=False):
    """Channel-major rows [B, C(+1), N] → canvas [B, ny, nx, C]
    (+ occupancy [B, ny, nx]): straight through the channel-major sum when
    `dense`, else transposed for the row-major sum."""
    ny, nx = middle_encoder.ny, middle_encoder.nx
    b = keys.shape[0]
    if dense:
        out = sorted_segment_sum_cm(keys, rows_t, ny * nx,
                                    split_last=with_occupancy)
        if with_occupancy:
            return out[0].reshape(b, ny, nx, -1), out[1].reshape(b, ny, nx)
        return out.reshape(b, ny, nx, -1)
    rows = rows_t.transpose(1, 2).contiguous()        # [B, N, C(+1)]
    if with_occupancy:
        table, occ = sorted_segment_sum_split(keys, rows, ny * nx)
        return table.reshape(b, ny, nx, -1), occ.reshape(b, ny, nx)
    return sorted_segment_sum(keys, rows, ny * nx).reshape(b, ny, nx, -1)


def fused_pillar_canvas(voxelizer, pfn, middle_encoder,
                        points: torch.Tensor, training: bool,
                        with_occupancy: bool = False):
    """Points → canvas [B, ny, nx, C] (+ occupancy [B, ny, nx]).

    The canvas keeps the JAX package's NHWC layout; the occupancy map is
    the emission flag carried as one extra scatter channel. `training`
    picks the voxel cap (max_num_voxels_for) and the branch, as in the JAX
    package. Eval folds the PFN's BN from running stats and records no
    autograd graph. Train uses batch-statistics BN, updates the running
    stats as flax does, and gives a canvas differentiable in the PFN's
    weights and BN affines."""
    if training:
        if len(pfn.pfn_layers) == 1:
            return _canvas_train(voxelizer, pfn, middle_encoder, points,
                                 with_occupancy)
        return _canvas_train_layers(voxelizer, pfn, middle_encoder, points,
                                    with_occupancy)
    if len(pfn.pfn_layers) > 2:
        raise NotImplementedError(
            "the port's eval pillar canvas takes 1-2 PFN layers")
    return _canvas_eval(voxelizer, pfn, middle_encoder, points,
                        with_occupancy)


@torch.no_grad()
def _canvas_eval(voxelizer, pfn, middle_encoder, points, with_occupancy):
    keys, pts_t = sort_points_by_cell(points, voxelizer.voxel_size,
                                      voxelizer.point_cloud_range)
    w1t, b1, w2t, b2 = pfn_folded_weights(pfn)
    rows_t = fused_pfn.fused_pfn_rows(
        keys, pts_t, w1t, b1, w2t, b2,
        n_layers=len(pfn.pfn_layers),
        P=pfn.max_num_points_in_voxel,
        maxV=voxelizer.max_num_voxels_for(False),
        nx=middle_encoder.nx, vx=pfn.vx, vy=pfn.vy, x_off=pfn.x_offset,
        y_off=pfn.y_offset, with_distance=pfn.with_distance,
        occupancy=with_occupancy)
    dense = is_dense_scan(keys.shape[1], middle_encoder.ny * middle_encoder.nx)
    return _place(keys, rows_t, middle_encoder, with_occupancy, dense)


def _canvas_train(voxelizer, pfn, middle_encoder, points, with_occupancy):
    """Port of _fused_pillar_canvas_pallas_train (one PFN layer): K3 →
    batch-stat-folded K1 → K2 or K7, with K4 and K5 as the backward."""
    with torch.no_grad():
        keys, pts_t = sort_points_by_cell(points, voxelizer.voxel_size,
                                          voxelizer.point_cloud_range)
    mlp = pfn.pfn_layers[0].mlp
    bn = mlp.bn
    rows_t, mu, var = fused_pfn_train_rows(
        keys, pts_t, mlp.linear.weight, bn.weight, bn.bias,
        P=pfn.max_num_points_in_voxel,
        maxV=voxelizer.max_num_voxels_for(True),
        nx=middle_encoder.nx, vx=pfn.vx, vy=pfn.vy, x_off=pfn.x_offset,
        y_off=pfn.y_offset, with_distance=pfn.with_distance,
        occupancy=with_occupancy, eps=bn.eps)
    with torch.no_grad():
        # flax running-stat update: mean <- 0.99 mean + 0.01 mu (momentum
        # 0.01 in torch's convention), var with the biased batch variance
        keep = 1.0 - bn.momentum
        bn.running_mean.copy_(keep * bn.running_mean + bn.momentum * mu)
        bn.running_var.copy_(keep * bn.running_var + bn.momentum * var)
        bn.num_batches_tracked.add_(1)
    return _place(keys, rows_t, middle_encoder, with_occupancy)


def _canvas_train_layers(voxelizer, pfn, middle_encoder, points,
                         with_occupancy):
    """Port of fused_pillar_canvas's multi-layer train branch with the JAX
    package's use_seg_kernel on: per layer the row-wise MLP (batch-stat BN
    over every row, the rows a pillar does not keep at zero), each pillar's
    max through K12 on the -1e9-masked rows: broadcast to the pillar's rows
    and concatenated between layers, taken at the emission row after the
    last (there the centred window over kept rows equals the prefix max of
    pillar_emit_rows). The rows reach the canvas through the row-major sum
    (K7 on a dense scan, K2 on a sparse one) with K5 as its VJP."""
    P = pfn.max_num_points_in_voxel
    with torch.no_grad():
        dec = pillar_decorate_sorted(points, voxelizer.voxel_size,
                                     voxelizer.point_cloud_range, P,
                                     voxelizer.max_num_voxels_for(True),
                                     pfn.with_distance)
    x, keys, keep, emit = (dec[k] for k in ("decorated", "keys", "keep",
                                            "emit"))
    kept = keep[..., None]
    last = len(pfn.pfn_layers) - 1
    for i, layer in enumerate(pfn.pfn_layers):
        y = layer.mlp(x)
        segmax = seg_window_max(torch.where(kept, y, _NEG), keys, P)
        if i < last:
            x = torch.where(kept, torch.cat([y, segmax], dim=-1), 0.)
        else:
            rows = torch.where(emit[..., None], segmax, 0.)
    ny, nx = middle_encoder.ny, middle_encoder.nx
    b = keys.shape[0]
    if with_occupancy:
        rows = torch.cat([rows, emit[..., None].to(rows.dtype)], dim=-1)
        table, occ = sorted_segment_sum_split(keys, rows, ny * nx)
        return table.reshape(b, ny, nx, -1), occ.reshape(b, ny, nx)
    return sorted_segment_sum(keys, rows, ny * nx).reshape(b, ny, nx, -1)
