"""Fused pillar pipeline: raw points → BEV canvas (+ occupancy).

Port of paddle3d_tpu/ops/pillar_ops.py (sort_points_by_cell,
pfn_folded_weights, fused_pillar_canvas through _fused_pillar_canvas_pallas
in eval and _fused_pillar_canvas_pallas_train in train): a stable sort
groups points by pillar cell, the fused PFN kernel (ops/fused_pfn.py; in
train with batch-statistics BN, ops/fused_pfn_train.py) puts each pillar's
feature on one row, and the sorted segment sum (ops/sorted_scatter.py)
places the rows on the canvas: in eval a dense scan (nuScenes 10-sweep)
hands the PFN's channel-major rows straight to the channel-major sum (K6),
a sparse one (KITTI) transposes them for the row-major sum (K2), by the
JAX package's density rule. The [V, P, C] voxel buffer never exists.
"""
from typing import Sequence

import numpy as np
import torch

from . import fused_pfn
from .fused_pfn_train import fused_pfn_train_rows
from .sorted_scatter import (is_dense_scan, sorted_segment_sum,
                             sorted_segment_sum_cm, sorted_segment_sum_split)
from .voxelize import points_to_voxel_coords

__all__ = ["sort_points_by_cell", "pfn_folded_weights",
           "fused_pillar_canvas", "is_dense_scan"]

_SENTINEL = 2**31 - 1


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
                        points: torch.Tensor, with_occupancy: bool = False):
    """Points → canvas [B, ny, nx, C] (+ occupancy [B, ny, nx]).

    The canvas keeps the JAX package's NHWC layout; the occupancy map is
    the emission flag carried as one extra scatter channel. A PFN in eval
    mode folds its BN from running stats and records no autograd graph; in
    train mode (one PFN layer) the BN uses batch statistics, updates the
    running stats as flax does, and the canvas is differentiable in the
    PFN's weight and BN affine."""
    if len(pfn.pfn_layers) > 2:
        raise NotImplementedError(
            "the port's pillar canvas takes 1-2 PFN layers")
    if pfn.training:
        return _canvas_train(voxelizer, pfn, middle_encoder, points,
                             with_occupancy)
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
    """Port of _fused_pillar_canvas_pallas_train: K3 → batch-stat-folded
    K1 → K2, with K4 and K5 as the backward."""
    if len(pfn.pfn_layers) != 1:
        raise NotImplementedError(
            "the train-mode fused PFN takes one PFN layer; two arrive with "
            "CenterPoint-pillars training (ROADMAP.md, queue 1, item 6b)")
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
