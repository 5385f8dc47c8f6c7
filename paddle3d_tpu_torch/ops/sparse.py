"""Sparse 3-D convolution building blocks: a sorted-key coordinate table,
neighbour lookup, gather, and the strided output active set.

Port of paddle3d_tpu/ops/sparse.py (the whole file), per sample as there
or with leading batch dims written out: active voxels live in
fixed-capacity arrays (coords [V, 3] (z, y, x),
features [V, C], mask [V]), a sorted linear-key table answers neighbour
lookups with a binary search (torch.searchsorted), a submanifold conv is a
gather of the K^3 neighbours and one product with the flattened kernel
[K^3 * Cin, Cout], and a strided conv first derives its output active set
by a sort-unique with a fixed capacity. Plain PyTorch; the plain version
of the port's sparse conv kernel (ops/sparse_conv.py) looks its neighbours
up with lookup_coords, and training runs the gather route under autograd,
as the JAX package trains it.
"""
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["build_coord_table", "lookup_coords", "subm_conv3d_gather",
           "downsample_coords", "sparse_gather_neighbors", "kernel_offsets"]


def _linear_key(coords: torch.Tensor, grid: Sequence[int]) -> torch.Tensor:
    """(z, y, x) int coords [..., 3] -> linear key; grid = (D, H, W)."""
    _, h, w = grid
    return (coords[..., 0] * (h * w) + coords[..., 1] * w +
            coords[..., 2]).to(torch.int32)


def build_coord_table(coords: torch.Tensor, mask: torch.Tensor,
                      grid: Sequence[int]):
    """-> (sorted_keys [V], sorted_idx [V]); invalid rows get a sentinel
    key that sorts last and can never be matched."""
    d, h, w = grid
    keys = torch.where(mask, _linear_key(coords, grid), d * h * w + 1)
    sorted_keys, order = torch.sort(keys, stable=True)
    return sorted_keys, order.to(torch.int32)


def lookup_coords(sorted_keys: torch.Tensor, sorted_idx: torch.Tensor,
                  query_coords: torch.Tensor, query_valid: torch.Tensor,
                  grid: Sequence[int]) -> torch.Tensor:
    """The row index of each query (z, y, x) [..., Q, 3], or -1, from a
    table sorted_keys / sorted_idx [..., V] (leading dims alike: one table
    per sample of a batch)."""
    d, h, w = grid
    in_grid = ((query_coords >= 0).all(dim=-1)
               & (query_coords[..., 0] < d) & (query_coords[..., 1] < h)
               & (query_coords[..., 2] < w))
    qkeys = _linear_key(query_coords.clamp(min=0), grid)
    pos = torch.searchsorted(sorted_keys, qkeys)
    pos = pos.clamp(0, sorted_keys.shape[-1] - 1)
    hit = (torch.gather(sorted_keys, -1, pos) == qkeys) & in_grid & \
        query_valid
    return torch.where(hit, torch.gather(sorted_idx, -1, pos), -1)


def kernel_offsets(kernel_size: int) -> np.ndarray:
    """[K^3, 3] (dz, dy, dx) offsets in the flattened kernel's row order:
    tap kidx = (dz + r) * K^2 + (dy + r) * K + (dx + r), r = (K - 1) // 2."""
    k = kernel_size
    r = np.arange(k) - (k - 1) // 2
    zz, yy, xx = np.meshgrid(r, r, r, indexing="ij")
    return np.stack([zz, yy, xx], axis=-1).reshape(-1, 3)


def _stride3(stride) -> Tuple[int, int, int]:
    return tuple(stride) if isinstance(stride, (tuple, list)) \
        else (stride,) * 3


def sparse_gather_neighbors(features: torch.Tensor, coords: torch.Tensor,
                            mask: torch.Tensor, out_coords: torch.Tensor,
                            out_mask: torch.Tensor, kernel_size: int,
                            grid: Tuple[int, int, int],
                            stride=1) -> torch.Tensor:
    """Gather [..., Vout, K^3, C] neighbour features for each output site
    (leading dims alike on every input: one table per sample).

    Output site o with coord c reads input coords c * stride + offset
    (stride may be per-axis (sz, sy, sx)). Missing neighbours contribute
    zeros. Differentiable in `features` (a row gather)."""
    lead, (v, c) = features.shape[:-2], features.shape[-2:]
    v_out = out_coords.shape[-2]
    offsets = torch.as_tensor(kernel_offsets(kernel_size), dtype=torch.int32,
                              device=coords.device)
    kk = offsets.shape[0]
    sorted_keys, sorted_idx = build_coord_table(coords, mask, grid)
    stride_v = torch.tensor(_stride3(stride), dtype=torch.int32,
                            device=coords.device)
    query = (out_coords * stride_v)[..., :, None, :] + offsets
    qvalid = out_mask[..., :, None].expand(out_mask.shape + (kk,))
    nbr = lookup_coords(sorted_keys, sorted_idx,
                        query.reshape(lead + (v_out * kk, 3)),
                        qvalid.reshape(lead + (v_out * kk,)), grid)
    nbr = nbr.reshape(lead + (v_out, kk))
    # one row gather over the flattened batch (row nbr of sample s is
    # s * V + nbr): index_select, whose backward adds the K^3 neighbours'
    # cotangents with index_add_; autograd's backward of advanced indexing
    # sorts the indices first, and took 0.35 s a train step at the KITTI
    # voxel widths on an H100
    samples = features.reshape(-1, v, c).shape[0]
    base = (torch.arange(samples, device=coords.device) * v).reshape(
        lead + (1, 1))
    rows = (nbr.clamp(min=0).long() + base).reshape(-1)
    gathered = torch.index_select(features.reshape(-1, c), 0, rows).reshape(
        lead + (v_out, kk, c))
    return torch.where((nbr >= 0)[..., None], gathered, 0.)


def subm_conv3d_gather(features: torch.Tensor, coords: torch.Tensor,
                       mask: torch.Tensor, weights: torch.Tensor,
                       grid: Tuple[int, int, int]) -> torch.Tensor:
    """Submanifold conv: output on the SAME active set, [..., V, Cout]
    (leading dims as sparse_gather_neighbors).

    weights: [K^3 * Cin, Cout] (flattened kernel)."""
    k3 = weights.shape[0] // features.shape[-1]
    kernel_size = round(k3 ** (1 / 3))
    gathered = sparse_gather_neighbors(features, coords, mask, coords, mask,
                                       kernel_size, grid, stride=1)
    out = gathered.flatten(-2) @ weights
    return torch.where(mask[..., None], out, 0.).to(features.dtype)


def downsample_coords(coords: torch.Tensor, mask: torch.Tensor,
                      grid: Tuple[int, int, int], stride,
                      out_capacity: int):
    """Strided output active set of a batch: unique(coords // stride) per
    sample with a fixed capacity, by a sort, as the JAX package computes it
    per sample. `stride` may be an int or a per-axis (sz, sy, sx) tuple.

    coords [B, V, 3], mask [B, V] -> (out_coords [B, out_capacity, 3],
    out_mask [B, out_capacity]). The first out_capacity unique keys in
    ascending order are kept. The internal sentinel is od * oh * ow + 1: a
    real key equal to it counts as empty, as in the JAX package."""
    d, h, w = grid
    sz, sy, sx = _stride3(stride)
    od, oh, ow = max(d // sz, 1), h // sy, w // sx
    down = torch.div(coords, torch.tensor((sz, sy, sx), dtype=coords.dtype,
                                          device=coords.device),
                     rounding_mode="floor")
    sentinel = od * oh * ow + 1
    keys = torch.where(mask, down[..., 0] * (oh * ow) + down[..., 1] * ow +
                       down[..., 2], sentinel).to(torch.int32)
    skey, _ = torch.sort(keys, dim=1)
    first = torch.ones_like(skey[:, :1], dtype=torch.bool)
    head = torch.cat([first, skey[:, 1:] != skey[:, :-1]], dim=1) & (
        skey != sentinel)
    uid = torch.cumsum(head.to(torch.int32), dim=1) - 1
    slot = torch.where(head & (uid < out_capacity), uid, out_capacity)
    out_key = torch.full((skey.shape[0], out_capacity + 1), sentinel,
                         dtype=torch.int32, device=skey.device)
    # every kept key has its own slot; the rest land in the spill slot
    out_key = out_key.scatter(1, slot.long(), skey)[:, :-1]
    n_out = head.sum(dim=1).clamp(max=out_capacity)
    out_mask = torch.arange(out_capacity, device=skey.device)[None] < \
        n_out[:, None]
    safe = torch.where(out_mask, out_key, 0)
    oz = torch.div(safe, oh * ow, rounding_mode="floor")
    rem = safe - oz * (oh * ow)
    oy = torch.div(rem, ow, rounding_mode="floor")
    ox = rem - oy * ow
    out_coords = torch.stack([oz, oy, ox], dim=-1).to(torch.int32)
    out_coords = torch.where(out_mask[..., None], out_coords, 0)
    return out_coords, out_mask
