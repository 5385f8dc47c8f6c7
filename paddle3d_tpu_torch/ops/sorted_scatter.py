"""Sorted-key segment sum: the sparse → dense placement of the pillar canvas.

Port of paddle3d_tpu/ops/pallas/sorted_scatter.py (sorted_segment_sum and
sorted_segment_sum_split, whose TPU kernel is `_kernel`). On a CUDA tensor
the wrappers launch the hand-written kernel in csrc/sorted_scatter.cu
(whose header says what bounds it and how it is built); on a CPU tensor
they take the plain PyTorch version beside it.
"""
import torch

from . import _build

__all__ = ["sorted_segment_sum", "sorted_segment_sum_split",
           "sorted_segment_sum_plain"]


def sorted_segment_sum_plain(keys: torch.Tensor, rows: torch.Tensor,
                             num_cells: int) -> torch.Tensor:
    """Plain version: index_add_ over clamped keys (keys outside
    [0, num_cells) land in a spill cell that is sliced away)."""
    b, n = keys.shape
    c = rows.shape[-1]
    inside = (keys >= 0) & (keys < num_cells)
    tgt = torch.where(inside, keys, num_cells).long()
    tgt = tgt + torch.arange(b, device=keys.device)[:, None] * (num_cells + 1)
    acc = torch.zeros(b * (num_cells + 1), c, dtype=rows.dtype,
                      device=rows.device)
    acc.index_add_(0, tgt.reshape(-1), rows.reshape(b * n, c))
    return acc.view(b, num_cells + 1, c)[:, :num_cells]


def _launch(keys, rows, num_cells, split):
    if keys.dtype != torch.int32 or rows.dtype != torch.float32:
        raise TypeError("sorted_segment_sum kernel takes int32 keys and f32 "
                        "rows, got {} and {}".format(keys.dtype, rows.dtype))
    if keys.dim() != 2 or rows.dim() != 3 or rows.shape[:2] != keys.shape:
        raise ValueError("keys [B, N] and rows [B, N, C] expected, got {} "
                         "and {}".format(tuple(keys.shape),
                                         tuple(rows.shape)))
    if rows.device != keys.device:
        raise ValueError("keys and rows lie on different devices")
    if not (keys.is_contiguous() and rows.is_contiguous()):
        raise ValueError("sorted_segment_sum kernel needs contiguous inputs")
    b, n, c = rows.shape
    if split and c < 2:
        raise ValueError("split_last needs at least two channels")
    out = torch.empty((b, num_cells, c - 1 if split else c),
                      dtype=rows.dtype, device=rows.device)
    extra = (torch.empty((b, num_cells, 1), dtype=rows.dtype,
                         device=rows.device) if split else None)
    lib = _build.library()
    err = lib.p3d_sorted_segment_sum(
        keys.data_ptr(), rows.data_ptr(), out.data_ptr(),
        extra.data_ptr() if split else None, b, n, c, num_cells,
        _build.stream_ptr(keys.device))
    _build.check(err, "sorted_segment_sum")
    _build.LAUNCHES["sorted_segment_sum"] += 1
    return (out, extra) if split else out


def sorted_segment_sum(keys: torch.Tensor, rows: torch.Tensor,
                       num_cells: int) -> torch.Tensor:
    """out[b, c] = Σ_{i: keys[b,i]==c} rows[b,i]   for c in [0, num_cells).

    keys: [B, N] int32, sorted ascending per batch row; keys outside
    [0, num_cells) are dropped. rows: [B, N, C]. Returns [B, num_cells, C].
    """
    if not keys.is_cuda:
        return sorted_segment_sum_plain(keys, rows, num_cells)
    return _launch(keys, rows, num_cells, split=False)


def sorted_segment_sum_split(keys: torch.Tensor, rows: torch.Tensor,
                             num_cells: int):
    """Like sorted_segment_sum, but the LAST channel comes back as its own
    [B, num_cells, 1] tensor (the canvas's occupancy side channel)."""
    if not keys.is_cuda:
        out = sorted_segment_sum_plain(keys, rows, num_cells)
        return out[..., :-1], out[..., -1:]
    return _launch(keys, rows, num_cells, split=True)
