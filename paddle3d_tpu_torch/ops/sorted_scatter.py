"""Sorted-key segment sum: the sparse → dense placement of the pillar canvas,
and its VJP.

Port of paddle3d_tpu/ops/pallas/sorted_scatter.py: sorted_segment_sum and
sorted_segment_sum_split (TPU kernels `_kernel`, K2, for sparse scans and
`_kernel_bs`, K7, for dense ones, chosen by the JAX package's density rule
`is_dense_scan`) with their custom VJP, the sorted table gather (TPU kernel
`_kernel_tg`, K5), and sorted_segment_sum_cm, the channel-major eval twin
of the segment sum (TPU kernels `_kernel_cm` and `_kernel_cmg`, K6), and
sorted_segment_sum_rw, the row-window form of that eval twin for c | 128
(TPU kernel `_kernel_rw`, K13, which no path of the JAX package reaches: an
op here, on K6's kernel). On a CUDA tensor `scatter_rows`, `sorted_table_gather`,
`sorted_segment_sum_cm` and `sorted_segment_sum_rw` launch the hand-written
kernels in csrc/sorted_scatter.cu (whose header says what bounds them and
how they are built); on a CPU tensor they take the plain PyTorch versions
beside them. sorted_segment_sum and sorted_segment_sum_split are one
torch.autograd.Function over K2 or K7 and K5.
"""
import torch

from . import _build

__all__ = ["sorted_segment_sum", "sorted_segment_sum_split",
           "sorted_segment_sum_plain", "scatter_rows", "scatter_rows_plain",
           "sorted_table_gather", "sorted_table_gather_plain",
           "sorted_segment_sum_cm", "sorted_segment_sum_cm_plain",
           "sorted_segment_sum_rw", "sorted_segment_sum_rw_plain",
           "pick_cells_per_block", "is_dense_scan", "kernel_for", "CAP"]

#: rows of the TPU kernels' DMA window (paddle3d_tpu/ops/pallas/
#: sorted_scatter.py:_CAP); a scan averaging more than two windows of rows
#: per cell block is dense (is_dense_scan)
CAP = 128

_BLOCK_CANDIDATES = (1024, 896, 864, 768, 640, 512, 448, 384, 256, 128)


def pick_cells_per_block(num_cells: int) -> int:
    """The TPU kernels' cells per block: the first candidate that divides
    num_cells, else 512 (a copy of the JAX package's rule, which decides
    whether a scan is dense)."""
    for c in _BLOCK_CANDIDATES:
        if num_cells % c == 0:
            return c
    return 512


def is_dense_scan(n: int, num_cells: int) -> bool:
    """The JAX package's density rule (_sorted_segment_sum_impl,
    _fused_pillar_canvas_pallas): a scan of n rows is dense when its rows
    average more than two TPU DMA windows per cell block."""
    nblocks = -(-num_cells // pick_cells_per_block(num_cells))
    return -(-n // max(nblocks, 1)) > 2 * CAP


def kernel_for(n: int, num_cells: int) -> str:
    """The row-major kernel a CUDA scan of n rows onto num_cells cells
    launches (its LAUNCHES name): K7 for a dense scan, K2 for a sparse
    one, as the JAX package's _sorted_segment_sum_impl picks them."""
    return ("sorted_segment_sum_dense" if is_dense_scan(n, num_cells)
            else "sorted_segment_sum")


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


def scatter_rows_plain(keys, rows, num_cells: int, split: bool):
    out = sorted_segment_sum_plain(keys, rows, num_cells)
    return (out[..., :-1], out[..., -1:]) if split else out


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
    name = kernel_for(n, num_cells)
    err = _build.function("p3d_" + name)(
        keys.data_ptr(), rows.data_ptr(), out.data_ptr(),
        extra.data_ptr() if split else None, b, n, c, num_cells,
        _build.stream_ptr(keys.device))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return (out, extra) if split else out


def scatter_rows(keys, rows, num_cells: int, split: bool):
    """The forward without autograd: on a CUDA tensor K7 for a dense scan
    (is_dense_scan) and K2 for a sparse one, on a CPU tensor their plain
    version. -> table [B, cells, C], or (table [B, cells, C-1], last
    channel [B, cells, 1]) when split."""
    if not keys.is_cuda:
        return scatter_rows_plain(keys, rows, num_cells, split)
    return _launch(keys, rows, num_cells, split)


def sorted_table_gather_plain(keys, g, g_extra, num_cells: int, c: int):
    """Plain version of K5: a torch.gather of the table rows the keys name,
    zero where a key lies outside [0, num_cells)."""
    inside = (keys >= 0) & (keys < num_cells)
    safe = torch.where(inside, keys, 0).long()
    parts = [torch.gather(g, 1, safe[..., None].expand(-1, -1, g.shape[-1]))]
    if c > g.shape[-1]:
        parts.append(torch.zeros_like(parts[0][..., :1]) if g_extra is None
                     else torch.gather(g_extra, 1, safe[..., None]))
    rows = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
    return torch.where(inside[..., None], rows, 0.)


def sorted_table_gather(keys, g, g_extra, num_cells: int, c: int):
    """grad_rows [B, N, c] = [g | g_extra][b, keys[b, i]] (the scatter's
    VJP), zero where a key lies outside [0, num_cells).

    g [B, cells, c_main] with c_main = c or c - 1; g_extra [B, cells, 1]
    carries channel c - 1 in the split form, None for a zero cotangent.
    Both may be strided views."""
    if not keys.is_cuda:
        return sorted_table_gather_plain(keys, g, g_extra, num_cells, c)
    b, n = keys.shape
    c_main = g.shape[-1]
    if keys.dtype != torch.int32 or g.dtype != torch.float32 or (
            g_extra is not None and g_extra.dtype != torch.float32):
        raise TypeError("sorted_table_gather kernel takes int32 keys and "
                        "an f32 cotangent")
    if g.shape[:2] != (b, num_cells) or c_main not in (c, c - 1) or (
            g_extra is not None and g_extra.shape != (b, num_cells, 1)):
        raise ValueError("cotangent shapes {} / {} do not fit keys {} and "
                         "{} cells".format(
                             tuple(g.shape), None if g_extra is None else
                             tuple(g_extra.shape), tuple(keys.shape),
                             num_cells))
    if not keys.is_contiguous() or any(
            t is not None and t.device != keys.device for t in (g, g_extra)):
        raise ValueError("sorted_table_gather needs contiguous keys and "
                         "tensors on one device")
    out = torch.empty((b, n, c), dtype=torch.float32, device=keys.device)
    es = g_extra.stride()[:2] if g_extra is not None else (0, 0)
    err = _build.function("p3d_sorted_table_gather")(
        keys.data_ptr(), g.data_ptr(), *g.stride(),
        g_extra.data_ptr() if g_extra is not None else None, *es,
        out.data_ptr(), b, n, c, c_main, num_cells,
        _build.stream_ptr(keys.device))
    _build.check(err, "sorted_table_gather")
    _build.LAUNCHES["sorted_table_gather"] += 1
    return out


class _SortedSegmentSum(torch.autograd.Function):
    """rows -> table, with the table gather as its VJP; the keys get no
    gradient. In the split form the last channel's cotangent may be None
    (the occupancy feeds only a mask): it then gives zero rows."""

    @staticmethod
    def forward(ctx, keys, rows, num_cells, split):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(keys)
        ctx.num_cells, ctx.c = num_cells, rows.shape[-1]
        return scatter_rows(keys, rows, num_cells, split)

    @staticmethod
    def backward(ctx, g, g_extra=None):
        keys, = ctx.saved_tensors
        if g is None:
            if g_extra is None:
                return None, None, None, None
            b, cells = g_extra.shape[:2]
            g = g_extra.new_zeros((b, cells, ctx.c - 1))
        return (None, sorted_table_gather(keys, g, g_extra, ctx.num_cells,
                                          ctx.c), None, None)


def sorted_segment_sum(keys: torch.Tensor, rows: torch.Tensor,
                       num_cells: int) -> torch.Tensor:
    """out[b, c] = Σ_{i: keys[b,i]==c} rows[b,i]   for c in [0, num_cells).

    keys: [B, N] int32, sorted ascending per batch row; keys outside
    [0, num_cells) are dropped. rows: [B, N, C]. Returns [B, num_cells, C].
    Differentiable in rows."""
    return _SortedSegmentSum.apply(keys, rows, num_cells, False)


def sorted_segment_sum_split(keys: torch.Tensor, rows: torch.Tensor,
                             num_cells: int):
    """Like sorted_segment_sum, but the LAST channel comes back as its own
    [B, num_cells, 1] tensor (the canvas's occupancy side channel)."""
    return _SortedSegmentSum.apply(keys, rows, num_cells, True)


def sorted_segment_sum_cm_plain(keys, rows_cm, num_cells: int, c=None,
                                split_last: bool = False):
    """Plain version of K6: the first c channels and N columns of rows_cm,
    transposed, through sorted_segment_sum_plain."""
    c = rows_cm.shape[1] if c is None else c
    rows = rows_cm[:, :c, :keys.shape[1]].transpose(1, 2)
    return scatter_rows_plain(keys, rows, num_cells, split_last)


def sorted_segment_sum_cm(keys: torch.Tensor, rows_cm: torch.Tensor,
                          num_cells: int, c: int = None,
                          split_last: bool = False):
    """out[b, cell] = Σ_{i < N: keys[b,i]==cell} rows_cm[b, :c, i]: the
    channel-major twin of sorted_segment_sum, for eval (no VJP, as in the
    JAX package).

    keys: [B, N] int32, sorted ascending per batch row; keys outside
    [0, num_cells) are dropped. rows_cm: [B, C', N'] f32 with C' >= c and
    N' >= N, possibly a strided view: only the first c channels (all when c
    is None) and N columns are read. Returns [B, num_cells, c], or
    ([B, num_cells, c - 1], [B, num_cells, 1]) when split_last."""
    c = rows_cm.shape[1] if c is None else c
    if not keys.is_cuda:
        return sorted_segment_sum_cm_plain(keys, rows_cm, num_cells, c,
                                           split_last)
    b, n = keys.shape
    if keys.dtype != torch.int32 or rows_cm.dtype != torch.float32:
        raise TypeError("sorted_segment_sum_cm kernel takes int32 keys and "
                        "f32 rows, got {} and {}".format(keys.dtype,
                                                         rows_cm.dtype))
    if rows_cm.dim() != 3 or rows_cm.shape[0] != b or not (
            1 <= c <= rows_cm.shape[1]) or rows_cm.shape[2] < n or (
                split_last and c < 2):
        raise ValueError("keys [B, N] and rows [B, C' >= c, N' >= N] "
                         "expected, got {} and {} with c={}{}".format(
                             tuple(keys.shape), tuple(rows_cm.shape), c,
                             " (split needs c >= 2)" if split_last else ""))
    if rows_cm.device != keys.device or not keys.is_contiguous():
        raise ValueError("sorted_segment_sum_cm needs contiguous keys and "
                         "rows on the same device")
    out = torch.empty((b, num_cells, c - 1 if split_last else c),
                      dtype=torch.float32, device=keys.device)
    extra = (torch.empty((b, num_cells, 1), dtype=torch.float32,
                         device=keys.device) if split_last else None)
    err = _build.function("p3d_sorted_segment_sum_cm")(
        keys.data_ptr(), rows_cm.data_ptr(), *rows_cm.stride(),
        out.data_ptr(), extra.data_ptr() if split_last else None, b, n, c,
        num_cells, _build.stream_ptr(keys.device))
    _build.check(err, "sorted_segment_sum_cm")
    _build.LAUNCHES["sorted_segment_sum_cm"] += 1
    return (out, extra) if split_last else out


def _check_rw(c: int):
    if c < 1 or 128 % c != 0:
        raise ValueError(
            "the row-window segment sum takes c dividing 128 (the JAX "
            "kernel's flat-lane canvas), got c={}; sorted_segment_sum_cm "
            "takes any c".format(c))


def sorted_segment_sum_rw_plain(keys, rows_cm, c: int,
                                num_cells: int) -> torch.Tensor:
    """Plain version of K13: each cell's rows added one at a time in row
    order (rank j of every segment in pass j, one row a cell a pass), as
    the kernel adds them, so the two agree bit for bit on the card; on the
    CPU it equals sorted_segment_sum_plain, whose index_add_ runs in row
    order there."""
    _check_rw(c)
    b, n = keys.shape
    rows = rows_cm[:, :c, :n].transpose(1, 2)
    k = keys.long()
    inside = (k >= 0) & (k < num_cells)
    rank = torch.arange(n, device=k.device) - torch.searchsorted(k, k)
    out = torch.zeros((b, num_cells, c), dtype=rows.dtype,
                      device=rows.device)
    batch = torch.arange(b, device=k.device)[:, None].expand(b, n)
    for j in range(int(rank[inside].max()) + 1 if bool(inside.any()) else 0):
        m = inside & (rank == j)
        out[batch[m], k[m]] += rows[m]
    return out


def sorted_segment_sum_rw(keys: torch.Tensor, rows_cm: torch.Tensor, c: int,
                          num_cells: int) -> torch.Tensor:
    """out[b, cell] = Σ_{i < N: keys[b,i]==cell} rows_cm[b, :c, i], the
    function of sorted_segment_sum_cm for c dividing 128 (the port of the
    JAX package's _sorted_segment_sum_rw, argument order kept, whose TPU
    kernel walks fixed windows of sorted rows); on the card it launches
    sorted_segment_sum_cm's kernel, counted here. No VJP, as there.

    keys: [B, N] int32, sorted ascending per batch row; keys outside
    [0, num_cells) are dropped. rows_cm: [B, C', N'] f32 with C' >= c and
    N' >= N (a longer, already padded producer buffer is taken as it is),
    possibly a strided view. Returns [B, num_cells, c]; a batch row with no
    valid key gives zeros. Raises ValueError when 128 % c != 0."""
    _check_rw(c)
    if not keys.is_cuda:
        return sorted_segment_sum_rw_plain(keys, rows_cm, c, num_cells)
    b, n = keys.shape
    if keys.dtype != torch.int32 or rows_cm.dtype != torch.float32:
        raise TypeError("sorted_segment_sum_rw kernel takes int32 keys and "
                        "f32 rows, got {} and {}".format(keys.dtype,
                                                         rows_cm.dtype))
    if rows_cm.dim() != 3 or rows_cm.shape[0] != b or \
            rows_cm.shape[1] < c or rows_cm.shape[2] < n:
        raise ValueError("keys [B, N] and rows [B, C' >= c, N' >= N] "
                         "expected, got {} and {} with c={}".format(
                             tuple(keys.shape), tuple(rows_cm.shape), c))
    if rows_cm.device != keys.device or not keys.is_contiguous():
        raise ValueError("sorted_segment_sum_rw needs contiguous keys and "
                         "rows on the same device")
    out = torch.empty((b, num_cells, c), dtype=torch.float32,
                      device=keys.device)
    err = _build.function("p3d_sorted_segment_sum_rw")(
        keys.data_ptr(), rows_cm.data_ptr(), *rows_cm.stride(),
        out.data_ptr(), b, n, c, num_cells, _build.stream_ptr(keys.device))
    _build.check(err, "sorted_segment_sum_rw")
    _build.LAUNCHES["sorted_segment_sum_rw"] += 1
    return out
