"""Bounded segmented window max with its arg-max offsets, and its VJP.

Port of paddle3d_tpu/ops/pallas/seg_window.py:seg_window_max (TPU kernels
`_fwd_kernel` and `_bwd_kernel`, K12). Every row of `vals` [B, N, C]
receives the max over the rows of its segment (equal sorted key) within the
centred window of win = 2^ceil(log2 max_len) - 1 rows on each side, and
the offset of the row it came from; the VJP routes each row's cotangent to
that row:

    g_in[j] = sum_s [off[j + s] == -s] * g[j + s],   |s| <= win.

The offsets follow the Pallas kernel's merge order (a doubling pass per
step over one snapshot: the row below wins on strictly greater, then the
row above on strictly greater than that), so they equal its offsets index
for index, ties included: a different winner on a tie would be a different
gradient. The JAX package's XLA form (ops/segmented.seg_window_max_bounded)
gives the same values; under jax.grad its `maximum` splits a tied
cotangent where this routes it to one row.

On a CUDA tensor `seg_window_max_fwd` and `seg_window_max_bwd` launch the
hand-written kernels in csrc/seg_window.cu (whose header says what bounds
them); on a CPU tensor they take the plain PyTorch versions beside them.
`seg_window_max` is one torch.autograd.Function over the two; it saves the
keys for the backward, whose kernel probes only each row's own segment,
and they get no gradient.
"""
import torch

from . import _build

__all__ = ["seg_window_max", "seg_window_max_fwd", "seg_window_max_bwd",
           "seg_window_max_plain", "seg_window_max_bwd_plain", "window_of"]

_INVALID = -3      # key of rows outside the array: callers' keys are >= -2
_MAX_WIN = 127     # int8 offsets (csrc/seg_window.cu)


def _steps_for(max_len: int) -> int:
    k = 0
    while (1 << k) < max_len:
        k += 1
    return k


def window_of(max_len: int) -> int:
    """Rows on each side of the centred window: 2^ceil(log2 max_len) - 1."""
    return (1 << _steps_for(max_len)) - 1


def _dn(x, d, fill):
    """x shifted along dim 1 so row j reads row j - d (fill outside)."""
    if d >= x.shape[1]:
        return torch.full_like(x, fill)
    return torch.cat([torch.full_like(x[:, :d], fill), x[:, :-d]], dim=1)


def _up(x, d, fill):
    """x shifted along dim 1 so row j reads row j + d (fill outside)."""
    if d >= x.shape[1]:
        return torch.full_like(x, fill)
    return torch.cat([x[:, d:], torch.full_like(x[:, :d], fill)], dim=1)


def seg_window_max_plain(vals: torch.Tensor, keys: torch.Tensor,
                         max_len: int):
    """Plain version of the forward kernel -> (out [B, N, C], off [B, N, C]
    int8): the doubling with offsets, in _fwd_kernel's merge order."""
    neg = -float("inf")
    best = vals
    off = torch.zeros(vals.shape, dtype=torch.int32, device=vals.device)
    for s in range(_steps_for(max_len)):
        d = 1 << s
        same_dn = (_dn(keys, d, _INVALID) == keys)[..., None]
        same_up = (_up(keys, d, _INVALID) == keys)[..., None]
        cand_dn = torch.where(same_dn, _dn(best, d, neg), neg)
        cand_up = torch.where(same_up, _up(best, d, neg), neg)
        off_dn, off_up = _dn(off, d, 0) - d, _up(off, d, 0) + d
        take_dn = cand_dn > best
        best = torch.where(take_dn, cand_dn, best)
        take_up = cand_up > best
        off = torch.where(take_up, off_up, torch.where(take_dn, off_dn, off))
        best = torch.where(take_up, cand_up, best)
    return best, off.to(torch.int8)


def seg_window_max_bwd_plain(off: torch.Tensor, g: torch.Tensor,
                             max_len: int) -> torch.Tensor:
    """Plain version of the backward kernel: each row sums the cotangents
    of the rows whose offset points at it, in _bwd_kernel's order (itself,
    then for s = 1..win the row s below, then the row s above)."""
    acc = torch.where(off == 0, g, 0.)
    for s in range(1, window_of(max_len) + 1):
        acc = acc + torch.where(_up(off, s, 0) == -s, _up(g, s, 0.), 0.)
        acc = acc + torch.where(_dn(off, s, 0) == s, _dn(g, s, 0.), 0.)
    return acc


def _check(name, tensors, dtypes, shape):
    if any(t.dtype != dt for t, dt in zip(tensors, dtypes)):
        raise TypeError("{} kernel takes {}, got {}".format(
            name, [str(dt) for dt in dtypes], [str(t.dtype) for t in tensors]))
    if tensors[0].dim() != 3 or tuple(tensors[1].shape) != shape:
        raise ValueError("{}: [B, N, C] tensors expected, got {}".format(
            name, [tuple(t.shape) for t in tensors]))
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError("{} inputs lie on different devices".format(name))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("{} kernel needs contiguous inputs".format(name))


def _rows_apart(g: torch.Tensor) -> int:
    """Elements between g's rows where the kernel can read g [B, N, C] in
    place (channels contiguous, rows evenly spaced: the slice of a
    concatenation's gradient), else 0."""
    b, n, c = g.shape
    ld = g.stride(1)
    if g.stride(2) == 1 and ld >= c and (b == 1 or g.stride(0) == n * ld):
        return ld
    return 0


def seg_window_max_fwd(vals: torch.Tensor, keys: torch.Tensor, max_len: int):
    """vals [B, N, C] f32, keys [B, N] int32 sorted per batch row (>= -2)
    -> (window max [B, N, C] f32, arg-max offsets [B, N, C] int8)."""
    if not vals.is_cuda:
        return seg_window_max_plain(vals, keys, max_len)
    b, n, c = vals.shape
    _check("seg_window_max", (vals, keys), (torch.float32, torch.int32),
           (b, n))
    win = window_of(max_len)
    if win > _MAX_WIN:
        raise ValueError("seg_window_max: a window of {} rows does not fit "
                         "int8 offsets (max_len <= 128)".format(win))
    out = torch.empty_like(vals)
    off = torch.empty(vals.shape, dtype=torch.int8, device=vals.device)
    err = _build.function("p3d_seg_window_max")(
        vals.data_ptr(), keys.data_ptr(), out.data_ptr(), off.data_ptr(), b,
        n, c, _steps_for(max_len), _build.stream_ptr(vals.device))
    _build.check(err, "seg_window_max")
    _build.LAUNCHES["seg_window_max"] += 1
    return out, off


def seg_window_max_bwd(off: torch.Tensor, g: torch.Tensor, max_len: int,
                       keys: torch.Tensor) -> torch.Tensor:
    """off [B, N, C] int8 from the forward on the same keys [B, N] int32,
    g [B, N, C] f32 the cotangent of its output -> the cotangent of its
    input [B, N, C]. The kernel probes only each row's own segment of the
    keys (an offset never points out of it); offsets from other keys give
    another result than the plain version. It reads g in place where g's
    rows are evenly spaced with contiguous channels, as the two-layer
    canvas hands it a slice of its concatenation's gradient."""
    if not g.is_cuda:
        return seg_window_max_bwd_plain(off, g, max_len)
    _check("seg_window_max_bwd", (off, keys), (torch.int8, torch.int32),
           tuple(off.shape[:2]))
    b, n, c = off.shape
    if g.dtype != torch.float32:
        raise TypeError("seg_window_max_bwd kernel takes an f32 cotangent, "
                        "got {}".format(g.dtype))
    if tuple(g.shape) != (b, n, c) or g.device != off.device:
        raise ValueError("seg_window_max_bwd: a cotangent {} on {} expected, "
                         "got {} on {}".format((b, n, c), off.device,
                                               tuple(g.shape), g.device))
    ld = _rows_apart(g)
    if ld == 0:
        g = g.contiguous()
        ld = c
    win = window_of(max_len)
    if win > _MAX_WIN:
        raise ValueError("seg_window_max_bwd: max_len <= 128")
    out = torch.empty(off.shape, dtype=torch.float32, device=off.device)
    err = _build.function("p3d_seg_window_max_bwd")(
        off.data_ptr(), g.data_ptr(), keys.data_ptr(), out.data_ptr(), b, n,
        c, ld, win, _build.stream_ptr(g.device))
    _build.check(err, "seg_window_max_bwd")
    _build.LAUNCHES["seg_window_max_bwd"] += 1
    return out


class _SegWindowMax(torch.autograd.Function):

    @staticmethod
    def forward(ctx, vals, keys, max_len):
        out, off = seg_window_max_fwd(vals, keys, max_len)
        ctx.save_for_backward(off, keys)
        ctx.max_len = max_len
        return out

    @staticmethod
    def backward(ctx, g):
        off, keys = ctx.saved_tensors
        return seg_window_max_bwd(off, g, ctx.max_len, keys), None, None


def seg_window_max(vals: torch.Tensor, keys: torch.Tensor,
                   max_len: int) -> torch.Tensor:
    """Per row, the same-key max within the centred window of
    window_of(max_len) rows each side (clipped to the array), differentiable
    in vals. vals [B, N, C] f32; keys [B, N] int32 sorted ascending per
    batch row, >= -2."""
    return _SegWindowMax.apply(vals, keys, max_len)
