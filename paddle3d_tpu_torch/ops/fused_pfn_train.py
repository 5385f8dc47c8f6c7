"""Train-mode fused pillar feature net (one PFN layer): batch-statistics
BatchNorm and its full backward around the fused PFN kernel.

Port of paddle3d_tpu/ops/pallas/fused_pfn_train.py:fused_pfn_train_rows.
Forward: K3 (`pfn_stats`) sums [Σz, Σz², count, Σx⊗z, Σx] over the kept
rows (z = W1 x, x the decorated input); the batch mean and variance divide
by M = B·N, the masked rows counting as zeros as in the JAX package; the BN
folds into w_eff = W1·a, c = β − μ·a with a = γ / sqrt(σ² + eps); the eval
kernel K1 (ops/fused_pfn.py) runs with them. Backward: K4 (`pfn_bwd`)
recomputes t = a·z + c, routes each pillar's emission-row cotangent to its
first argmax row per channel (gated by t > 0) and sums [Σdt, Σdt·ẑ,
Σx⊗dt]; the dW1 / dγ / dβ formula runs here. The points get no gradient.

On a CUDA tensor `pfn_stats` and `pfn_bwd` launch the hand-written kernels
of csrc/fused_pfn_train.cu (its header says what bounds them and how they
work: a block a span of rows, the max_voxels cap found in the span, f64
sums in registers, one partial a block added in block order by a second
launch); on a CPU tensor they take the plain PyTorch versions beside them.
Both routes sum in an order fixed by the shapes: no float atomics, so two
calls give the same bits. The sums,
and the formula built on them, are f64: it cancels (σ² = s2/M − μ²,
T3 − Sx μᵀ over ~1e5 rows), and f32 sums in two orders left dW1 2.7e-2 of
its largest entry apart on the card. z, t and ẑ stay f32, bit for bit
alike on both routes; the BN statistics go back to f32 for the forward.
"""
import torch

from . import _build, fused_pfn
from .fused_pfn import _decorate_plain, _segment_max, spans

__all__ = ["fused_pfn_train_rows", "pfn_stats", "pfn_stats_plain",
           "pfn_bwd", "pfn_bwd_plain"]

_MAX_U1 = 64        # csrc/fused_pfn_train.cu kMaxU1


def _pre_bn(x, w1t):
    """z = Σ_k x_k w1t[:, k], summed in k order (the kernels' order: the
    two agree bit for bit)."""
    z = x[..., 0:1] * w1t[:, 0]
    for k in range(1, x.shape[-1]):
        z = z + x[..., k:k + 1] * w1t[:, k]
    return z


def pfn_stats_plain(keys, pts_t, w1t, *, P, maxV, nx, vx, vy, x_off, y_off,
                    with_distance=False):
    """Plain version of K3 -> f64 (s1 [u1], s2 [u1], count [],
    t3 [C_dec, u1], sx [C_dec]) over the kept rows."""
    pts = pts_t.transpose(1, 2).to(torch.float32)
    x, keep, _, _, _ = _decorate_plain(keys, pts, P, maxV, nx, vx, vy, x_off,
                                       y_off, with_distance)
    z = _pre_bn(x, w1t).double()           # zero on rows not kept
    x = x.double()
    return (z.sum(dim=(0, 1)), (z * z).sum(dim=(0, 1)),
            keep.sum().double(), torch.einsum("bnk,bnc->kc", x, z),
            x.sum(dim=(0, 1)))


def _check(keys, pts_t, w1t, tensors, name):
    b, c_in, n = pts_t.shape
    u1, c_dec = w1t.shape
    if keys.dtype != torch.int32 or any(t.dtype != torch.float32
                                        for t in tensors):
        raise TypeError("{} kernel takes int32 keys and f32 points, weights "
                        "and statistics".format(name))
    if keys.shape != (b, n) or u1 < c_dec:
        raise ValueError("{}: keys {}, pts_t {}, w1t {}".format(
            name, tuple(keys.shape), tuple(pts_t.shape), tuple(w1t.shape)))
    if any(t.device != keys.device for t in tensors):
        raise ValueError("{} inputs lie on different devices".format(name))
    if not keys.is_contiguous() or not all(t.is_contiguous()
                                           for t in tensors[:2]):
        raise ValueError("{} kernel needs contiguous keys, points and "
                         "weights".format(name))
    if keys.is_cuda and u1 > _MAX_U1:
        raise ValueError("{} kernel: unsupported widths, u1 {} (at most {})"
                         .format(name, u1, _MAX_U1))
    return b, c_in, n, u1, c_dec


def _launch(name, rows, keys, b, n, u1, ptrs, scalars):
    """Launch K3 or K4 into one f64 buffer: the sums [rows, u1], then the
    blocks' partials. -> the sums."""
    nspan = spans(b, n, keys.device)
    buf = torch.empty((nspan * b + 1) * rows * u1, dtype=torch.float64,
                      device=keys.device)
    err = _build.function("p3d_" + name)(
        *ptrs, buf.data_ptr(), nspan, b, n, *scalars,
        _build.stream_ptr(keys.device))
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return buf[:rows * u1].view(rows, u1)


def pfn_stats(keys, pts_t, w1t, *, P, maxV, nx, vx, vy, x_off, y_off,
              with_distance=False):
    """Sums over the kept rows for the train BatchNorm and the dW1 formula.

    keys [B, N] int32 sorted, pts_t [B, C_in, N] f32, w1t [u1, C_dec].
    Returns f64 (s1 = Σz [u1], s2 = Σz² [u1], count of kept rows [],
    t3 = Σx⊗z [C_dec, u1], sx = Σx [C_dec])."""
    kw = dict(P=P, maxV=maxV, nx=nx, vx=vx, vy=vy, x_off=x_off, y_off=y_off,
              with_distance=with_distance)
    b, c_in, n, u1, c_dec = _check(keys, pts_t, w1t, (pts_t, w1t),
                                   "pfn_stats")
    if not keys.is_cuda:
        return pfn_stats_plain(keys, pts_t, w1t, **kw)
    red = _launch("pfn_stats", 4 + c_dec, keys, b, n, u1,
                  (keys.data_ptr(), pts_t.data_ptr(), w1t.data_ptr()),
                  (c_in, c_dec, u1, P, maxV, nx, vx, vy, x_off, y_off,
                   int(with_distance)))
    return (red[0], red[1], red[2, 0], red[3:3 + c_dec],
            red[3 + c_dec, :c_dec])


def pfn_bwd_plain(keys, pts_t, g_t, w1t, a, c, mu, invsig, *, P, maxV, nx,
                  vx, vy, x_off, y_off, with_distance=False):
    """Plain version of K4 -> f64 (sdt [u1], sdtz [u1], t1 [C_dec, u1])."""
    pts = pts_t.transpose(1, 2).to(torch.float32)
    x, keep, _, start, cnt = _decorate_plain(keys, pts, P, maxV, nx, vx, vy,
                                             x_off, y_off, with_distance)
    b, n, u1 = x.shape[0], x.shape[1], w1t.shape[0]
    z = _pre_bn(x, w1t)
    t = z * a + c
    y = torch.relu(t)
    ind = keep[..., None] & (y == _segment_max(y, start, keep))
    # the first argmax row of each (pillar, channel)
    idx = torch.arange(n, device=keys.device)[:, None].expand(n, u1)
    cand = torch.where(ind, idx, n)
    seg = (start + torch.arange(b, device=keys.device)[:, None] * n)
    seg = seg.reshape(-1, 1).expand(-1, u1)
    first = torch.full((b * n, u1), n, dtype=cand.dtype, device=keys.device)
    first.scatter_reduce_(0, seg, cand.reshape(b * n, u1), reduce="amin")
    first = ind & (idx == torch.gather(first, 0, seg).reshape(b, n, u1))
    # each kept row's pillar cotangent: its emission row's
    erow = torch.clamp(start + cnt - 1, max=n - 1)
    g = g_t[:, :u1].transpose(1, 2)
    val = torch.gather(g, 1, erow[..., None].expand(-1, -1, u1))
    dt = torch.where(first & (t > 0), val, 0.).double()
    zhat = ((z - mu) * invsig).double()
    return (dt.sum(dim=(0, 1)), (dt * zhat).sum(dim=(0, 1)),
            torch.einsum("bnk,bnc->kc", x.double(), dt))


def pfn_bwd(keys, pts_t, g_t, w1t, a, c, mu, invsig, *, P, maxV, nx, vx, vy,
            x_off, y_off, with_distance=False):
    """Sums for the train-BN weight gradients.

    g_t: the cotangent of the fused rows [B, u1 (+1), N] (any strides;
    channels >= u1 ignored); a, c, mu, invsig [u1] f32. Returns f64
    (sdt = Σdt [u1], sdtz = Σdt·ẑ [u1], t1 = Σx⊗dt [C_dec, u1])."""
    kw = dict(P=P, maxV=maxV, nx=nx, vx=vx, vy=vy, x_off=x_off, y_off=y_off,
              with_distance=with_distance)
    vecs = (a, c, mu, invsig)
    b, c_in, n, u1, c_dec = _check(keys, pts_t, w1t,
                                   (pts_t, w1t, g_t) + vecs, "pfn_bwd")
    if not keys.is_cuda:
        return pfn_bwd_plain(keys, pts_t, g_t, w1t, a, c, mu, invsig, **kw)
    if g_t.shape[0] != b or g_t.shape[1] < u1 or g_t.shape[2] != n or any(
            v.shape != (u1,) or not v.is_contiguous() for v in vecs):
        raise ValueError("pfn_bwd: cotangent {} or statistics do not fit "
                         "{} channels".format(tuple(g_t.shape), u1))
    red = _launch("pfn_bwd", 2 + c_dec, keys, b, n, u1,
                  (keys.data_ptr(), pts_t.data_ptr(), w1t.data_ptr(),
                   a.data_ptr(), c.data_ptr(), mu.data_ptr(),
                   invsig.data_ptr(), g_t.data_ptr(), *g_t.stride()),
                  (c_in, c_dec, u1, P, maxV, nx, vx, vy, x_off, y_off,
                   int(with_distance)))
    return red[0], red[1], red[2:]


class _FusedPFNTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, keys, pts_t, w1t, gamma, beta, kw, eps, occupancy):
        b, _, n = pts_t.shape
        s1, s2, _, t3, sx = pfn_stats(keys, pts_t, w1t, **kw)
        m = float(b * n)
        mu64 = s1 / m
        # the JAX package's formula, from f64 sums
        mu, var = mu64.float(), (s2 / m - mu64 * mu64).float()
        invsig = torch.rsqrt(var + eps)
        a = gamma * invsig
        cshift = beta - mu * a
        rows = fused_pfn.fused_pfn_rows(
            keys, pts_t, (w1t * a[:, None]).contiguous(), cshift[:, None],
            n_layers=1, occupancy=occupancy, **kw)
        ctx.save_for_backward(keys, pts_t, w1t, mu, mu64, invsig, a, cshift,
                              t3, sx)
        ctx.kw = kw
        ctx.mark_non_differentiable(mu, var)
        return rows, mu, var

    @staticmethod
    def backward(ctx, d_rows, d_mu, d_var):
        (keys, pts_t, w1t, mu, mu64, invsig, a, cshift, t3,
         sx) = ctx.saved_tensors
        b, _, n = pts_t.shape
        sdt, sdtz, t1 = pfn_bwd(keys, pts_t, d_rows, w1t, a, cshift, mu,
                                invsig, **ctx.kw)
        m = float(b * n)
        t2 = (t3 - sx[:, None] * mu64[None, :]) * invsig.double()[None, :]
        dw1 = a.double()[None, :] * (t1 - sx[:, None] * (sdt / m)[None, :]
                                     - t2 * (sdtz / m)[None, :])  # [C_dec, u1]
        return (None, None, dw1.t().float(), sdtz.float(), sdt.float(), None,
                None, None)


def fused_pfn_train_rows(keys, pts_t, w1t, gamma, beta, *, P, maxV, nx, vx,
                         vy, x_off, y_off, with_distance=False,
                         occupancy=False, eps=1e-3):
    """Train-mode fused pillar rows with batch-statistics BN.

    keys [B, N] int32 sorted, pts_t [B, C_in, N] f32, w1t [u1, C_dec] the
    PFN linear weight, gamma / beta [u1] the BN affine. Returns (rows_t
    [B, u1 (+1 occupancy), N] as fused_pfn_rows gives them, mu [u1],
    var [u1]): the batch statistics for the caller's running-stat update,
    outside the graph. Differentiable in w1t, gamma and beta."""
    kw = dict(P=P, maxV=maxV, nx=nx, vx=vx, vy=vy, x_off=x_off, y_off=y_off,
              with_distance=with_distance)
    return _FusedPFNTrain.apply(keys, pts_t, w1t, gamma, beta, kw, eps,
                                occupancy)
