"""Fused pillar feature net rows: cell-sorted points → each pillar's PFN
feature on its emission row.

Port of paddle3d_tpu/ops/pallas/fused_pfn.py:fused_pfn_rows (TPU kernel
`_kernel` with `_decorate`). On a CUDA tensor the wrapper launches the
hand-written kernel in csrc/fused_pfn.cu for one or two PFN layers (its
header says what bounds them and how they are built); on a CPU tensor it
takes the plain PyTorch version beside it. pillar_ordinals is the plain
version's cap; the kernels find the cap row themselves.
"""
import torch
import torch.nn.functional as F

from . import _build

__all__ = ["fused_pfn_rows", "fused_pfn_rows_plain", "pillar_ordinals",
           "spans"]

_SENT = 2**31 - 1
_NEG = -1e9
_MAX_C_IN = 8  # csrc/fused_pfn.cu kMaxCin
_MAX_U1, _MAX_U2 = 32, 64  # csrc/fused_pfn.cu kU1, kU2 (two layers)
_CAP_ROWS = 4096  # csrc/fused_pfn.cu kCapRows
_MAX_SPAN = 1024    # csrc/pfn_common.cuh kMaxSpan
_SMS = {}           # device index -> streaming multiprocessors


def spans(b, n, device):
    """Spans a scan's rows are split into on the card by the one-layer K1
    and by K3 / K4, a block each: about two blocks an SM over the batch, at
    most _MAX_SPAN rows a span (the kernels round n / spans up to 32
    rows)."""
    sms = _SMS.get(device.index)
    if sms is None:
        sms = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    want = min(-(-2 * sms // max(b, 1)), -(-n // 32))
    return max(want, -(-n // _MAX_SPAN), 1)


def _decorate_plain(keys, pts, P, maxV, nx, vx, vy, x_off, y_off,
                    with_distance):
    """Segment masks, rank/cap and PFN input rows over sorted rows.

    keys [B, N] int32, pts [B, N, C_in]. Returns (x [B, N, C_dec], keep,
    emit, start, cnt): start is the row index of each row's segment head
    and cnt the number of the pillar's kept-rank rows (≤ P), so a kept
    row's emission row is start + cnt - 1. x is zero on rows not kept."""
    b, n = keys.shape
    idx = torch.arange(n, device=keys.device).expand(b, n)
    valid = keys < _SENT
    prev = F.pad(keys[:, :-1], (1, 0), value=-1)
    nxt = F.pad(keys[:, 1:], (0, 1), value=_SENT)
    new_seg = keys != prev
    # arrival rank within the segment (the sort is stable)
    start = torch.cummax(torch.where(new_seg, idx, 0), dim=1).values
    rank = idx - start
    tail = keys != nxt
    end = torch.flip(torch.cummin(
        torch.flip(torch.where(tail, idx, n - 1), (1,)), dim=1).values, (1,))
    vox = pillar_ordinals(keys)
    keep = valid & (rank < P) & (vox < maxV)
    emit = keep & (tail | (rank == P - 1))

    # mean over the pillar's kept rows, summed in row order from the head
    # (the CUDA kernel's order: the two agree bit for bit)
    cnt = torch.clamp(end - start + 1, max=P)
    xyz = pts[..., :3]
    acc = torch.zeros_like(xyz)
    for d in range(P):
        j = torch.clamp(start + d, max=n - 1)
        v = torch.gather(xyz, 1, j[..., None].expand(-1, -1, 3))
        acc = acc + torch.where((d < cnt)[..., None], v, 0.)
    mean = acc / cnt.to(pts.dtype)[..., None]

    yc = torch.div(keys, nx, rounding_mode="floor")
    xc = keys - yc * nx
    cx = xc.to(pts.dtype) * vx + x_off
    cy = yc.to(pts.dtype) * vy + y_off
    feats = [pts, xyz - mean, (pts[..., 0] - cx)[..., None],
             (pts[..., 1] - cy)[..., None]]
    if with_distance:
        sq = pts[..., 0] * pts[..., 0] + pts[..., 1] * pts[..., 1] + \
            pts[..., 2] * pts[..., 2]
        feats.append(torch.sqrt(sq)[..., None])
    x = torch.where(keep[..., None], torch.cat(feats, dim=-1), 0.)
    return x, keep, emit, start, cnt


def _segment_max(vals, start, keep):
    """Per-pillar max over kept rows, broadcast back to every row."""
    b, n, c = vals.shape
    seg = (start + torch.arange(b, device=vals.device)[:, None] * n)
    seg = seg.reshape(-1, 1).expand(-1, c)
    masked = torch.where(keep[..., None], vals, _NEG).reshape(b * n, c)
    segmax = torch.full((b * n, c), _NEG, dtype=vals.dtype,
                        device=vals.device)
    segmax.scatter_reduce_(0, seg, masked, reduce="amax")
    return torch.gather(segmax, 0, seg).reshape(b, n, c)


def pillar_ordinals(keys: torch.Tensor) -> torch.Tensor:
    """[B, N] sorted keys -> each row's pillar ordinal in key order
    (cumsum of valid segment heads, minus one): the max_voxels cap."""
    prev = F.pad(keys[:, :-1], (1, 0), value=-1)
    head = (keys != prev) & (keys < _SENT)
    return torch.cumsum(head, dim=1, dtype=torch.int32) - 1


def fused_pfn_rows_plain(keys, pts_t, w1t, b1, w2t=None, b2=None, *,
                         n_layers, P, maxV, nx, vx, vy, x_off, y_off,
                         with_distance=False, occupancy=False):
    """Plain PyTorch version of the fused PFN kernel (1 or 2 layers)."""
    pts = pts_t.transpose(1, 2).to(torch.float32)
    x, keep, emit, start, _ = _decorate_plain(
        keys, pts, P, maxV, nx, vx, vy, x_off, y_off, with_distance)
    # relu(b + Σ_k x_k w_k), summed in k order like the kernel
    y = b1[:, 0].to(torch.float32).expand(*x.shape[:2], -1)
    for k in range(x.shape[-1]):
        y = y + x[..., k:k + 1] * w1t[:, k]
    y = torch.relu(y)
    if n_layers == 2:
        # relu(b2 + W2 [y, m1]) with m1 the pillar max of y: from the bias
        # up, the m1 half first (one sum per pillar in the kernel), then the
        # y half, each in k order
        u1 = y.shape[-1]
        m1 = _segment_max(y, start, keep)
        t = b2[:, 0].to(torch.float32).expand(*y.shape[:2], -1)
        for k in range(u1):
            t = t + m1[..., k:k + 1] * w2t[:, u1 + k]
        for k in range(u1):
            t = t + y[..., k:k + 1] * w2t[:, k]
        y = torch.relu(t)
    rows = torch.where(emit[..., None], _segment_max(y, start, keep), 0.)
    if occupancy:
        rows = torch.cat([rows, emit[..., None].to(rows.dtype)], dim=-1)
    return rows.transpose(1, 2).contiguous()


def fused_pfn_rows(keys, pts_t, w1t, b1, w2t=None, b2=None, *, n_layers, P,
                   maxV, nx, vx, vy, x_off, y_off, with_distance=False,
                   occupancy=False):
    """Sorted pillar rows → emitted canvas rows.

    Args:
        keys: [B, N] int32 cell keys, sorted ascending (sentinel 2^31-1 for
            out-of-range rows).
        pts_t: [B, C_in, N] the matching sorted point columns, f32.
        w1t: [u1, C_dec] BN-folded first-layer weight (C_dec = C_in + 5
            (+1 with_distance)); b1: [u1, 1].
        w2t, b2: second layer ([u2, 2*u1], [u2, 1]) or None.
    Returns:
        rows [B, u_out (+1 if occupancy), N]: each pillar's feature on its
        emission row, zero elsewhere; the last channel is the emission flag.
    """
    if not keys.is_cuda:
        return fused_pfn_rows_plain(
            keys, pts_t, w1t, b1, w2t, b2, n_layers=n_layers, P=P, maxV=maxV,
            nx=nx, vx=vx, vy=vy, x_off=x_off, y_off=y_off,
            with_distance=with_distance, occupancy=occupancy)
    if n_layers not in (1, 2):
        raise ValueError("fused_pfn_rows takes 1 or 2 PFN layers, got {}"
                         .format(n_layers))
    b, c_in, n = pts_t.shape
    u1, c_dec = w1t.shape
    tensors = (keys, pts_t, w1t, b1) + ((w2t, b2) if n_layers == 2 else ())
    if keys.dtype != torch.int32 or any(
            t.dtype != torch.float32 for t in tensors[1:]):
        raise TypeError("fused_pfn_rows kernel takes int32 keys and f32 "
                        "points and weights")
    u_out = w2t.shape[0] if n_layers == 2 else u1
    if keys.shape != (b, n) or b1.shape != (u1, 1) or (
            n_layers == 2 and (w2t.shape != (u_out, 2 * u1) or
                               b2.shape != (u_out, 1))):
        raise ValueError("shape mismatch: keys {}, pts_t {}, w1t {}, b1 {}, "
                         "w2t {}, b2 {}".format(*(
                             None if t is None else tuple(t.shape) for t in
                             (keys, pts_t, w1t, b1, w2t, b2))))
    if not 3 <= c_in <= _MAX_C_IN or c_dec != c_in + 5 + int(with_distance):
        raise ValueError("unsupported channels: C_in {}, C_dec {}".format(
            c_in, c_dec))
    if n_layers == 2 and (u1 > _MAX_U1 or u_out > _MAX_U2):
        raise ValueError("unsupported widths for the two-layer kernel: u1 "
                         "{} (at most {}), u2 {} (at most {})".format(
                             u1, _MAX_U1, u_out, _MAX_U2))
    if any(t.device != keys.device for t in tensors):
        raise ValueError("fused_pfn_rows inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_pfn_rows kernel needs contiguous inputs")
    out = torch.empty((b, u_out + int(occupancy), n), dtype=torch.float32,
                      device=keys.device)
    geo = (nx, vx, vy, x_off, y_off, int(with_distance), int(occupancy),
           _build.stream_ptr(keys.device))
    if n_layers == 1:
        # the kernel finds the max_voxels cap in each block's span
        err = _build.function("p3d_fused_pfn_rows")(
            keys.data_ptr(), pts_t.data_ptr(), w1t.data_ptr(), b1.data_ptr(),
            out.data_ptr(), spans(b, n, keys.device), b, n, c_in, c_dec, u1,
            P, maxV, *geo)
        name = "fused_pfn_rows"
    else:
        # the kernel's own cap passes: head counts a chunk, the cap row a scan
        scratch = torch.empty(b * (-(-n // _CAP_ROWS) + 1),
                              dtype=torch.int32, device=keys.device)
        err = _build.function("p3d_fused_pfn2_rows")(
            keys.data_ptr(), pts_t.data_ptr(), scratch.data_ptr(),
            w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(),
            out.data_ptr(), b, n, c_in, c_dec, u1, u_out, P, maxV, *geo)
        name = "fused_pfn_rows_2l"
    _build.check(err, name)
    _build.LAUNCHES[name] += 1
    return out
