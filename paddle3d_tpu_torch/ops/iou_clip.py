"""All-pairs intersection area of convex quadrilaterals.

Port of paddle3d_tpu/ops/pallas/iou_clip.py (TPU kernel `_clip_area_kernel`,
K11, entry pairwise_intersection_area_pallas), which computes the slot-list
clip of paddle3d_tpu/ops/iou3d_nms.py:_pairwise_intersection_area. On a CUDA
tensor `pairwise_intersection_area` launches the hand-written kernel in
csrc/iou_clip.cu (whose header says what bounds it and how it is built: the
guard over a tile of pairs, then each passing pair's clip spread over a
group of lanes); on a CPU tensor it takes the plain PyTorch version below.
The two agree bit for bit: the kernel rounds every operation on its own in
the plain version's order.

The plain version is the XLA slot-list form op for op (no-compaction
Sutherland-Hodgman: every clip stage emits two slots per slot, outside
vertices projected onto the clip line, a shoelace over the 64 final slots,
the circumscribed-circle guard), with a stage's slots stacked on a last axis
instead of held as separate arrays; elementwise, that changes no rounding.
The shoelace adds its 64 terms one at a time, in slot order.
"""
import torch

from . import _build

__all__ = ["pairwise_intersection_area",
           "pairwise_intersection_area_plain"]

_EPS = 1e-7
#: batch rows one launch takes (the kernel's grid carries them on its y axis)
MAX_BATCH = 65535


def _circle(q: torch.Tensor):
    """[..., 4, 2] corners -> centre x, y and circumradius, each [...]."""
    x, y = q[..., 0], q[..., 1]
    cx = (((x[..., 0] + x[..., 1]) + x[..., 2]) + x[..., 3]) * 0.25
    cy = (((y[..., 0] + y[..., 1]) + y[..., 2]) + y[..., 3]) * 0.25
    r = torch.zeros_like(cx)
    for j in range(4):
        dx = x[..., j] - cx
        dy = y[..., j] - cy
        r = torch.maximum(r, torch.sqrt(dx * dx + dy * dy))
    return cx, cy, r


def pairwise_intersection_area_plain(ca: torch.Tensor,
                                     cb: torch.Tensor) -> torch.Tensor:
    """ca [..., N, 4, 2], cb [..., M, 4, 2] (CCW corners, f32, equal leading
    dims) -> [..., N, M] intersection areas, 0 for pairs whose
    circumscribed circles do not meet."""
    cax, cay, ra = _circle(ca)
    cbx, cby, rb = _circle(cb)
    cdx = cax[..., :, None] - cbx[..., None, :]
    cdy = cay[..., :, None] - cby[..., None, :]
    dist = torch.sqrt(cdx * cdx + cdy * cdy)
    possible = dist <= ra[..., :, None] + rb[..., None, :]

    n, m = ca.shape[-3], cb.shape[-3]
    shape = ca.shape[:-3] + (n, m, 4)
    px = ca[..., :, None, :, 0].expand(shape)       # [..., N, M, k] slots
    py = ca[..., :, None, :, 1].expand(shape)
    bx = cb[..., None, :, :, 0]                     # [..., 1, M, 4]
    by = cb[..., None, :, :, 1]
    for e in range(4):
        lx, ly = bx[..., e:e + 1], by[..., e:e + 1]
        dxe = bx[..., (e + 1) % 4:(e + 1) % 4 + 1] - lx
        dye = by[..., (e + 1) % 4:(e + 1) % 4 + 1] - ly
        inv_d2 = 1.0 / torch.clamp(dxe * dxe + dye * dye, min=_EPS)
        sx, sy = px, py
        ex, ey = torch.roll(px, -1, dims=-1), torch.roll(py, -1, dims=-1)
        ds = dxe * (sy - ly) - dye * (sx - lx)
        de = torch.roll(ds, -1, dims=-1)
        s_in = ds >= 0
        denom = ds - de
        t = ds / torch.where(torch.abs(denom) < _EPS, 1.0, denom)
        ix = sx + t * (ex - sx)
        iy = sy + t * (ey - sy)
        crossing = (s_in != (de >= 0)) & (torch.abs(denom) >= _EPS)
        # orthogonal projection of the start vertex onto the clip line
        tp = ((sx - lx) * dxe + (sy - ly) * dye) * inv_d2
        sax = torch.where(s_in, sx, lx + tp * dxe)
        say = torch.where(s_in, sy, ly + tp * dye)
        px = torch.stack([sax, torch.where(crossing, ix, sax)],
                         dim=-1).flatten(-2)
        py = torch.stack([say, torch.where(crossing, iy, say)],
                         dim=-1).flatten(-2)

    terms = px * torch.roll(py, -1, dims=-1) - torch.roll(px, -1,
                                                          dims=-1) * py
    acc = terms[..., 0]
    for i in range(1, terms.shape[-1]):
        acc = acc + terms[..., i]
    return torch.where(possible, 0.5 * torch.abs(acc), 0.)


def _launch(ca, cb):
    if ca.dtype != torch.float32 or cb.dtype != torch.float32:
        raise TypeError("pairwise_intersection_area kernel takes f32 corners, "
                        "got {} and {}".format(ca.dtype, cb.dtype))
    if ca.dim() < 3 or cb.dim() != ca.dim() or ca.shape[-2:] != (4, 2) or \
            cb.shape[-2:] != (4, 2) or ca.shape[:-3] != cb.shape[:-3]:
        raise ValueError("corners [..., N, 4, 2] and [..., M, 4, 2] with "
                         "equal leading dims expected, got {} and {}".format(
                             tuple(ca.shape), tuple(cb.shape)))
    if cb.device != ca.device:
        raise ValueError("pairwise_intersection_area inputs lie on different "
                         "devices")
    lead, n, m = ca.shape[:-3], ca.shape[-3], cb.shape[-3]
    ca3 = ca.reshape(-1, n, 4, 2).contiguous()
    cb3 = cb.reshape(-1, m, 4, 2).contiguous()
    b = ca3.shape[0]
    if b > MAX_BATCH:
        raise ValueError("pairwise_intersection_area takes at most {} batch "
                         "rows a call, got {}".format(MAX_BATCH, b))
    out = torch.empty((b, n, m), dtype=torch.float32, device=ca.device)
    err = _build.function("p3d_pairwise_intersection_area")(
        ca3.data_ptr(), cb3.data_ptr(), out.data_ptr(), b, n, m,
        _build.stream_ptr(ca.device))
    _build.check(err, "pairwise_intersection_area")
    _build.LAUNCHES["pairwise_intersection_area"] += 1
    return out.reshape(lead + (n, m))


def pairwise_intersection_area(ca: torch.Tensor,
                               cb: torch.Tensor) -> torch.Tensor:
    """ca [..., N, 4, 2], cb [..., M, 4, 2] CCW corners -> [..., N, M]
    intersection areas (one kernel launch a call on the card, the batch on
    its grid)."""
    if not ca.is_cuda:
        return pairwise_intersection_area_plain(ca, cb)
    return _launch(ca, cb)
