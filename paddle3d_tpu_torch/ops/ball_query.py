"""Batched ball query: the first `nsample` support points within `radius`
of each query centre, in index order.

Port of paddle3d_tpu/ops/pallas/ball_query.py (TPU kernel `_kernel`, K9,
entry ball_query_batched). On a CUDA tensor `ball_query_batched` launches
the hand-written kernel in csrc/ball_query.cu (whose header says what bounds
it and how it is built); on a CPU tensor it takes the plain PyTorch version,
ops/pointnet2.ball_query. The two agree index for index. `cull_plain`
repeats the kernel's two culls (support chunks by box, points by the box of
a block's queries) in plain PyTorch, to count what the kernel skips and to
test that it skips only what no ball reaches.
"""
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build
from .pointnet2 import ball_query as ball_query_plain

__all__ = ["ball_query_batched", "ball_query_plain", "cull_plain",
           "CHUNK", "BLOCK_QUERIES"]

CHUNK = 32          # support points a chunk (csrc/ball_query.cu kChunk)
BLOCK_QUERIES = 32  # queries a block (csrc/ball_query.cu kWarps)
#: elements of the [.., 3] gap block one cull_plain pass holds
_CULL_ELEMS = 1 << 24


def _gap(q_lo, q_hi, p_lo, p_hi):
    """Query-minus-support difference of the closest pair of two intervals,
    0 where they overlap: the kernel's gap, rounded as the point test."""
    zero = torch.zeros((), dtype=torch.float32, device=q_lo.device)
    return torch.where(q_hi < p_lo, q_hi - p_lo,
                       torch.where(q_lo > p_hi, q_lo - p_hi, zero))


def _far(g, r2):
    """(gx*gx + gy*gy) + gz*gz > r2, each operation rounded on its own."""
    return (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + \
        g[..., 2] * g[..., 2] > r2


def _box(v, keep, dim):
    """Bounding box of v [..., 3] over `keep` along dim, NaN coordinates
    left out (as fminf / fmaxf do): -> (lo, hi); +inf / -inf if empty."""
    ok = keep[..., None] & ~torch.isnan(v)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=v.device)
    return (torch.where(ok, v, inf).amin(dim=dim),
            torch.where(ok, v, -inf).amax(dim=dim))


def cull_plain(radius: float, xyz: torch.Tensor, new_xyz: torch.Tensor,
               xyz_mask: torch.Tensor):
    """The kernel's two culls in plain PyTorch. [B, N, 3] support, [B, M, 3]
    centres, [B, N] validity -> (visit [B, M, C] bool: chunk c of CHUNK
    supports in index order is not skipped by its box for query m; keep
    [B, G, N] bool: support n is valid and not skipped by the box of block
    g's BLOCK_QUERIES queries). A skipped chunk or point cannot hold a hit
    of the query or block (the gaps are rounded as the point test)."""
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    dev = xyz.device
    xyz = xyz.to(torch.float32)
    new_xyz = new_xyz.to(torch.float32)
    r2 = torch.tensor(radius * radius, dtype=torch.float32, device=dev)
    c = -(-n // CHUNK)
    g = -(-m // BLOCK_QUERIES)
    pad = c * CHUNK - n
    c_lo, c_hi = _box(F.pad(xyz, (0, 0, 0, pad)).reshape(b, c, CHUNK, 3),
                      F.pad(xyz_mask, (0, pad)).reshape(b, c, CHUNK), 2)
    qpad = g * BLOCK_QUERIES - m
    q_lo, q_hi = _box(
        F.pad(new_xyz, (0, 0, 0, qpad)).reshape(b, g, BLOCK_QUERIES, 3),
        F.pad(torch.ones((b, m), dtype=torch.bool, device=dev),
              (0, qpad)).reshape(b, g, BLOCK_QUERIES), 2)
    visit, keep = [], []
    step = max(1, _CULL_ELEMS // max(b * max(c, n) * 3, 1))
    for lo in range(0, m, step):
        q = new_xyz[:, lo:lo + step, None, :]
        visit.append(~_far(_gap(q, q, c_lo[:, None], c_hi[:, None]), r2))
    for lo in range(0, g, step):
        p = xyz[:, None, :, :]
        keep.append(xyz_mask[:, None, :] & ~_far(_gap(
            q_lo[:, lo:lo + step, None], q_hi[:, lo:lo + step, None], p, p),
            r2))
    return (torch.cat(visit, dim=1) if visit else
            torch.zeros((b, 0, c), dtype=torch.bool, device=dev),
            torch.cat(keep, dim=1) if keep else
            torch.zeros((b, 0, n), dtype=torch.bool, device=dev))


def _launch(radius, nsample, xyz, new_xyz, xyz_mask):
    if xyz.dtype != torch.float32 or new_xyz.dtype != torch.float32 or \
            xyz_mask.dtype != torch.bool:
        raise TypeError("ball_query kernel takes f32 points and a bool mask, "
                        "got {}, {} and {}".format(xyz.dtype, new_xyz.dtype,
                                                   xyz_mask.dtype))
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or new_xyz.dim() != 3 or \
            new_xyz.shape[-1] != 3 or new_xyz.shape[0] != xyz.shape[0] or \
            tuple(xyz_mask.shape) != tuple(xyz.shape[:2]):
        raise ValueError("xyz [B, N, 3], new_xyz [B, M, 3] and mask [B, N] "
                         "expected, got {}, {} and {}".format(
                             tuple(xyz.shape), tuple(new_xyz.shape),
                             tuple(xyz_mask.shape)))
    if not (new_xyz.device == xyz_mask.device == xyz.device):
        raise ValueError("ball_query inputs lie on different devices")
    if not (xyz.is_contiguous() and new_xyz.is_contiguous()
            and xyz_mask.is_contiguous()):
        raise ValueError("ball_query kernel needs contiguous inputs")
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz.device)
    cnt = torch.empty((b, m), dtype=torch.int32, device=xyz.device)
    # each chunk's box, (lo, hi) as two float4, written by the kernel's
    # pre-pass
    boxes = torch.empty((b, -(-n // CHUNK), 8), dtype=torch.float32,
                        device=xyz.device)
    err = _build.function("p3d_ball_query")(
        xyz.data_ptr(), new_xyz.data_ptr(), xyz_mask.data_ptr(),
        boxes.data_ptr(), idx.data_ptr(), cnt.data_ptr(), radius * radius, b,
        n, m, nsample, _build.stream_ptr(xyz.device))
    _build.check(err, "ball_query")
    _build.LAUNCHES["ball_query"] += 1
    return idx, cnt


def ball_query_batched(radius: float, nsample: int, xyz: torch.Tensor,
                       new_xyz: torch.Tensor, xyz_mask: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, N, 3] support + [B, M, 3] centres + [B, N] validity ->
    (idx [B, M, nsample] int32, count [B, M] int32): the first nsample valid
    points with d2 <= radius*radius by index order, count capped at
    nsample, empty slots repeating the first hit (all 0 when count == 0)."""
    if not xyz.is_cuda:
        return ball_query_plain(radius, nsample, xyz, new_xyz, xyz_mask)
    return _launch(radius, nsample, xyz, new_xyz, xyz_mask)
