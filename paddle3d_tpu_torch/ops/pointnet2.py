"""PointNet++ primitives as fixed-shape batched tensor programs.

Port of paddle3d_tpu/ops/pointnet2.py (farthest_point_sample, ball_query,
gather_operation, grouping_operation, knn_query, three_nn,
three_interpolate, interpolation_weights), with the leading batch axis
written out where the JAX package vmaps. Every point set is [B, N, ...]
with a validity mask [B, N].

`farthest_point_sample` and `ball_query` are the plain versions of the two
hand-written kernels (ops/fps.py, ops/ball_query.py): index-valued, so the
squared distance is summed in one fixed order, (dx*dx + dy*dy) + dz*dz with
every product and sum rounded on its own, which the kernels repeat.
"""
from typing import Tuple

import torch

__all__ = [
    "farthest_point_sample", "gather_operation", "ball_query",
    "grouping_operation", "knn_query", "three_nn", "three_interpolate",
    "interpolation_weights", "first_argmax", "topk_stable",
]

_BIG = 1e10
#: elements of the [B, chunk, N] distance block one ball_query pass holds
_CHUNK_ELEMS = 1 << 25


def _dist2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distance of broadcastable [..., 3] points, summed as
    (dx*dx + dy*dy) + dz*dz (not a dot product: no fused multiply-add, no
    other order)."""
    dx = a[..., 0] - b[..., 0]
    dy = a[..., 1] - b[..., 1]
    dz = a[..., 2] - b[..., 2]
    return (dx * dx + dy * dy) + dz * dz


def first_argmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """argmax with ties to the lowest index (jnp.argmax's rule, which
    torch.argmax does not promise on every device). NaN counts as the
    maximum, as in jnp.argmax. -> int64."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    # a NaN makes the maximum NaN, which equals nothing: then the NaNs hit
    hit = (x == x.max(dim=-1, keepdim=True).values) | torch.isnan(x)
    ar = torch.arange(n, device=x.device)
    return torch.where(hit, ar, n).min(dim=-1).values


def topk_stable(x: torch.Tensor, k: int):
    """Exact top-k along the last axis with ties in index order, as
    jax.lax.top_k gives them on the CPU (torch.topk leaves the tie order
    open): a stable descending sort, first k. -> (values, int64 indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def farthest_point_sample(xyz: torch.Tensor, mask: torch.Tensor,
                          npoint: int) -> torch.Tensor:
    """[B, N, 3] points + [B, N] validity -> [B, npoint] int32 indices.

    Starts from the first valid point; an invalid point is never picked
    (its distance is pinned at -1); each pick is the lowest index among
    the points farthest from the picks so far, so a scan with fewer valid
    points than npoint repeats its first valid point from there on, and a
    scan with no valid point gives index 0 throughout."""
    b, n, _ = xyz.shape
    xyz = xyz.to(torch.float32)
    ar = torch.arange(n, device=xyz.device)
    d2 = torch.where(mask, _BIG, -1.0).to(torch.float32)
    last = torch.where(mask, ar, n).min(dim=1).values
    last = torch.where(last < n, last, 0)            # jnp.argmax of all-False
    picks = [last]
    for _ in range(1, npoint):
        p = torch.gather(xyz, 1, last[:, None, None].expand(-1, 1, 3))
        d2 = torch.where(mask, torch.minimum(d2, _dist2(xyz, p)), -1.0)
        last = first_argmax(d2, dim=1)
        picks.append(last)
    return torch.stack(picks, dim=1).to(torch.int32)


def gather_operation(features: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    """[B, N, C] (or [B, N]) x [B, M] -> [B, M, C] (or [B, M])."""
    idx = idx.long()
    if features.dim() == 2:
        return torch.gather(features, 1, idx)
    return torch.gather(features, 1,
                        idx[..., None].expand(-1, -1, features.shape[-1]))


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor, xyz_mask: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, N, 3] support + [B, M, 3] centres + [B, N] validity ->
    (idx [B, M, nsample] int32, count [B, M] int32).

    Keeps the first nsample valid points with d2 <= radius*radius by index
    order (radius*radius a double product rounded once to f32); count is
    capped at nsample; empty slots repeat the first hit, or are 0 when no
    point is in range (count == 0 flags it). Queries go through in chunks
    so that the [B, chunk, N] distance block stays bounded."""
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    dev = xyz.device
    xyz = xyz.to(torch.float32)
    new_xyz = new_xyz.to(torch.float32)
    r2 = torch.tensor(radius * radius, dtype=torch.float32, device=dev)
    src = torch.arange(n, dtype=torch.int32, device=dev)
    ar = torch.arange(nsample, device=dev)
    chunk = max(1, min(m, _CHUNK_ELEMS // max(b * n, 1)))
    idxs, counts = [], []
    for lo in range(0, m, chunk):
        q = new_xyz[:, lo:lo + chunk]
        d2 = _dist2(q[:, :, None, :], xyz[:, None, :, :])      # [B, c, N]
        in_ball = (d2 <= r2) & xyz_mask[:, None, :]
        rank = torch.cumsum(in_ball, dim=2) - 1
        slot = torch.where(in_ball & (rank < nsample), rank, nsample)
        idx = torch.zeros((b, q.shape[1], nsample + 1), dtype=torch.int32,
                          device=dev)
        # every row without a slot lands in the spill slot, which is cut
        idx.scatter_(2, slot, src.expand_as(slot))
        idx = idx[..., :nsample]
        count = in_ball.sum(dim=2).clamp(max=nsample)
        idx = torch.where(ar < count.clamp(min=1)[..., None], idx,
                          idx[..., :1])
        idxs.append(idx)
        counts.append(count.to(torch.int32))
    if not idxs:
        return (torch.zeros((b, 0, nsample), dtype=torch.int32, device=dev),
                torch.zeros((b, 0), dtype=torch.int32, device=dev))
    return torch.cat(idxs, dim=1), torch.cat(counts, dim=1)


def grouping_operation(features: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """[B, N, C] x [B, M, K] -> [B, M, K, C]."""
    b, m, k = idx.shape
    return gather_operation(features, idx.reshape(b, m * k)).reshape(
        b, m, k, features.shape[-1])


def knn_query(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
              xyz_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, N, 3] support + [B, M, 3] centres -> (idx [B, M, k] int32,
    dist2 [B, M, k]), nearest first, ties in index order."""
    d2 = _dist2(new_xyz[:, :, None, :].to(torch.float32),
                xyz[:, None, :, :].to(torch.float32))
    d2 = torch.where(xyz_mask[:, None, :], d2, _BIG)
    neg, idx = topk_stable(-d2, k)
    return idx.to(torch.int32), -neg


def three_nn(unknown: torch.Tensor, known: torch.Tensor,
             known_mask: torch.Tensor):
    """3 nearest neighbours: [B, M, 3], [B, N, 3] -> (dist2 [B, M, 3],
    idx [B, M, 3])."""
    idx, d2 = knn_query(3, known, unknown, known_mask)
    return d2, idx


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """[B, N, C] x [B, M, 3] x [B, M, 3] -> [B, M, C] inverse-distance
    interpolation."""
    return (grouping_operation(features, idx) * weight[..., None]).sum(dim=2)


def interpolation_weights(dist2: torch.Tensor, eps: float = 1e-8):
    recip = 1.0 / torch.clamp(dist2, min=eps)
    return recip / recip.sum(dim=-1, keepdim=True)
