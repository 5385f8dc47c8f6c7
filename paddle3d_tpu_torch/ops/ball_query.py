"""Batched ball query: the first `nsample` support points within `radius`
of each query centre, in index order.

Port of paddle3d_tpu/ops/pallas/ball_query.py (TPU kernel `_kernel`, K9,
entry ball_query_batched). On a CUDA tensor `ball_query_batched` launches
the hand-written kernel in csrc/ball_query.cu (whose header says what bounds
it and how it is built); on a CPU tensor it takes the plain PyTorch version,
ops/pointnet2.ball_query. The two agree index for index.
"""
from typing import Tuple

import torch

from . import _build
from .pointnet2 import ball_query as ball_query_plain

__all__ = ["ball_query_batched", "ball_query_plain"]


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
    err = _build.function("p3d_ball_query")(
        xyz.data_ptr(), new_xyz.data_ptr(), xyz_mask.data_ptr(),
        idx.data_ptr(), cnt.data_ptr(), radius * radius, b, n, m, nsample,
        _build.stream_ptr(xyz.device))
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
