"""Batched masked farthest-point sampling.

Port of paddle3d_tpu/ops/pallas/fps.py (TPU kernel `_kernel`, K10, entry
farthest_point_sample_batched). On a CUDA tensor
`farthest_point_sample_batched` launches the hand-written kernel in
csrc/fps.cu (whose header says what bounds it and how it is built); on a CPU
tensor it takes the plain PyTorch version,
ops/pointnet2.farthest_point_sample. The two agree index for index; a scan
with no valid point gives index 0 throughout, as the JAX package's XLA form
does (its TPU kernel gives the scan's length there).
"""
import torch

from . import _build
from .pointnet2 import farthest_point_sample as farthest_point_sample_plain

__all__ = ["farthest_point_sample_batched", "farthest_point_sample_plain",
           "plan"]

#: longest scan that a cluster of portable size (8 CTAs) holds on chip;
#: a longer one may take the scratch path, which needs a [B, N] buffer
_ON_CHIP_POINTS = 8 * 512 * 16


def plan(b: int, n: int, cluster: int = 0) -> dict:
    """What the kernel does with b scans of n points (cluster 0: its own
    choice of cluster size, else that size): CTAs a scan (0 for the scratch
    path), points a thread, threads a CTA, clusters resident at once as
    launched, and with an SM for each CTA."""
    import ctypes
    out = (ctypes.c_int * 5)()
    _build.check(_build.function("p3d_farthest_point_sample_plan")(
        b, n, cluster, out), "farthest_point_sample_plan")
    return dict(zip(("cluster", "points_a_thread", "threads", "resident",
                     "resident_alone"), out))


def _call(xyz, mask, npoint, cluster=0):
    """One launch, with the cluster size given (0: the kernel's choice);
    counts nothing."""
    if xyz.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError("farthest_point_sample kernel takes f32 points and a "
                        "bool mask, got {} and {}".format(xyz.dtype,
                                                          mask.dtype))
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or \
            tuple(mask.shape) != tuple(xyz.shape[:2]):
        raise ValueError("xyz [B, N, 3] and mask [B, N] expected, got {} and "
                         "{}".format(tuple(xyz.shape), tuple(mask.shape)))
    if mask.device != xyz.device:
        raise ValueError("xyz and mask lie on different devices")
    if not (xyz.is_contiguous() and mask.is_contiguous()):
        raise ValueError("farthest_point_sample kernel needs contiguous "
                         "inputs")
    b, n, _ = xyz.shape
    if n < 1 or npoint < 1:
        raise ValueError("farthest_point_sample needs n >= 1 and npoint >= 1")
    idx = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    scratch = (torch.empty((b, n), dtype=torch.float32, device=xyz.device)
               if n > _ON_CHIP_POINTS else None)
    err = _build.function("p3d_farthest_point_sample_cluster")(
        xyz.data_ptr(), mask.data_ptr(), idx.data_ptr(),
        scratch.data_ptr() if scratch is not None else None, b, n, npoint,
        cluster, _build.stream_ptr(xyz.device))
    _build.check(err, "farthest_point_sample")
    return idx


def _launch(xyz, mask, npoint):
    idx = _call(xyz, mask, npoint)
    _build.LAUNCHES["farthest_point_sample"] += 1
    return idx


def farthest_point_sample_batched(xyz: torch.Tensor, mask: torch.Tensor,
                                  npoint: int) -> torch.Tensor:
    """[B, N, 3] points (finite where valid) + [B, N] validity ->
    [B, npoint] int32: the first valid point, then each time the lowest
    index among the points farthest from the picks so far."""
    if not xyz.is_cuda:
        return farthest_point_sample_plain(xyz, mask, npoint)
    return _launch(xyz, mask, npoint)
