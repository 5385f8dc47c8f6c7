"""Batched row gather: out[b, i] = src[b, idx[b, i]].

Port of paddle3d_tpu/ops/pallas/gather.py (TPU kernel `_gather_kernel`,
K14, entry `_pallas_gather`, public `gather_rows`), which no path of the
JAX package calls. In the port SMOKE's decode gathers its top-k rows of the
regression map with it (models/detection/smoke/smoke.py, the NCHW map read
in place as a strided [B, H*W, C] view). On a CUDA tensor `gather_rows`
launches the hand-written kernel in csrc/gather.cu (whose header says what
bounds it and how it is built); on a CPU tensor it takes the plain PyTorch
version beside it. Forward only: the JAX kernel has no VJP.

Out-of-range indices follow the JAX function's CPU form,
jnp.take_along_axis: an index in [-A, 0) wraps once to idx + A, any other
index outside [0, A) gives a row of NaN (the Pallas kernel has no defined
answer for them). Both the kernel and the plain version do this on the
device, with no host round trip.
"""
import torch

from . import _build

__all__ = ["gather_rows", "gather_rows_plain"]


def gather_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K14: torch.gather of the wrapped indices, NaN rows
    where an index lies outside [-A, A)."""
    a = src.shape[1]
    j = torch.where(idx < 0, idx + a, idx).long()
    inside = (j >= 0) & (j < a)
    rows = torch.gather(src, 1, j.clamp(0, max(a - 1, 0))[..., None].expand(
        -1, -1, src.shape[-1]))
    return torch.where(inside[..., None], rows, float("nan"))


def _refuse(src, idx):
    """Raise the error that names what the kernel cannot take."""
    if src.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError("gather_rows kernel takes f32 rows and int32 "
                        "indices, got {} and {}".format(src.dtype, idx.dtype))
    if src.dim() != 3 or idx.dim() != 2 or idx.shape[0] != src.shape[0]:
        raise ValueError("src [B, A, C] and idx [B, K] expected, got {} and "
                         "{}".format(tuple(src.shape), tuple(idx.shape)))
    raise ValueError("gather_rows needs contiguous indices on the rows' "
                     "device")


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src [B, A, C] f32 (possibly a strided view) x idx [B, K] int32 ->
    [B, K, C]: out[b, i] = src[b, idx[b, i]], out-of-range indices as the
    module docstring says."""
    if not src.is_cuda:
        return gather_rows_plain(src, idx)
    # the launch is a few microseconds of host work at small shapes: the
    # argument checks are one expression (the error is named only on the
    # way out), the function is bound once (_build.function)
    if (src.dtype is not torch.float32 or idx.dtype is not torch.int32 or
            src.dim() != 3 or idx.dim() != 2 or
            idx.shape[0] != src.shape[0] or not idx.is_contiguous() or
            idx.device != src.device):
        _refuse(src, idx)
    b, a, c = src.shape
    k = idx.shape[1]
    out = src.new_empty((b, k, c))
    if not out.numel():
        return out
    err = _build.function("p3d_gather_rows")(
        src.data_ptr(), *src.stride(), idx.data_ptr(), out.data_ptr(), b, a,
        k, c, _build.stream_ptr(src.device))
    if err:
        _build.check(err, "gather_rows")
    _build.LAUNCHES["gather_rows"] += 1
    return out
