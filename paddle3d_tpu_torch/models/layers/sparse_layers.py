"""Layers over the sparse-conv ops, torch port of
paddle3d_tpu/models/layers/sparse_layers.py (SparseTensor, MaskedBatchNorm,
SparseConv3D, SparseBasicBlock).

SparseTensor is the fixed-capacity sparse tensor of the JAX package:
(features [B, V, C], coords [B, V, 3] (z, y, x), mask [B, V], grid
(D, H, W)). Serving only: in eval the convs take the fused form the JAX
package's kernel path takes (BatchNorm scale folded into the weights, bias
and shift added on valid rows, relu) through ops/sparse_conv.sparse_conv3d,
which launches the sparse conv kernel on a CUDA tensor and takes its plain
version on a CPU one. Training mode raises: the gather path's VJP and a
backward of the kernel arrive with ROADMAP.md, queue 1, item 7b.
"""
from typing import NamedTuple, Tuple

import torch
from torch import nn

from ...ops import sparse_conv as _sparse_conv
from ...ops.sparse import downsample_coords
from .layer_libs import default_generator, uniform_

__all__ = ["SparseTensor", "SparseConv3D", "MaskedBatchNorm",
           "SparseBasicBlock"]

_TRAIN_MSG = ("sparse-voxel training (the gather path's VJP and a backward "
              "of the sparse conv kernel) arrives with ROADMAP.md, queue 1, "
              "item 7b; call .eval() to serve")


class SparseTensor(NamedTuple):
    features: torch.Tensor       # [B, V, C]
    coords: torch.Tensor         # [B, V, 3] int32 (z, y, x)
    mask: torch.Tensor           # [B, V] bool
    grid: Tuple[int, int, int]   # (D, H, W)

    def replace_features(self, feats):
        return SparseTensor(feats, self.coords, self.mask, self.grid)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows of [B, V, C], eval form: running
    statistics, invalid rows zero. torch names (weight, bias, running_mean,
    running_var) for the JAX package's (scale, bias, mean, var)."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def fold_affine(self):
        """Eval-mode per-channel (scale, shift) with the running statistics
        folded in: y = x * scale + shift."""
        s = self.weight * torch.rsqrt(self.running_var + self.eps)
        return s, self.bias - self.running_mean * s

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(_TRAIN_MSG)
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        y = y * self.weight + self.bias
        return torch.where(mask[..., None], y, 0.)


class SparseConv3D(nn.Module):
    """Submanifold (stride 1) or strided sparse conv, K = 1 or 3.

    weight [K^3 * Cin, Cout] in the JAX package's layout (row kidx * Cin +
    cin). For stride > 1 the output active set is the downsampled unique
    coords with capacity `out_capacity` (the input's capacity when None)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride=1, out_capacity: int = None,
                 use_bias: bool = True, generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        self.kernel_size = kernel_size
        self.stride = (tuple(stride) if isinstance(stride, (tuple, list))
                       else (stride,) * 3)     # (sz, sy, sx)
        self.out_capacity = out_capacity
        fan_in = kernel_size ** 3 * in_channels
        self.weight = nn.Parameter(uniform_(
            torch.empty(fan_in, out_channels), fan_in, generator))
        self.bias = (nn.Parameter(uniform_(torch.empty(out_channels), fan_in,
                                           generator))
                     if use_bias else None)

    @staticmethod
    def _lin_keys(coords, mask, grid):
        """Linear keys; masked rows get DISTINCT, increasing sentinels
        D*H*W + 7 + row, as in the JAX package."""
        d, h, w = grid
        k = coords[..., 0] * (h * w) + coords[..., 1] * w + coords[..., 2]
        row = torch.arange(coords.shape[-2], dtype=torch.int32,
                           device=coords.device)
        return torch.where(mask, k, d * h * w + 7 + row).to(torch.int32)

    def forward(self, st: SparseTensor, scale=None, shift=None,
                relu: bool = False) -> SparseTensor:
        """y = conv(x) * scale + shift (+ relu) on valid rows, the fused
        eval-BN epilogue; the bias is folded into the shift."""
        if self.training:
            raise NotImplementedError(_TRAIN_MSG)
        if self.bias is not None:
            b = self.bias if scale is None else self.bias * scale
            shift = b if shift is None else shift + b
        d, h, w = st.grid
        keys = self._lin_keys(st.coords, st.mask, st.grid)
        if all(s == 1 for s in self.stride):
            out = _sparse_conv.sparse_conv3d(
                keys, keys, st.features, self.weight, d, h, w,
                self.kernel_size, scale=scale, shift=shift, relu=relu)
            return st.replace_features(out)
        sz, sy, sx = self.stride
        new_grid = (max(d // sz, 1), h // sy, w // sx)
        cap = self.out_capacity or st.features.shape[1]
        oc, om = downsample_coords(st.coords, st.mask, st.grid, self.stride,
                                   cap)
        stride_v = torch.tensor(self.stride, dtype=oc.dtype, device=oc.device)
        qb = self._lin_keys(oc * stride_v, om, st.grid)
        feats = _sparse_conv.sparse_conv3d(
            qb, keys, st.features, self.weight, d, h, w, self.kernel_size,
            scale=scale, shift=shift, relu=relu)
        return SparseTensor(feats, oc, om, new_grid)


class SparseBasicBlock(nn.Module):
    """Two submanifold convs (with bias) + residual; eval fuses each BN
    (and the first relu) into its conv's epilogue."""

    def __init__(self, channels: int, generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        self.conv1 = SparseConv3D(channels, channels, 3, generator=generator)
        self.bn1 = MaskedBatchNorm(channels)
        self.conv2 = SparseConv3D(channels, channels, 3, generator=generator)
        self.bn2 = MaskedBatchNorm(channels)

    def forward(self, st: SparseTensor) -> SparseTensor:
        identity = st.features
        s1, b1 = self.bn1.fold_affine()
        out = self.conv1(st, scale=s1, shift=b1, relu=True)
        s2, b2 = self.bn2.fold_affine()
        out = self.conv2(out, scale=s2, shift=b2)
        return out.replace_features(torch.relu(out.features + identity))
