"""Layers over the sparse-conv ops, torch port of
paddle3d_tpu/models/layers/sparse_layers.py (SparseTensor, MaskedBatchNorm,
SparseConv3D, SparseBasicBlock).

SparseTensor is the fixed-capacity sparse tensor of the JAX package:
(features [B, V, C], coords [B, V, 3] (z, y, x), mask [B, V], grid
(D, H, W)), plus, in eval, the neighbour map of its key set (`nbr`) once a
submanifold conv has built it. In eval the convs take the fused form the
JAX package's kernel path takes (BatchNorm scale folded into the weights,
bias and shift added on valid rows, relu) through
ops/sparse_conv.sparse_conv3d over a neighbour map from
ops/sparse_conv.sparse_conv3d_map, which launch the sparse conv kernels on
a CUDA tensor and take their plain versions on a CPU one: a submanifold
conv reuses the map its input carries (`replace_features` keeps it, so
every subm conv of a stage shares one), a strided conv builds its own and
hands on none, its output key set being new. In train mode they take the
gather route under autograd, as the JAX package trains them (ops/sparse:
the K^3 neighbour rows gathered, one [V, K^3 * Cin] @ [K^3 * Cin, Cout]
product), unfused: conv (+ bias, rows masked), then MaskedBatchNorm on
batch statistics, then relu.
"""
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ...ops import sparse_conv as _sparse_conv
from ...ops.sparse import (downsample_coords, sparse_gather_neighbors,
                           subm_conv3d_gather)
from .layer_libs import default_generator, uniform_

__all__ = ["SparseTensor", "SparseConv3D", "MaskedBatchNorm",
           "SparseBasicBlock"]

class SparseTensor(NamedTuple):
    features: torch.Tensor       # [B, V, C]
    coords: torch.Tensor         # [B, V, 3] int32 (z, y, x)
    mask: torch.Tensor           # [B, V] bool
    grid: Tuple[int, int, int]   # (D, H, W)
    # eval: the submanifold neighbour map [B, V, K^3] of this key set
    nbr: Optional[torch.Tensor] = None

    def replace_features(self, feats):
        """The same key set (and its map) with new features."""
        return self._replace(features=feats)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows of [B, V, C]; invalid rows are zero.
    torch names (weight, bias, running_mean, running_var) for the JAX
    package's (scale, bias, mean, var). Train mode normalises with the
    biased batch statistics of the valid rows (two passes: the mean, then
    the mean square of the centred rows) and updates the running stats
    flax-style, stat <- momentum * stat + (1 - momentum) * batch stat, with
    momentum 0.99; eval uses the running stats."""

    def __init__(self, channels: int, eps: float = 1e-3,
                 momentum: float = 0.99):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
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
        if not self.training:
            y = (x - self.running_mean) * torch.rsqrt(self.running_var +
                                                      self.eps)
            y = y * self.weight + self.bias
            return torch.where(mask[..., None], y, 0.)
        m = mask.to(x.dtype)[..., None]
        count = torch.clamp(m.sum(), min=1.0)
        mean = (x * m).sum(dim=(0, 1)) / count
        diff = (x - mean) * m
        var = (diff * diff).sum(dim=(0, 1)) / count
        with torch.no_grad():
            keep = self.momentum
            self.running_mean.copy_(keep * self.running_mean +
                                    (1 - keep) * mean)
            self.running_var.copy_(keep * self.running_var +
                                   (1 - keep) * var)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight + self.bias
        return y * m


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

    def _gather_forward(self, st: SparseTensor) -> SparseTensor:
        """Train mode: the gather route under autograd, conv + bias on the
        output's valid rows (the JAX package's non-kernel path)."""
        if all(s == 1 for s in self.stride):
            out = subm_conv3d_gather(st.features, st.coords, st.mask,
                                     self.weight, st.grid)
            oc, om, grid = st.coords, st.mask, st.grid
        else:
            d, h, w = st.grid
            sz, sy, sx = self.stride
            grid = (max(d // sz, 1), h // sy, w // sx)
            cap = self.out_capacity or st.features.shape[1]
            oc, om = downsample_coords(st.coords, st.mask, st.grid,
                                       self.stride, cap)
            g = sparse_gather_neighbors(st.features, st.coords, st.mask, oc,
                                        om, self.kernel_size, st.grid,
                                        stride=self.stride)
            out = g.flatten(-2) @ self.weight
        if self.bias is not None:
            out = out + self.bias
        return SparseTensor(out * om[..., None].to(out.dtype), oc, om, grid)

    def forward(self, st: SparseTensor, scale=None, shift=None,
                relu: bool = False) -> SparseTensor:
        """Eval: y = conv(x) * scale + shift (+ relu) on valid rows, the
        fused eval-BN epilogue; the bias is folded into the shift. Train:
        conv(x) + bias on valid rows (callers apply BN and relu after it;
        no epilogue may be given)."""
        if self.training:
            if scale is not None or shift is not None or relu:
                raise ValueError("the train-mode sparse conv takes no fused "
                                 "epilogue")
            return self._gather_forward(st)
        if self.bias is not None:
            b = self.bias if scale is None else self.bias * scale
            shift = b if shift is None else shift + b
        d, h, w = st.grid
        ks = self.kernel_size
        keys = self._lin_keys(st.coords, st.mask, st.grid)
        if all(s == 1 for s in self.stride):
            nbr = st.nbr
            if nbr is None or nbr.shape[-1] != ks ** 3:
                nbr = _sparse_conv.sparse_conv3d_map(keys, keys, d, h, w, ks)
            out = _sparse_conv.sparse_conv3d(
                keys, keys, st.features, self.weight, d, h, w, ks,
                scale=scale, shift=shift, relu=relu, nbr=nbr)
            return st._replace(features=out, nbr=nbr)
        sz, sy, sx = self.stride
        new_grid = (max(d // sz, 1), h // sy, w // sx)
        cap = self.out_capacity or st.features.shape[1]
        oc, om = downsample_coords(st.coords, st.mask, st.grid, self.stride,
                                   cap)
        stride_v = torch.tensor(self.stride, dtype=oc.dtype, device=oc.device)
        qb = self._lin_keys(oc * stride_v, om, st.grid)
        feats = _sparse_conv.sparse_conv3d(
            qb, keys, st.features, self.weight, d, h, w, ks, scale=scale,
            shift=shift, relu=relu,
            nbr=_sparse_conv.sparse_conv3d_map(qb, keys, d, h, w, ks))
        return SparseTensor(feats, oc, om, new_grid)


class SparseBasicBlock(nn.Module):
    """Two submanifold convs (with bias) + residual; eval fuses each BN
    (and the first relu) into its conv's epilogue, train runs conv, BN and
    relu one after the other."""

    def __init__(self, channels: int, generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        self.conv1 = SparseConv3D(channels, channels, 3, generator=generator)
        self.bn1 = MaskedBatchNorm(channels)
        self.conv2 = SparseConv3D(channels, channels, 3, generator=generator)
        self.bn2 = MaskedBatchNorm(channels)

    def forward(self, st: SparseTensor) -> SparseTensor:
        identity = st.features
        if self.training:
            out = self.conv1(st)
            out = out.replace_features(
                torch.relu(self.bn1(out.features, out.mask)))
            out = self.conv2(out)
            return out.replace_features(torch.relu(
                self.bn2(out.features, out.mask) + identity))
        s1, b1 = self.bn1.fold_affine()
        out = self.conv1(st, scale=s1, shift=b1, relu=True)
        s2, b2 = self.bn2.fold_affine()
        out = self.conv2(out, scale=s2, shift=b2)
        return out.replace_features(torch.relu(out.features + identity))
