"""Shared layer building blocks, torch port of
paddle3d_tpu/models/layers/layer_libs.py (uniform_init, uniform_bias_init,
ConvBNReLU, DeconvBNReLU, LinearBN1DReLU, heatmap_nms, gather_topk_feat),
and Sequential, nnx.Sequential's layout.

NCHW layout. Two conventions of the JAX package are kept on purpose:
  * flax `padding="SAME"` pads (total // 2, total - total // 2), which on a
    stride-2 3×3 conv over an even size is (0, 1), not torch's (1, 1);
  * BatchNorm eps 1e-3 and flax momentum 0.99 (torch momentum 0.01), with
    flax's running-stat update in train mode (BatchNorm1d/BatchNorm2d
    below): torch's own updates running_var with the unbiased batch
    variance, flax with the biased one.
Weights are initialised uniform ±1/sqrt(fan_in) from an explicit
torch.Generator (default seed 0), never from the global RNG.
"""
import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import gather

__all__ = ["ConvBNReLU", "DeconvBNReLU", "LinearBN1DReLU", "BatchNorm1d",
           "BatchNorm2d", "Sequential", "same_pads", "uniform_",
           "uniform_init", "lecun_normal_", "uniform_bias_init",
           "default_generator", "heatmap_nms", "gather_topk_feat"]


def default_generator(generator: torch.Generator = None) -> torch.Generator:
    return generator if generator is not None else \
        torch.Generator().manual_seed(0)


def uniform_(tensor: torch.Tensor, fan_in: int,
             generator: torch.Generator) -> torch.Tensor:
    """In-place uniform(±1/sqrt(fan_in)) init (the paddle default the JAX
    package mirrors)."""
    bound = 1.0 / math.sqrt(max(fan_in, 1))
    with torch.no_grad():
        return tensor.uniform_(-bound, bound, generator=generator)


def uniform_init(weight: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
    """uniform(±1/sqrt(fan_in)) for a torch weight ([out, in, *kernel]:
    fan_in = in · prod(kernel)), the JAX package's uniform_init."""
    return uniform_(weight, weight[0].numel(), generator)


def lecun_normal_(weight: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """In-place lecun normal for a torch weight ([out, in, *kernel]: fan_in
    = in · prod(kernel)), flax's default kernel init: a normal of std
    sqrt(1 / fan_in) / 0.8796 truncated at two stds, drawn by its inverse
    CDF (one uniform draw an element)."""
    std = math.sqrt(1.0 / max(weight[0].numel(), 1)) / .87962566103423978
    edge = math.erf(2.0 / math.sqrt(2.0))       # 2 Phi(2) - 1
    with torch.no_grad():
        weight.uniform_(-edge, edge, generator=generator)
        weight.erfinv_().mul_(std * math.sqrt(2.0))
        return weight.clamp_(-2 * std, 2 * std)


def uniform_bias_init(bias: torch.Tensor, fan_in: int,
                      generator: torch.Generator) -> torch.Tensor:
    """uniform(±1/sqrt(fan_in)) with an explicit fan (a bias is 1-D), the
    JAX package's uniform_bias_init."""
    return uniform_(bias, fan_in, generator)


def same_pads(size: int, kernel: int, stride: int):
    """flax/XLA SAME padding (lo, hi) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class _FlaxBatchNorm(nn.modules.batchnorm._BatchNorm):
    """torch BatchNorm with flax nnx.BatchNorm's train-mode running stats.

    Same parameters and buffers as nn.BatchNorm* (weight, bias,
    running_mean, running_var, num_batches_tracked), so state_dicts and
    utils/convert.py see no difference. Train mode normalises with the
    biased batch variance, as torch does, and updates
        mean <- (1 - m) mean + m mu,   var <- (1 - m) var + m sigma^2_biased
    with m = `momentum` (0.01, flax's 0.99), as flax does."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        dims = [0] + list(range(2, x.dim()))
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=dims, unbiased=False)
            keep = 1.0 - self.momentum
            self.running_mean.copy_(keep * self.running_mean +
                                    self.momentum * mean)
            self.running_var.copy_(keep * self.running_var +
                                   self.momentum * var)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass


class Sequential(nn.Module):
    """nnx.Sequential's layout: the parts in `layers`, applied in order, so
    that the JAX package's dotted paths (`stem1.layers.0.kernel`) name the
    same submodules."""

    def __init__(self, *layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class ConvBNReLU(nn.Module):
    """Conv2D (no bias, SAME) -> BatchNorm(eps 1e-3) -> ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, *, generator: torch.Generator = None,
                 eps: float = 1e-3, momentum: float = 0.01):
        super().__init__()
        self.conv = nn.utils.skip_init(
            nn.Conv2d, in_channels, out_channels, kernel_size, stride,
            padding=0, bias=False)
        uniform_(self.conv.weight, in_channels * kernel_size ** 2,
                 default_generator(generator))
        self.bn = BatchNorm2d(out_channels, eps=eps, momentum=momentum)

    def forward(self, x):
        k, s = self.conv.kernel_size[0], self.conv.stride[0]
        ph = same_pads(x.shape[2], k, s)
        pw = same_pads(x.shape[3], k, s)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            # symmetric: the conv pads itself, no padded copy
            y = F.conv2d(x, self.conv.weight, None, s, (ph[0], pw[0]))
        else:
            y = self.conv(F.pad(x, (pw[0], pw[1], ph[0], ph[1])))
        return torch.relu(self.bn(y))


class DeconvBNReLU(nn.Module):
    """ConvTranspose2D (no bias, VALID) -> BatchNorm -> ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, *, generator: torch.Generator = None,
                 eps: float = 1e-3, momentum: float = 0.01):
        super().__init__()
        self.deconv = nn.utils.skip_init(
            nn.ConvTranspose2d, in_channels, out_channels, kernel_size,
            stride, padding=0, bias=False)
        uniform_(self.deconv.weight, in_channels * kernel_size ** 2,
                 default_generator(generator))
        self.bn = BatchNorm2d(out_channels, eps=eps, momentum=momentum)

    def forward(self, x):
        return torch.relu(self.bn(self.deconv(x)))


class LinearBN1DReLU(nn.Module):
    """Linear (no bias) -> BatchNorm over the last axis -> ReLU, on
    [..., in_features] with any leading dimensions (train-mode statistics
    over all of them). The buffer PillarFeatureNet calls it on [B, V, P,
    C]; the fused pillar path calls it only to train a PFN of two or more
    layers, and otherwise runs the layer inside its kernels
    (ops/pillar_ops.py: the BN folded from running stats in eval, from
    batch stats in one-layer train) and reads the parameters only."""

    def __init__(self, in_features: int, out_features: int, *,
                 generator: torch.Generator = None, eps: float = 1e-3,
                 momentum: float = 0.01):
        super().__init__()
        self.linear = nn.utils.skip_init(nn.Linear, in_features,
                                         out_features, bias=False)
        uniform_(self.linear.weight, in_features,
                 default_generator(generator))
        self.bn = BatchNorm1d(out_features, eps=eps, momentum=momentum)

    def forward(self, x):
        y = self.linear(x)
        # BatchNorm1d normalises axis 1: fold the leading dims into rows
        return torch.relu(self.bn(y.reshape(-1, y.shape[-1])).reshape(
            y.shape))


def heatmap_nms(heatmap: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Keep the local maxima of an NHWC heatmap [B, H, W, C], zero the rest
    (the maxpool trick). max_pool2d pads with -inf, as the JAX package's
    reduce_window does; a plateau keeps every cell equal to its window's
    max. -> NHWC, a view of an NCHW tensor."""
    x = heatmap.permute(0, 3, 1, 2)
    hmax = F.max_pool2d(x, kernel, 1, (kernel - 1) // 2)
    return torch.where(hmax == x, x, 0.).permute(0, 2, 3, 1)


def gather_topk_feat(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of feat [B, N, C] at idx [B, K] -> [B, K, C]: the row gather
    K14 (ops/gather.gather_rows; forward only), the JAX package's
    take_along_axis."""
    return gather.gather_rows(feat, idx.to(torch.int32))
