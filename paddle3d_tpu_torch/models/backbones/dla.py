"""DLA backbone with DLAUp / IDAUp aggregation, torch port of
paddle3d_tpu/models/backbones/dla.py (BasicBlock, Root, Tree, DLABase,
_UpConv, IDAUp, DLAUp, DLA, DLA34, and DD3D's multi-scale trunk
DLABase34).

NCHW on cuDNN, with the JAX package's module tree and its conventions:
  * GroupNorm with min(32, c) groups and flax's eps 1e-6 (torch's default is
    1e-5); flax computes the variance as E[x^2] - E[x]^2, torch in two
    passes: the two agree to f32 rounding (tests/test_torch_smoke.py
    states the tolerance);
  * the convs pad symmetrically, (k - 1) // 2 a side, as the JAX package
    gives them explicitly; Tree's downsampling max pool is VALID;
  * IDAUp's upsampling nnx.ConvTranspose(kernel 2f, stride f, "SAME") is
    ConvTranspose2d(padding f // 2) with the kernel flipped
    (utils/convert.py flips it), initialised, as on the JAX side, to a
    depthwise bilinear upsampler, so that seeded random weights upsample
    smoothly.
  * the "bn" norm is flax's nnx.BatchNorm(eps 1e-5, momentum 0.9): torch
    momentum 0.1 with flax's biased running variance (layer_libs
    .BatchNorm2d); batch statistics in train mode, the running averages in
    eval mode, as the JAX package's model.eval() (use_running_average)
    gives them. DLABase34 reads "frozen_bn" as "bn", as the JAX package
    does.
Other weights are uniform(±1/sqrt(fan_in)) from an explicit
torch.Generator (default seed 0).
"""
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...apis import manager
from ..layers.layer_libs import BatchNorm2d, default_generator, uniform_init

__all__ = ["DLA", "DLA34", "DLABase34"]

GN_EPS = 1e-6       # flax nnx.GroupNorm's epsilon
BN_EPS = 1e-5       # the "bn" norm: nnx.BatchNorm(epsilon=1e-5,
BN_MOMENTUM = 0.1   # momentum=0.9), torch's momentum 1 - 0.9


def _norm(c, norm_type):
    if norm_type == "gn":
        return nn.GroupNorm(min(32, c), c, eps=GN_EPS)
    if norm_type == "bn":
        return BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)
    raise ValueError("DLA norm_type {!r}: 'gn' or 'bn'".format(norm_type))


def _conv(cin, cout, k, stride=1, dilation=1, *, generator=None):
    conv = nn.utils.skip_init(nn.Conv2d, cin, cout, k, stride,
                              padding=dilation * (k - 1) // 2,
                              dilation=dilation, bias=False)
    uniform_init(conv.weight, generator)
    return conv


def bilinear_up_weight(factor: int, cin: int, cout: int) -> torch.Tensor:
    """The JAX package's _bilinear_up_init (depthwise bilinear kernels of
    size 2 * factor on the first min(cin, cout) channel pairs) in torch's
    ConvTranspose2d layout (in, out, kH, kW); the kernel is symmetric, so
    the flip between the two conventions leaves it as it is."""
    k = 2 * factor
    c = (2 * factor - 1 - factor % 2) / (2.0 * factor)
    w = 1 - np.abs(np.arange(k) / factor - c)
    kern = np.zeros((cin, cout, k, k), np.float32)
    eye = np.arange(min(cin, cout))
    kern[eye, eye] = w[:, None] * w[None, :]
    return torch.from_numpy(kern)


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1, dilation=1, norm_type="gn", *,
                 generator=None):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride, dilation,
                           generator=generator)
        self.norm1 = _norm(cout, norm_type)
        self.conv2 = _conv(cout, cout, 3, 1, dilation, generator=generator)
        self.norm2 = _norm(cout, norm_type)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = torch.relu(self.norm1(self.conv1(x)))
        out = self.norm2(self.conv2(out))
        return torch.relu(out + residual)


class Root(nn.Module):
    def __init__(self, cin, cout, kernel_size, residual, norm_type, *,
                 generator=None):
        super().__init__()
        self.conv = _conv(cin, cout, kernel_size, generator=generator)
        self.norm = _norm(cout, norm_type)
        self.residual = residual

    def forward(self, *xs):
        x = self.norm(self.conv(torch.cat(xs, dim=1)))
        if self.residual:
            x = x + xs[0]
        return torch.relu(x)


class Tree(nn.Module):
    def __init__(self, levels, cin, cout, stride=1, level_root=False,
                 root_dim=0, root_kernel_size=1, dilation=1,
                 root_residual=False, norm_type="gn", *, generator=None):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * cout
        if level_root:
            root_dim += cin
        self.levels = levels
        self.level_root = level_root
        self.stride = stride
        if levels == 1:
            self.tree1 = BasicBlock(cin, cout, stride, dilation, norm_type,
                                    generator=generator)
            self.tree2 = BasicBlock(cout, cout, 1, dilation, norm_type,
                                    generator=generator)
            self.root = Root(root_dim, cout, root_kernel_size, root_residual,
                             norm_type, generator=generator)
        else:
            self.tree1 = Tree(levels - 1, cin, cout, stride, root_dim=0,
                              root_kernel_size=root_kernel_size,
                              dilation=dilation, root_residual=root_residual,
                              norm_type=norm_type, generator=generator)
            self.tree2 = Tree(levels - 1, cout, cout, root_dim=root_dim + cout,
                              root_kernel_size=root_kernel_size,
                              dilation=dilation, root_residual=root_residual,
                              norm_type=norm_type, generator=generator)
            self.root = None
        if cin != cout:
            self.project_conv = _conv(cin, cout, 1, generator=generator)
            self.project_norm = _norm(cout, norm_type)
        else:
            self.project_conv = None

    def forward(self, x, residual=None, children=None):
        children = [] if children is None else children
        bottom = F.max_pool2d(x, self.stride) if self.stride > 1 else x
        if self.project_conv is not None:
            residual = self.project_norm(self.project_conv(bottom))
        else:
            residual = bottom
        if self.level_root:
            children.append(bottom)
        x1 = self.tree1(x, residual)
        if self.levels == 1:
            x2 = self.tree2(x1)
            return self.root(x2, x1, *children)
        children.append(x1)
        return self.tree2(x1, children=children)


class DLABase(nn.Module):
    def __init__(self, levels, channels, norm_type="gn", *, generator=None):
        super().__init__()
        self.channels = channels
        self.base_conv = _conv(3, channels[0], 7, generator=generator)
        self.base_norm = _norm(channels[0], norm_type)
        self.level0_conv = _conv(channels[0], channels[0], 3,
                                 generator=generator)
        self.level0_norm = _norm(channels[0], norm_type)
        self.level1_conv = _conv(channels[0], channels[1], 3, stride=2,
                                 generator=generator)
        self.level1_norm = _norm(channels[1], norm_type)
        self.level2 = Tree(levels[2], channels[1], channels[2], 2,
                           level_root=False, norm_type=norm_type,
                           generator=generator)
        self.level3 = Tree(levels[3], channels[2], channels[3], 2,
                           level_root=True, norm_type=norm_type,
                           generator=generator)
        self.level4 = Tree(levels[4], channels[3], channels[4], 2,
                           level_root=True, norm_type=norm_type,
                           generator=generator)
        self.level5 = Tree(levels[5], channels[4], channels[5], 2,
                           level_root=True, norm_type=norm_type,
                           generator=generator)

    def forward(self, x):
        x = torch.relu(self.base_norm(self.base_conv(x)))
        x = torch.relu(self.level0_norm(self.level0_conv(x)))
        y = [x]
        x = torch.relu(self.level1_norm(self.level1_conv(x)))
        y.append(x)
        for lvl in (self.level2, self.level3, self.level4, self.level5):
            x = lvl(x)
            y.append(x)
        return y


class _UpConv(nn.Module):
    """proj conv + learnable factor-f upsample (a transposed conv) + node
    conv, used by IDAUp."""

    def __init__(self, cin, cout, factor, norm_type, *, generator=None):
        super().__init__()
        self.proj_conv = _conv(cin, cout, 3, generator=generator)
        self.proj_norm = _norm(cout, norm_type)
        self.factor = factor
        if factor > 1:
            if factor % 2:
                raise ValueError("IDAUp upsamples by even factors (SAME "
                                 "padding is f // 2 a side then), got "
                                 "{}".format(factor))
            self.up = nn.utils.skip_init(
                nn.ConvTranspose2d, cout, cout, 2 * factor, factor,
                padding=factor // 2, bias=False)
            with torch.no_grad():
                self.up.weight.copy_(bilinear_up_weight(factor, cout, cout))
        else:
            self.up = None
        self.node_conv = _conv(cout, cout, 3, generator=generator)
        self.node_norm = _norm(cout, norm_type)

    def project(self, x):
        return torch.relu(self.proj_norm(self.proj_conv(x)))

    def upsample(self, x):
        return self.up(x) if self.up is not None else x

    def node(self, x):
        return torch.relu(self.node_norm(self.node_conv(x)))


class IDAUp(nn.Module):
    def __init__(self, in_channels, out_channel, up_f, norm_type="gn", *,
                 generator=None):
        super().__init__()
        self.ups = nn.ModuleList([
            _UpConv(in_channels[i], out_channel, int(up_f[i]), norm_type,
                    generator=generator) for i in range(1, len(in_channels))
        ])
        if in_channels[0] != out_channel:
            self.first_proj = _UpConv(in_channels[0], out_channel, 1,
                                      norm_type, generator=generator)
        else:
            self.first_proj = None

    def forward(self, layers, startp, endp):
        """Aggregates layers[startp:endp] in place, as the JAX IDAUp does."""
        if self.first_proj is not None:
            layers[startp] = self.first_proj.project(layers[startp])
        for i in range(startp + 1, endp):
            upc = self.ups[i - startp - 1]
            x = upc.upsample(upc.project(layers[i]))
            layers[i] = upc.node(x + layers[i - 1])
        return layers


class DLAUp(nn.Module):
    def __init__(self, startp, channels, scales, norm_type="gn", *,
                 generator=None):
        super().__init__()
        self.startp = startp
        channels = list(channels)
        scales = list(scales)
        idas = []
        for i in range(len(channels) - 1):
            j = -i - 2
            idas.append(IDAUp(channels[j:], channels[j],
                              [s // scales[j] for s in scales[j:]],
                              norm_type, generator=generator))
            scales[j + 1:] = [scales[j] for _ in scales[j + 1:]]
            channels[j + 1:] = [channels[j] for _ in channels[j + 1:]]
        self.idas = nn.ModuleList(idas)

    def forward(self, layers):
        out = [layers[-1]]
        layers = list(layers)
        for i, ida in enumerate(self.idas):
            ida(layers, len(layers) - i - 2, len(layers))
            out.insert(0, layers[-1])
        return out


@manager.BACKBONES.add_component
class DLA(nn.Module):
    """levels / channels configurable; DLA-34's by default. NCHW images in,
    the down_ratio map [B, out_channels, H / d, W / d] out."""

    def __init__(self,
                 levels: Sequence[int] = (1, 1, 1, 2, 2, 1),
                 channels: Sequence[int] = (16, 32, 64, 128, 256, 512),
                 down_ratio: int = 4,
                 last_level: int = 5,
                 out_channel: int = 0,
                 norm_type: str = "gn",
                 pretrained: str = None,
                 generator: torch.Generator = None):
        super().__init__()
        self.pretrained = pretrained      # unread, as in the JAX package
        generator = default_generator(generator)
        self.first_level = int(math.log2(down_ratio))
        self.last_level = last_level
        self.base = DLABase(list(levels), list(channels), norm_type,
                            generator=generator)
        scales = [2 ** i for i in range(len(channels[self.first_level:]))]
        self.dla_up = DLAUp(self.first_level, channels[self.first_level:],
                            scales, norm_type, generator=generator)
        if out_channel == 0:
            out_channel = channels[self.first_level]
        self.out_channels = out_channel
        up_scales = [2 ** i for i in
                     range(self.last_level - self.first_level)]
        self.ida_up = IDAUp(
            list(channels[self.first_level:self.last_level]), out_channel,
            up_scales, norm_type, generator=generator)

    def forward(self, x):
        x = self.dla_up(self.base(x))
        y = [x[i] for i in range(self.last_level - self.first_level)]
        self.ida_up(y, 0, len(y))
        return y[-1]


@manager.BACKBONES.add_component
def DLA34(**kwargs):
    return DLA(levels=(1, 1, 1, 2, 2, 1),
               channels=(16, 32, 64, 128, 256, 512), **kwargs)


@manager.BACKBONES.add_component
class DLABase34(nn.Module):
    """DD3D's multi-scale DLA-34 trunk: DLABase's levels at out_features
    (3, 4, 5: strides 8, 16, 32, channels 128, 256, 512) for an FPN. NCHW
    images in, a list of NCHW maps out."""

    _CHANNELS = (16, 32, 64, 128, 256, 512)

    def __init__(self,
                 out_features: Sequence[int] = (3, 4, 5),
                 norm_type: str = "bn",
                 pretrained: str = None,
                 generator: torch.Generator = None):
        super().__init__()
        self.pretrained = pretrained      # unread, as in the JAX package
        if norm_type == "frozen_bn":      # read as plain BN, as there
            norm_type = "bn"
        self.out_features = list(out_features)
        self.base = DLABase([1, 1, 1, 2, 2, 1], list(self._CHANNELS),
                            norm_type, generator=default_generator(generator))
        self.out_channels = [self._CHANNELS[i] for i in self.out_features]

    def forward(self, x):
        y = self.base(x)
        return [y[i] for i in self.out_features]
