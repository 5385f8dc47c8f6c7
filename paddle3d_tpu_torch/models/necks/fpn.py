"""FPN necks for camera models, torch port of
paddle3d_tpu/models/necks/fpn.py (FPN, CPFPN, FPNC, and the P6 / P7 top
blocks LastLevelP6 and LastLevelP6P7).

NCHW. The top-down path upsamples with jax.image.resize's "nearest", which
samples the source at floor((i + 0.5) * in / out): torch's
"nearest-exact" ("nearest" takes floor(i * in / out), another cell at odd
sizes). The convs pad (k - 1) // 2 a side, as the JAX package gives it
explicitly, with uniform(±1/sqrt(fan_in)) weights and biases from an
explicit torch.Generator (default seed 0). FPNC upsamples its coarser
levels with jax.image.resize's "bilinear", which upsampling is torch's
align_corners=False. The top blocks' stride-2 convs are nnx.Conv's
defaults: flax SAME padding ((0, 1) over an even size), lecun-normal
kernels, zero biases.
"""
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...apis import manager
from ..layers.layer_libs import (default_generator, lecun_normal_,
                                 same_pads, uniform_bias_init, uniform_init)

__all__ = ["FPN", "CPFPN", "FPNC", "LastLevelP6", "LastLevelP6P7"]


def _conv(cin, cout, k, stride=1, *, generator):
    conv = nn.utils.skip_init(nn.Conv2d, cin, cout, k, stride,
                              padding=(k - 1) // 2)
    uniform_init(conv.weight, generator)
    uniform_bias_init(conv.bias, cin * k * k, generator)
    return conv


def _upsample_to(x, like):
    return F.interpolate(x, size=like.shape[-2:], mode="nearest-exact")


@manager.NECKS.add_component
class FPN(nn.Module):
    def __init__(self,
                 in_channels: Sequence[int],
                 out_channels: int = 256,
                 num_outs: int = None,
                 start_level: int = 0,
                 add_extra_convs=False,
                 relu_before_extra_convs: bool = False,
                 top_block=None,
                 generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        self.top_block = top_block
        self.start_level = start_level
        self.num_ins = len(in_channels)
        self.num_outs = num_outs or (self.num_ins - start_level)
        self.add_extra_convs = add_extra_convs
        self.out_channels = out_channels
        self.relu_before_extra_convs = relu_before_extra_convs

        self.lateral_convs = nn.ModuleList([
            _conv(in_channels[i], out_channels, 1, generator=generator)
            for i in range(start_level, self.num_ins)])
        self.fpn_convs = nn.ModuleList([
            _conv(out_channels, out_channels, 3, generator=generator)
            for _ in range(start_level, self.num_ins)])
        n_extra = self.num_outs - (self.num_ins - start_level)
        extra = []
        for i in range(n_extra):
            cin = in_channels[-1] if (i == 0 and
                                      add_extra_convs == "on_input") \
                else out_channels
            extra.append(_conv(cin, out_channels, 3, 2, generator=generator))
        self.extra_convs = nn.ModuleList(extra)

    def _laterals(self, inputs):
        laterals = [conv(inputs[self.start_level + i])
                    for i, conv in enumerate(self.lateral_convs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + _upsample_to(
                laterals[i], laterals[i - 1])
        return laterals

    def forward(self, inputs):
        """inputs: tuple of NCHW maps, finest first -> tuple of NCHW maps
        of out_channels."""
        outs = [conv(lat) for conv, lat in
                zip(self.fpn_convs, self._laterals(inputs))]
        if self.num_outs > len(outs):
            if len(self.extra_convs):
                x = inputs[-1] if self.add_extra_convs == "on_input" else \
                    outs[-1]
                for i, conv in enumerate(self.extra_convs):
                    if i > 0 and self.relu_before_extra_convs:
                        x = torch.relu(x)
                    x = conv(x)
                    outs.append(x)
            else:
                while len(outs) < self.num_outs:
                    outs.append(F.max_pool2d(outs[-1], 1, 2))
        if self.top_block is not None:
            src = inputs[-1] if getattr(self.top_block, "in_feature",
                                        "p5").startswith("res") else outs[-1]
            outs = list(outs) + list(self.top_block(src))
        return tuple(outs)


@manager.NECKS.add_component
class CPFPN(FPN):
    """PETR's neck: FPN's lateral and top-down structure, the 3x3
    smoothing conv on the first level only."""

    def __init__(self, in_channels, out_channels=256, num_outs=None,
                 generator: torch.Generator = None):
        super().__init__(in_channels, out_channels, num_outs,
                         generator=generator)
        self.fpn_convs = nn.ModuleList([self.fpn_convs[0]])

    def forward(self, inputs):
        laterals = self._laterals(inputs)
        return (self.fpn_convs[0](laterals[0]),) + tuple(laterals[1:])


@manager.NECKS.add_component
class FPNC(FPN):
    """BEVFusion's camera neck: FPN's levels, the coarser ones upsampled
    bilinearly to the finest, concatenated and fused by a 3 x 3 conv into
    one map: a 1-tuple of NCHW [B, fuse_channels, H, W]."""

    def __init__(self, in_channels, out_channels=256, num_outs=None,
                 final_dim=None, fuse_channels=None,
                 generator: torch.Generator = None):
        generator = default_generator(generator)
        super().__init__(in_channels, out_channels, num_outs,
                         generator=generator)
        fuse_channels = fuse_channels or out_channels
        self.fuse = _conv(out_channels * len(in_channels), fuse_channels, 3,
                          generator=generator)
        self.out_channels = fuse_channels

    def forward(self, inputs):
        outs = super().forward(inputs)
        ups = [outs[0]] + [F.interpolate(o, size=outs[0].shape[-2:],
                                         mode="bilinear", align_corners=False)
                           for o in outs[1:]]
        return (self.fuse(torch.cat(ups, dim=1)),)


class _SameConv(nn.Conv2d):
    """A conv with flax SAME padding (padded in forward)."""

    def forward(self, x):
        ph = same_pads(x.shape[2], 3, 2)
        pw = same_pads(x.shape[3], 3, 2)
        return super().forward(F.pad(x, (pw[0], pw[1], ph[0], ph[1])))


def _same_conv(cin, cout, generator):
    """nnx.Conv(kernel 3, stride 2, "SAME") with its default init:
    lecun-normal kernel, zero bias."""
    conv = nn.utils.skip_init(_SameConv, cin, cout, 3, 2, padding=0)
    lecun_normal_(conv.weight, generator)
    nn.init.zeros_(conv.bias)
    return conv


@manager.NECKS.add_component
class LastLevelP6(nn.Module):
    """FPN top block: P6 from P5 (or from the last input when in_feature
    names a "res" level) by one stride-2 conv."""

    def __init__(self, in_channels: int, out_channels: int,
                 in_feature: str = "p5", generator: torch.Generator = None):
        super().__init__()
        self.in_feature = in_feature
        self.p6 = _same_conv(in_channels, out_channels,
                             default_generator(generator))

    def forward(self, x):
        return [self.p6(x)]


@manager.NECKS.add_component
class LastLevelP6P7(nn.Module):
    """FPN top block: P6 and P7, stride-2 convs with a ReLU between."""

    def __init__(self, in_channels: int, out_channels: int,
                 in_feature: str = "p5", generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        self.in_feature = in_feature
        self.p6 = _same_conv(in_channels, out_channels, generator)
        self.p7 = _same_conv(out_channels, out_channels, generator)

    def forward(self, x):
        p6 = self.p6(x)
        return [p6, self.p7(torch.relu(p6))]
