"""FPN necks for camera models, torch port of
paddle3d_tpu/models/necks/fpn.py (FPN, CPFPN; FPNC and the P6 / P7 top
blocks arrive with BEVFusion and DD3D).

NCHW. The top-down path upsamples with jax.image.resize's "nearest", which
samples the source at floor((i + 0.5) * in / out): torch's
"nearest-exact" ("nearest" takes floor(i * in / out), another cell at odd
sizes). The convs pad (k - 1) // 2 a side, as the JAX package gives it
explicitly, with uniform(±1/sqrt(fan_in)) weights and biases from an
explicit torch.Generator (default seed 0).
"""
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...apis import manager
from ..layers.layer_libs import (default_generator, uniform_bias_init,
                                 uniform_init)

__all__ = ["FPN", "CPFPN"]


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
