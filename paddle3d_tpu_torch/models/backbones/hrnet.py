"""HRNet backbone, torch port of paddle3d_tpu/models/backbones/hrnet.py
(FuseLayer, Branch, Stage, HRNet, HRNet_W18): the SMOKE / CADDN
high-resolution branch.

Parallel multi-resolution streams with repeated cross-resolution fusion;
the highest-resolution stream, or the concat of all streams upsampled to
it, is the output. NCHW on cuDNN, with the JAX package's module tree:
  * layer_libs.Sequential keeps its parts in `layers`, as nnx.Sequential
    does, so the dotted paths name the same submodules; FuseLayer.projs
    holds a parameterless placeholder where the JAX package holds None
    (i == j), so the indices line up too;
  * `_conv_bn_relu`'s BatchNorm has nnx's defaults, eps 1e-5 and flax
    momentum 0.99 (torch momentum 0.01); the Bottleneck and BasicBlocks
    come from resnet.py (eps 1e-5, torch momentum 0.1);
  * jax.image.resize "nearest" picks source cell floor((i + 0.5) * in /
    out), which is torch's "nearest-exact" ("nearest" takes floor(i * in /
    out)); "bilinear" upsampling is torch's bilinear with
    align_corners=False. The two differ only where a ratio of stream sizes
    is not whole (an odd input size).
"""
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...apis import manager
from ..layers.layer_libs import (BatchNorm2d, Sequential, default_generator,
                                 uniform_init)
from .resnet import BasicBlock, Bottleneck

__all__ = ["HRNet", "HRNet_W18"]


def _conv_bn_relu(cin, cout, k, stride=1, relu=True, *, generator):
    conv = nn.utils.skip_init(nn.Conv2d, cin, cout, k, stride,
                              padding=(k - 1) // 2, bias=False)
    uniform_init(conv.weight, generator)
    layers = [conv, BatchNorm2d(cout, eps=1e-5, momentum=0.01)]
    if relu:
        layers.append(nn.ReLU())
    return Sequential(*layers)


class FuseLayer(nn.Module):
    """Cross-resolution fusion: every stream receives every other stream,
    resized and projected."""

    def __init__(self, channels: Sequence[int], *, generator):
        super().__init__()
        self.n = len(channels)
        projs = []
        for i in range(self.n):        # target stream
            row = []
            for j in range(self.n):    # source stream
                if i == j:
                    row.append(nn.Identity())       # nnx: None
                elif j > i:            # upsample the source
                    row.append(_conv_bn_relu(channels[j], channels[i], 1,
                                             relu=False,
                                             generator=generator))
                else:                  # downsample: a stride-2 chain
                    chain = []
                    c = channels[j]
                    for k in range(i - j):
                        cout = channels[i] if k == i - j - 1 else c
                        chain.append(_conv_bn_relu(
                            c, cout, 3, stride=2, relu=(k != i - j - 1),
                            generator=generator))
                        c = cout
                    row.append(Sequential(*chain))
            projs.append(nn.ModuleList(row))
        self.projs = nn.ModuleList(projs)

    def forward(self, xs):
        outs = []
        for i in range(self.n):
            acc = xs[i]
            for j in range(self.n):
                if i == j:
                    continue
                y = self.projs[i][j](xs[j])
                if y.shape[2:] != acc.shape[2:]:
                    y = F.interpolate(y, size=acc.shape[2:],
                                      mode="nearest-exact")
                acc = acc + y
            outs.append(torch.relu(acc))
        return outs


class Branch(nn.Module):
    def __init__(self, channels, num_blocks, *, generator):
        super().__init__()
        self.blocks = nn.ModuleList([
            BasicBlock(channels, channels, generator=generator)
            for _ in range(num_blocks)])

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x


class Stage(nn.Module):
    def __init__(self, channels: Sequence[int], num_blocks: int = 4, *,
                 generator):
        super().__init__()
        self.branches = nn.ModuleList([
            Branch(c, num_blocks, generator=generator) for c in channels])
        self.fuse = FuseLayer(channels, generator=generator)

    def forward(self, xs):
        return self.fuse([b(x) for b, x in zip(self.branches, xs)])


@manager.BACKBONES.add_component
class HRNet(nn.Module):
    def __init__(self, width: int = 18,
                 num_modules: Sequence[int] = (1, 1, 1),
                 concat_output: bool = True, pretrained: str = None,
                 generator: torch.Generator = None):
        super().__init__()
        self.pretrained = pretrained
        g = default_generator(generator)
        w = width
        self.channels = [w, w * 2, w * 4, w * 8]
        self.concat_output = concat_output

        self.stem1 = _conv_bn_relu(3, 64, 3, stride=2, generator=g)
        self.stem2 = _conv_bn_relu(64, 64, 3, stride=2, generator=g)
        # layer1: one bottleneck block, 64 -> 256
        self.layer1 = Bottleneck(64, 64, downsample=True, generator=g)
        self.trans1 = nn.ModuleList([
            _conv_bn_relu(256, self.channels[0], 3, generator=g),
            _conv_bn_relu(256, self.channels[1], 3, stride=2, generator=g)])
        self.stage2 = nn.ModuleList([
            Stage(self.channels[:2], generator=g)
            for _ in range(num_modules[0])])
        self.trans2 = _conv_bn_relu(self.channels[1], self.channels[2], 3,
                                    stride=2, generator=g)
        self.stage3 = nn.ModuleList([
            Stage(self.channels[:3], generator=g)
            for _ in range(num_modules[1])])
        self.trans3 = _conv_bn_relu(self.channels[2], self.channels[3], 3,
                                    stride=2, generator=g)
        self.stage4 = nn.ModuleList([
            Stage(self.channels, generator=g)
            for _ in range(num_modules[2])])
        self.out_channels = (sum(self.channels) if concat_output
                             else self.channels[0])

    def forward(self, x):
        """x [B, 3, H, W] -> [B, out_channels, H / 4, W / 4] (sizes rounded
        up at each stride-2 conv)."""
        x = self.layer1(self.stem2(self.stem1(x)))
        xs = [self.trans1[0](x), self.trans1[1](x)]
        for m in self.stage2:
            xs = m(xs)
        xs = xs + [self.trans2(xs[-1])]
        for m in self.stage3:
            xs = m(xs)
        xs = xs + [self.trans3(xs[-1])]
        for m in self.stage4:
            xs = m(xs)
        if not self.concat_output:
            return xs[0]
        size = xs[0].shape[2:]
        return torch.cat([xs[0]] + [
            F.interpolate(y, size=size, mode="bilinear", align_corners=False)
            for y in xs[1:]], dim=1)


@manager.BACKBONES.add_component
def HRNet_W18(**kwargs):
    return HRNet(width=18, **kwargs)
