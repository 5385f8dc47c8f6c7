"""ResNet backbone, torch port of paddle3d_tpu/models/backbones/resnet.py
(BasicBlock, Bottleneck, ResNet).

NCHW on cuDNN, with the JAX package's module tree (so that its dotted
parameter paths name the same submodules) and its conventions:
  * the convs pad symmetrically, dilation * (k - 1) // 2 a side, as the JAX
    package gives them explicitly; the stem's max pool is 3x3 / 2 with one
    cell of -inf padding a side;
  * BatchNorm eps 1e-5 and flax momentum 0.9 (torch momentum 0.1), with
    flax's running-stat update in train mode (layer_libs.BatchNorm2d).
Weights are uniform(±1/sqrt(fan_in)) from an explicit torch.Generator
(default seed 0). The JAX package's frozen_stages and norm_eval are kept as
attributes; neither changes its forward, nor the port's.
"""
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...apis import manager
from ..layers.layer_libs import BatchNorm2d, default_generator, uniform_init

__all__ = ["ResNet", "BasicBlock", "Bottleneck"]


def _conv(cin, cout, k, stride=1, dilation=1, *, generator=None):
    conv = nn.utils.skip_init(nn.Conv2d, cin, cout, k, stride,
                              padding=dilation * (k - 1) // 2,
                              dilation=dilation, bias=False)
    uniform_init(conv.weight, default_generator(generator))
    return conv


def _bn(c):
    return BatchNorm2d(c, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, cout, stride=1, dilation=1, downsample=False, *,
                 generator=None):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride, dilation,
                           generator=generator)
        self.bn1 = _bn(cout)
        self.conv2 = _conv(cout, cout, 3, 1, dilation, generator=generator)
        self.bn2 = _bn(cout)
        if downsample:
            self.down_conv = _conv(cin, cout, 1, stride, generator=generator)
            self.down_bn = _bn(cout)
        else:
            self.down_conv = None

    def forward(self, x):
        identity = x
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.down_conv is not None:
            identity = self.down_bn(self.down_conv(x))
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, dilation=1, downsample=False,
                 *, generator=None):
        super().__init__()
        cout = planes * self.expansion
        self.conv1 = _conv(cin, planes, 1, generator=generator)
        self.bn1 = _bn(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation,
                           generator=generator)
        self.bn2 = _bn(planes)
        self.conv3 = _conv(planes, cout, 1, generator=generator)
        self.bn3 = _bn(cout)
        if downsample:
            self.down_conv = _conv(cin, cout, 1, stride, generator=generator)
            self.down_bn = _bn(cout)
        else:
            self.down_conv = None

    def forward(self, x):
        identity = x
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.down_conv is not None:
            identity = self.down_bn(self.down_conv(x))
        return torch.relu(out + identity)


_ARCH = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


@manager.BACKBONES.add_component
class ResNet(nn.Module):
    def __init__(self,
                 depth: int = 50,
                 in_channels: int = 3,
                 base_channels: int = 64,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 frozen_stages: int = -1,
                 norm_eval: bool = False,
                 layers: int = None,
                 return_idx: Sequence[int] = None,
                 generator: torch.Generator = None):
        super().__init__()
        # the reference configs' synonyms: paddleseg's ResNet says `layers`,
        # paddledet's `return_idx`
        if layers is not None:
            depth = layers
        if return_idx is not None:
            out_indices = return_idx
        generator = default_generator(generator)
        block, layer_nums = _ARCH[depth]
        self.depth = depth
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval

        self.stem_conv = _conv(in_channels, base_channels, 7, 2,
                               generator=generator)
        self.stem_bn = _bn(base_channels)
        stages = []
        cin = base_channels
        self.out_channels = []
        for i, n in enumerate(layer_nums):
            planes = base_channels * (2 ** i)
            blocks = []
            for j in range(n):
                stride = strides[i] if j == 0 else 1
                need_down = (j == 0 and
                             (stride != 1 or cin != planes * block.expansion))
                blocks.append(block(cin, planes, stride, dilations[i],
                                    downsample=need_down,
                                    generator=generator))
                cin = planes * block.expansion
            stages.append(nn.ModuleList(blocks))
            self.out_channels.append(cin)
        self.stages = nn.ModuleList(stages)

    def forward(self, x):
        """x [B, 3, H, W] -> tuple of the stage outputs at out_indices."""
        x = torch.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for i, stage in enumerate(self.stages):
            for blk in stage:
                x = blk(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
