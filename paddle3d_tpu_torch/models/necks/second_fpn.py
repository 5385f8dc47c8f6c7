"""SECOND FPN neck, torch port of paddle3d_tpu/models/necks/second_fpn.py.

Deconv branches upsample each backbone stage to a common resolution and
concatenate along channels (NCHW).
"""
from typing import Sequence

import torch
from torch import nn

from ...apis import manager
from ..layers.layer_libs import ConvBNReLU, DeconvBNReLU, default_generator

__all__ = ["SecondFPN"]


@manager.NECKS.add_component
class SecondFPN(nn.Module):
    def __init__(self,
                 in_channels: Sequence[int] = (128, 128, 256),
                 out_channels: Sequence[int] = (256, 256, 256),
                 upsample_strides: Sequence[int] = (1, 2, 4),
                 use_conv_for_no_stride: bool = False,
                 generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        if not len(out_channels) == len(upsample_strides) == len(in_channels):
            raise ValueError("in_channels, out_channels and upsample_strides "
                             "differ in length")
        self.upsample_strides = list(upsample_strides)
        deblocks = []
        for i, out_channel in enumerate(out_channels):
            stride = upsample_strides[i]
            if stride > 1 or (stride == 1 and not use_conv_for_no_stride):
                deblocks.append(DeconvBNReLU(
                    in_channels[i], out_channel, kernel_size=stride,
                    stride=stride, generator=generator))
            else:
                stride = round(1 / stride)
                deblocks.append(ConvBNReLU(
                    in_channels[i], out_channel, kernel_size=stride,
                    stride=stride, generator=generator))
        self.deblocks = nn.ModuleList(deblocks)

    def forward(self, xs):
        ups = [deblock(x) for x, deblock in zip(xs, self.deblocks)]
        if len(ups) > 1:
            return torch.cat(ups, dim=1)
        return ups[0]
