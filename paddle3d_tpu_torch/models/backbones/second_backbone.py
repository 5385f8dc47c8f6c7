"""SECOND backbone, torch port of
paddle3d_tpu/models/backbones/second_backbone.py (SecondBackbone,
BaseBEVBackbone).

Plain strided conv stages, NCHW, on cuDNN.
"""
from typing import Sequence

import torch
from torch import nn

from ...apis import manager
from ..layers.layer_libs import ConvBNReLU, default_generator
from ..necks.second_fpn import SecondFPN

__all__ = ["SecondBackbone", "BaseBEVBackbone"]


@manager.BACKBONES.add_component
class SecondBackbone(nn.Module):
    def __init__(self,
                 in_channels: int = 128,
                 out_channels: Sequence[int] = (128, 128, 256),
                 layer_nums: Sequence[int] = (3, 5, 5),
                 downsample_strides: Sequence[int] = (2, 2, 2),
                 generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        if not len(out_channels) == len(layer_nums) == len(
                downsample_strides):
            raise ValueError("out_channels, layer_nums and "
                             "downsample_strides differ in length")
        self.downsample_strides = list(downsample_strides)
        in_filters = [in_channels, *out_channels[:-1]]
        blocks = []
        for i, layer_num in enumerate(layer_nums):
            block = [ConvBNReLU(in_filters[i], out_channels[i], 3,
                                stride=downsample_strides[i],
                                generator=generator)]
            for _ in range(layer_num):
                block.append(ConvBNReLU(out_channels[i], out_channels[i], 3,
                                        generator=generator))
            blocks.append(nn.ModuleList(block))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        outs = []
        for block in self.blocks:
            for layer in block:
                x = layer(x)
            outs.append(x)
        return tuple(outs)


@manager.BACKBONES.add_component
class BaseBEVBackbone(nn.Module):
    """SECOND-style dense BEV backbone that returns a single fused map
    (reference: paddle3d/models/backbones/base_bev_backbone.py): the
    SecondBackbone's strided blocks, then the SecondFPN's deconvs to a
    common stride, concatenated. CADDN's BEV net; NCHW in and out."""

    def __init__(self,
                 in_channels: int = 64,
                 layer_nums: Sequence[int] = (5, 5),
                 layer_strides: Sequence[int] = (1, 2),
                 num_filters: Sequence[int] = (128, 256),
                 upsample_strides: Sequence[int] = (1, 2),
                 num_upsample_filters: Sequence[int] = (256, 256),
                 generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        self.blocks = SecondBackbone(in_channels, num_filters, layer_nums,
                                     layer_strides, generator=generator)
        self.fuse = SecondFPN(num_filters, num_upsample_filters,
                              upsample_strides, generator=generator)
        self.out_channels = sum(num_upsample_filters)

    def forward(self, x):
        return self.fuse(self.blocks(x))
