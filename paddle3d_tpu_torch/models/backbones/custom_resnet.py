"""BEV-space ResNet, torch port of
paddle3d_tpu/models/backbones/custom_resnet.py (CustomResNet, the BEVDet
BEV encoder): stages of the port's resnet.BasicBlock (BatchNorm eps 1e-5),
the first block of a stage strided with a 1 x 1 downsample, NCHW."""
from typing import Sequence

import torch
from torch import nn

from ...apis import manager
from ..layers.layer_libs import default_generator
from .resnet import BasicBlock

__all__ = ["CustomResNet"]


@manager.BACKBONES.add_component
class CustomResNet(nn.Module):
    def __init__(self,
                 numC_input: int,
                 num_layer: Sequence[int] = (2, 2, 2),
                 num_channels: Sequence[int] = None,
                 stride: Sequence[int] = (2, 2, 2),
                 backbone_output_ids: Sequence[int] = None,
                 generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        num_channels = (list(num_channels) if num_channels is not None else
                        [numC_input * 2 ** (i + 1)
                         for i in range(len(num_layer))])
        self.backbone_output_ids = (list(backbone_output_ids)
                                    if backbone_output_ids is not None else
                                    list(range(len(num_layer))))
        stages = []
        cin = numC_input
        for i, n in enumerate(num_layer):
            blocks = [BasicBlock(cin, num_channels[i], stride=stride[i],
                                 downsample=True, generator=generator)]
            blocks += [BasicBlock(num_channels[i], num_channels[i],
                                  generator=generator) for _ in range(n - 1)]
            stages.append(nn.ModuleList(blocks))
            cin = num_channels[i]
        self.stages = nn.ModuleList(stages)
        self.out_channels = num_channels

    def forward(self, x):
        """x [B, C, H, W] -> tuple of the stage outputs at
        backbone_output_ids."""
        outs = []
        for i, stage in enumerate(self.stages):
            for blk in stage:
                x = blk(x)
            if i in self.backbone_output_ids:
                outs.append(x)
        return tuple(outs)
