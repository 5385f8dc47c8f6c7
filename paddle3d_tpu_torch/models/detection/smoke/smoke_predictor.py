"""SMOKE predictor head, torch port of
paddle3d_tpu/models/detection/smoke/smoke_predictor.py (SMOKEPredictor).

Class heatmap head and regression head over the DLA map, NCHW on cuDNN.
Regression channels: depth 1 | keypoint offset 2 | dims 3 | orientation 2
(| 2-D box size 2); dims get sigmoid - 0.5 and the orientation is
L2-normalised here, as in the JAX package. Both outputs leave the head in
the JAX package's NHWC layout, as views of the NCHW maps (no copy): the
decode reads the regression map in place through them.
"""
from typing import Sequence

import torch
from torch import nn

from ....apis import manager
from ...backbones.dla import GN_EPS
from ...layers.layer_libs import default_generator, uniform_init

__all__ = ["SMOKEPredictor"]


@manager.MODELS.add_component
@manager.HEADS.add_component
class SMOKEPredictor(nn.Module):
    def __init__(self,
                 num_classes: int = 3,
                 reg_channels: Sequence[int] = (1, 2, 3, 2),
                 num_channels: int = 256,
                 norm_type: str = "gn",
                 in_channels: int = 64,
                 generator: torch.Generator = None):
        super().__init__()
        if norm_type != "gn":
            raise NotImplementedError(
                "SMOKEPredictor norm_type {!r}: the port has GroupNorm "
                "('gn'), the norm of every SMOKE config".format(norm_type))
        generator = default_generator(generator)
        self.num_classes = num_classes
        self.reg_channels = tuple(reg_channels)
        self.reg_heads = sum(reg_channels)
        ends = [sum(self.reg_channels[:i + 1])
                for i in range(len(self.reg_channels))]
        self.dim_slice = (ends[1], ends[2])
        self.ori_slice = (ends[2], ends[3])

        def conv(cin, cout, k, bias=0.0):
            c = nn.utils.skip_init(nn.Conv2d, cin, cout, k,
                                   padding=(k - 1) // 2)
            uniform_init(c.weight, generator)
            nn.init.constant_(c.bias, bias)
            return c

        def norm(c):
            return nn.GroupNorm(min(32, c), c, eps=GN_EPS)

        self.cls_conv1 = conv(in_channels, num_channels, 3)
        self.cls_norm = norm(num_channels)
        self.cls_conv2 = conv(num_channels, num_classes, 1, bias=-2.19)
        self.reg_conv1 = conv(in_channels, num_channels, 3)
        self.reg_norm = norm(num_channels)
        self.reg_conv2 = conv(num_channels, self.reg_heads, 1)

    def forward(self, features):
        """[B, C, H, W] -> (heatmap [B, H, W, num_classes] in (0, 1),
        regression [B, H, W, reg_heads]), NHWC views of NCHW maps."""
        hm = self.cls_conv2(torch.relu(self.cls_norm(self.cls_conv1(
            features))))
        hm = torch.clamp(torch.sigmoid(hm), 1e-4, 1 - 1e-4)
        reg = self.reg_conv2(torch.relu(self.reg_norm(self.reg_conv1(
            features))))
        d0, d1 = self.dim_slice
        o0, o1 = self.ori_slice
        dims = torch.sigmoid(reg[:, d0:d1]) - 0.5
        ori = reg[:, o0:o1]
        ori = ori / torch.clamp(torch.linalg.vector_norm(
            ori, dim=1, keepdim=True), min=1e-6)
        reg = torch.cat([reg[:, :d0], dims, ori, reg[:, o1:]], dim=1)
        return hm.permute(0, 2, 3, 1), reg.permute(0, 2, 3, 1)
