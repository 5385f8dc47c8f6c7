"""FPN_LSS neck, torch port of paddle3d_tpu/models/necks/lss_fpn.py: the
deep BEV stage resized bilinearly to the shallow one's size
(jax.image.resize's "bilinear" samples at half-pixel centres, torch's
align_corners=False), concatenated after it, then two 3 x 3 ConvBNReLU
(BatchNorm eps 1e-3). NCHW."""
import torch
import torch.nn.functional as F
from torch import nn

from ...apis import manager
from ..layers.layer_libs import ConvBNReLU, default_generator

__all__ = ["FPN_LSS"]


@manager.NECKS.add_component
class FPN_LSS(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 scale_factor: int = 4, generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        self.scale_factor = scale_factor
        self.conv1 = ConvBNReLU(in_channels, out_channels, 3,
                                generator=generator)
        self.conv2 = ConvBNReLU(out_channels, out_channels, 3,
                                generator=generator)

    def forward(self, feats):
        """feats: (shallow [B, C1, H, W], ..., deep [B, C2, H/s, W/s]) ->
        [B, out_channels, H, W]."""
        x1, x2 = feats[0], feats[-1]
        x2 = F.interpolate(x2, size=x1.shape[-2:], mode="bilinear",
                           align_corners=False)
        return self.conv2(self.conv1(torch.cat([x1, x2], dim=1)))
