"""Semantic class heads of the CADDN camera branch, torch port of
paddle3d_tpu/models/heads/class_heads.py (_ConvBNReLU, ASPPModule,
DeepLabV3Head, SpatialGatherBlock, SpatialOCRModule, OCRNetHead).

The reference's CADDN image branch is a segmentation network whose
pre-logit features feed the frustum encoder: both heads expose
`features(feat_list)`, that representation, and `forward`, the semantic
logits. NCHW on cuDNN; the OCR attention (pixels x a few regions) runs as
plain matmuls over the [B, H*W, C] view, as the JAX package computes it
outside any Pallas kernel. BatchNorm has nnx's defaults: eps 1e-5, flax
momentum 0.99 (torch momentum 0.01). Weights are uniform(±1/sqrt(fan_in))
from an explicit torch.Generator (default seed 0), biases zero.
"""
from typing import Sequence

import torch
from torch import nn

from ...apis import manager
from ..layers.layer_libs import (BatchNorm2d, Sequential, default_generator,
                                 uniform_init)

__all__ = ["DeepLabV3Head", "OCRNetHead", "ASPPModule", "SpatialGatherBlock",
           "SpatialOCRModule"]


def _conv(cin, cout, k, dilation=1, bias=False, *, generator):
    conv = nn.utils.skip_init(nn.Conv2d, cin, cout, k,
                              padding=dilation * (k - 1) // 2,
                              dilation=dilation, bias=bias)
    uniform_init(conv.weight, generator)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


def _linear(cin, cout, *, generator):
    lin = nn.utils.skip_init(nn.Linear, cin, cout)
    uniform_init(lin.weight, generator)
    nn.init.zeros_(lin.bias)
    return lin


def _rows(x):
    """[B, C, H, W] -> the [B, H*W, C] view."""
    return x.flatten(2).transpose(1, 2)


class _ConvBNReLU(nn.Module):
    def __init__(self, cin, cout, k=3, dilation=1, *, generator=None):
        super().__init__()
        self.conv = _conv(cin, cout, k, dilation,
                          generator=default_generator(generator))
        self.bn = BatchNorm2d(cout, eps=1e-5, momentum=0.01)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class ASPPModule(nn.Module):
    """Atrous spatial pyramid pooling (reference: paddleseg's ASPPModule,
    used by deeplabv3_head.py)."""

    def __init__(self, ratios: Sequence[int], cin: int, cout: int, *,
                 generator=None):
        super().__init__()
        g = default_generator(generator)
        self.branches = nn.ModuleList([
            _ConvBNReLU(cin, cout, k=1 if r == 1 else 3, dilation=r,
                        generator=g) for r in ratios])
        self.img_pool_conv = _ConvBNReLU(cin, cout, k=1, generator=g)
        self.project = _ConvBNReLU(cout * (len(ratios) + 1), cout, k=1,
                                   generator=g)

    def forward(self, x):
        outs = [b(x) for b in self.branches]
        pooled = self.img_pool_conv(x.mean(dim=(2, 3), keepdim=True))
        outs.append(pooled.expand_as(outs[0]))
        return self.project(torch.cat(outs, dim=1))


def _pick(feat_list, index):
    return feat_list[index] if isinstance(feat_list, (list, tuple)) \
        else feat_list


@manager.HEADS.add_component
class DeepLabV3Head(nn.Module):
    """(reference: class_heads/deeplabv3_head.py:25)."""

    def __init__(self, num_classes: int, backbone_channels: int,
                 backbone_indices: Sequence[int] = (0,),
                 aspp_ratios: Sequence[int] = (1, 6, 12, 18),
                 aspp_out_channels: int = 256,
                 generator: torch.Generator = None, **unused):
        super().__init__()
        g = default_generator(generator)
        self.backbone_indices = tuple(backbone_indices)
        self.aspp = ASPPModule(aspp_ratios, backbone_channels,
                               aspp_out_channels, generator=g)
        self.conv_bn_relu = _ConvBNReLU(aspp_out_channels,
                                        aspp_out_channels, k=3, generator=g)
        self.cls = _conv(aspp_out_channels, num_classes, 1, bias=True,
                         generator=g)
        self.out_channels = aspp_out_channels

    def features(self, feat_list):
        return self.conv_bn_relu(self.aspp(
            _pick(feat_list, self.backbone_indices[0])))

    def forward(self, feat_list):
        return self.cls(self.features(feat_list))


class SpatialGatherBlock(nn.Module):
    """Pixel-region aggregation (reference: ocrnet_head.py
    SpatialGatherBlock): pixels [B, C, H, W], region logits [B, K, H, W]
    -> region features [B, K, C], each a softmax-over-pixels average."""

    def forward(self, pixels, regions):
        r = torch.softmax(_rows(regions), dim=1)          # [B, HW, K]
        return torch.matmul(r.transpose(1, 2), _rows(pixels))


class SpatialOCRModule(nn.Module):
    """Object-contextual representation (reference: ocrnet_head.py
    SpatialOCRModule / ObjectAttentionBlock): every pixel attends over the
    K region features."""

    def __init__(self, cin, key_channels, cout, *, generator=None):
        super().__init__()
        g = default_generator(generator)
        self.f_pixel = _linear(cin, key_channels, generator=g)
        self.f_object = _linear(cin, key_channels, generator=g)
        self.f_down = _linear(cin, key_channels, generator=g)
        self.f_up = _linear(key_channels, cin, generator=g)
        self.project = _ConvBNReLU(2 * cin, cout, k=1, generator=g)
        self.key_channels = key_channels

    def forward(self, pixels, regions):
        """pixels [B, C, H, W]; regions [B, K, C] -> [B, cout, H, W]."""
        b, c, h, w = pixels.shape
        q = self.f_pixel(_rows(pixels))                   # [B, HW, key]
        k = self.f_object(regions)                        # [B, K, key]
        v = self.f_down(regions)
        sim = torch.matmul(q, k.transpose(1, 2)) / (self.key_channels ** 0.5)
        ctx = self.f_up(torch.matmul(torch.softmax(sim, dim=-1), v))
        ctx = ctx.transpose(1, 2).reshape(b, c, h, w)
        return self.project(torch.cat([pixels, ctx], dim=1))


@manager.HEADS.add_component
class OCRNetHead(nn.Module):
    """(reference: class_heads/ocrnet_head.py:30)."""

    def __init__(self, num_classes: int, in_channels,
                 backbone_indices: Sequence[int] = (0,),
                 ocr_mid_channels: int = 512, ocr_key_channels: int = 256,
                 generator: torch.Generator = None, **unused):
        super().__init__()
        g = default_generator(generator)
        if not isinstance(in_channels, (list, tuple)):
            in_channels = [in_channels]
        self.backbone_indices = tuple(backbone_indices)
        self.indices = (-2, -1) if len(in_channels) > 1 else (-1, -1)
        shallow = in_channels[self.indices[0]]
        self.conv3x3_ocr = _ConvBNReLU(in_channels[self.indices[1]],
                                       ocr_mid_channels, k=3, generator=g)
        self.aux_head = Sequential(
            _ConvBNReLU(shallow, shallow, k=1, generator=g),
            _conv(shallow, num_classes, 1, bias=True, generator=g))
        self.spatial_gather = SpatialGatherBlock()
        self.spatial_ocr = SpatialOCRModule(ocr_mid_channels,
                                            ocr_key_channels,
                                            ocr_mid_channels, generator=g)
        self.cls_head = _conv(ocr_mid_channels, num_classes, 1, bias=True,
                              generator=g)
        self.out_channels = ocr_mid_channels

    def features(self, feat_list):
        if not isinstance(feat_list, (list, tuple)):
            feat_list = [feat_list]
        feats = [feat_list[i] for i in self.backbone_indices] \
            if len(feat_list) > max(self.backbone_indices) else list(
                feat_list)
        soft_regions = self.aux_head(feats[self.indices[0]])
        pixels = self.conv3x3_ocr(feats[self.indices[1]])
        return self.spatial_ocr(pixels,
                                self.spatial_gather(pixels, soft_regions))

    def forward(self, feat_list):
        return self.cls_head(self.features(feat_list))
