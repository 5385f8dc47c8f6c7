"""SqueezeSegV3 range-image segmentation, torch port of
paddle3d_tpu/models/segmentation/squeezesegv3.py (SACBlock, SACRangeNet,
SSGLossComputation, SqueezeSegV3).

NCHW on cuDNN inside; the model's door takes the JAX package's NHWC range
image [B, H, W, 5] and test_forward hands NHWC logits. The JAX package's
conventions, kept:
  * the SAC block's 3 x 3 unfold, `lax.conv_general_dilated_patches`, is
    `F.unfold` (both order the channels (C, kh, kw)); the attention conv
    is 7 x 7 SAME, both paddings symmetric here (stride 1, odd kernels);
  * the SAC block's two norms are nnx.BatchNorm's defaults (eps 1e-5,
    flax momentum 0.99), the stem's ConvBNReLU eps 1e-3; all keep flax's
    biased running variance (layer_libs.BatchNorm2d); test_forward uses
    the running statistics, as the JAX model after .eval();
  * between blocks the width halves by a (1, 2) VALID max pool and the
    range image by `jax.image.resize(..., "nearest")`, torch's
    "nearest-exact"; every block's output goes back to the full width by
    bilinear resize, align_corners=False.
No hand-written kernel is on this path (convs, the unfold, resizes).
"""
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...apis import manager
from ...datasets.semantic_kitti.semantic_kitti import (CONTENT,
                                                       SemanticKITTIDataset)
from ...ops.pointnet2 import first_argmax
from ...sample import Sample
from ..base.base_model import Base3DModel, raise_if_training
from ..layers.layer_libs import (BatchNorm2d, ConvBNReLU, Sequential,
                                 default_generator, uniform_init)

__all__ = ["SACBlock", "SACRangeNet", "SSGLossComputation", "SqueezeSegV3"]


def _conv(cin, cout, k, generator):
    """nnx.Conv, SAME at stride 1 (odd k): uniform(±1/sqrt(fan_in))
    weight, zero bias."""
    conv = nn.utils.skip_init(nn.Conv2d, cin, cout, k, padding=k // 2)
    uniform_init(conv.weight, generator)
    nn.init.zeros_(conv.bias)
    return conv


def _bn(c):
    """nnx.BatchNorm's defaults: eps 1e-5, flax momentum 0.99."""
    return BatchNorm2d(c, eps=1e-5, momentum=0.01)


class SACBlock(nn.Module):
    """Spatially-adaptive conv (SAC-ISK): a sigmoid attention map of 9 C
    channels, from a 7 x 7 conv of the range image, gates the 3 x 3 unfold
    of the features, then a 1 x 1 and a 3 x 3 conv, each with BN and
    relu."""

    def __init__(self, in_channels, out_channels, *,
                 generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        self.attn = _conv(5, 9 * in_channels, 7, generator)
        self.position_mlp = Sequential(
            _conv(9 * in_channels, out_channels, 1, generator),
            _bn(out_channels), nn.ReLU(),
            _conv(out_channels, out_channels, 3, generator),
            _bn(out_channels), nn.ReLU())

    def forward(self, range_img, feats):
        """range_img [B, 5, H, W], feats [B, C, H, W] -> [B, Cout, H,
        W]."""
        b, c, h, w = feats.shape
        attn = torch.sigmoid(self.attn(range_img))
        patches = F.unfold(feats, 3, padding=1).view(b, 9 * c, h, w)
        return self.position_mlp(patches * attn)


@manager.BACKBONES.add_component
class SACRangeNet(nn.Module):
    """A ConvBNReLU stem, then SAC blocks, the width halved between them;
    every block's output resized back to the input's width."""

    def __init__(self, in_channels: int = 5,
                 encoder_channels: Sequence[int] = (32, 64, 128, 256),
                 generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        self.stem = ConvBNReLU(in_channels, encoder_channels[0], 3,
                               generator=generator)
        self.blocks = nn.ModuleList([
            SACBlock(encoder_channels[i - 1] if i else encoder_channels[0],
                     encoder_channels[i], generator=generator)
            for i in range(len(encoder_channels))])
        self.out_channels = list(encoder_channels)

    def forward(self, x):
        """x [B, 5, H, W] -> list of the blocks' outputs at [H, W]."""
        range_img = x
        f = self.stem(x)
        outs = []
        for i, blk in enumerate(self.blocks):
            f = blk(range_img, f)
            outs.append(f)
            if i < len(self.blocks) - 1:
                h, w = f.shape[-2:]
                f = F.max_pool2d(f, (1, 2), (1, 2))
                range_img = F.interpolate(range_img, size=(h, w // 2),
                                          mode="nearest-exact")
        size = outs[0].shape[-2:]
        return [o if o.shape[-2:] == size else
                F.interpolate(o, size=size, mode="bilinear",
                              align_corners=False) for o in outs]


@manager.LOSSES.add_component
@manager.MODELS.add_component
class SSGLossComputation:
    """Inverse-frequency class weights of the range-image CE loss: weight
    = 1 / (the class's share of the train points + epsilon_w), 0 at
    ignore_index. Registered so that a reference config's `loss:` builds;
    SqueezeSegV3.train_forward computes the per-scale CE with these
    weights."""

    def __init__(self, num_classes: int, epsilon_w: float = 1e-3,
                 ignore_index: int = 0):
        lut = SemanticKITTIDataset.build_remap_lut()
        content = np.zeros(num_classes, np.float32)
        for raw, freq in CONTENT.items():
            content[lut[raw]] += freq
        self.weights = 1. / (content + epsilon_w)
        if 0 <= ignore_index < num_classes:
            self.weights[ignore_index] = 0.
        self.ignore_index = ignore_index
        self.num_classes = num_classes


@manager.MODELS.add_component
class SqueezeSegV3(Base3DModel):
    """Batch: `data` [B, H, W, 5] NHWC range images (+ `proj_labels` [B,
    H, W] class ids and `proj_mask` [B, H, W] to train). test_forward ->
    `pred_labels` [B, H, W] (ties to the lowest class, as jnp.argmax),
    `logits` [B, H, W, num_classes] (an NHWC view)."""

    modality = "lidar"

    def __init__(self, backbone, num_classes: int = 20,
                 class_weights: Sequence[float] = None,
                 loss: SSGLossComputation = None, pretrained: str = None,
                 generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        self.backbone = backbone
        self.num_classes = num_classes
        self.pretrained = pretrained
        if loss is not None and class_weights is None:
            class_weights = loss.weights
        # a constant of the loss, not state: outside the state dict
        self.register_buffer(
            "class_weights", None if class_weights is None else
            torch.from_numpy(np.asarray(class_weights, np.float32)),
            persistent=False)
        cin = sum(backbone.out_channels)
        self.head = Sequential(
            _conv(cin, 64, 3, generator), nn.ReLU(),
            _conv(64, num_classes, 1, generator))
        # per-scale supervision heads
        self.aux_heads = nn.ModuleList([
            _conv(c, num_classes, 1, generator)
            for c in backbone.out_channels])

    def logits(self, img):
        """img [B, H, W, 5] -> (logits [B, classes, H, W], the backbone's
        per-scale features)."""
        feats = self.backbone(img.permute(0, 3, 1, 2).contiguous())
        return self.head(torch.cat(feats, dim=1)), feats

    def _ce(self, logits, labels, mask):
        logp = torch.log_softmax(logits, dim=1)
        nll = -logp.gather(1, labels[:, None]).squeeze(1)
        if self.class_weights is not None:
            nll = nll * self.class_weights[labels]
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.)

    def train_forward(self, batch) -> dict:
        logits, feats = self.logits(batch["data"])
        labels = batch["proj_labels"].long()
        mask = batch["proj_mask"].to(logits.dtype)
        loss = self._ce(logits, labels, mask)
        aux = 0.
        for head, f in zip(self.aux_heads, feats):
            aux = aux + self._ce(head(f), labels, mask)
        return {"loss": loss + 0.5 * aux, "loss_main": loss,
                "loss_aux": aux}

    def test_forward(self, batch) -> dict:
        raise_if_training(self)
        logits, _ = self.logits(batch["data"])
        return {"pred_labels": first_argmax(logits, dim=1),
                "logits": logits.permute(0, 2, 3, 1)}

    @staticmethod
    def postprocess_to_samples(outputs: dict, metas: list) -> list:
        """One lidar Sample a scan: `labels` its [H, W] predicted range
        image (SemanticKittiMetric reads each point's through the meta's
        proj_x / proj_y), the meta's keys but `path` in its meta."""
        preds = np.asarray(torch.as_tensor(outputs["pred_labels"]).cpu())
        results = []
        for i, meta in enumerate(metas):
            s = Sample(path=meta.get("path"), modality="lidar")
            s.labels = preds[i]
            s.meta.update({k: v for k, v in meta.items() if k != "path"})
            results.append(s)
        return results
