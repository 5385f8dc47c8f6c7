"""BEV-LaneDet, torch port of
paddle3d_tpu/models/detection/bev_lanedet/bev_lanedet.py (_bilinear_warp,
BEVLaneDet).

A ResNet stage's features (NCHW on cuDNN inside; NHWC images in [0, 255]
at the model's door, divided by 255, no mean or std) are reduced, warped
onto the BEV grid through the dataset's normalised (u, v) flow field, and
a lane head predicts per cell a confidence, a lateral offset, an
embedding for instance grouping and a height. Losses: balanced BCE on the
confidence, L1 on offset and height, the push-pull embedding loss (its
eps inside the sqrt, at most 8 instances a frame), as the JAX package has
them. The warp is the JAX package's four-tap gather in plain torch
(`bilinear_warp`); no hand-written kernel is on this path.
"""
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ....apis import manager
from ....sample import Sample
from ...base.base_model import BaseMonoModel, raise_if_training
from ...layers.layer_libs import (ConvBNReLU, Sequential, default_generator,
                                  uniform_init)

__all__ = ["BEVLaneDet", "bilinear_warp"]

MAX_INST = 8    # instance ids 1..8 enter the embedding loss


def bilinear_warp(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """feat [B, C, H, W]; grid [B, Hb, Wb, 2] of normalised (u, v) in [0,
    1] -> [B, C, Hb, Wb]: u scaled by (W - 1), v by (H - 1), the four taps
    around it weighted bilinearly, a tap outside the map counting 0 (the
    JAX package's _bilinear_warp, in its arithmetic and sum order)."""
    b, c, h, w = feat.shape
    hb, wb = grid.shape[1:3]
    x = grid[..., 0] * (w - 1)
    y = grid[..., 1] * (h - 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx, ty = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    flat = feat.reshape(b, c, h * w)

    def tap(xi, yi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, 1, -1)
        v = torch.gather(flat, 2, idx.expand(b, c, -1)).reshape(b, c, hb, wb)
        return torch.where(inb[:, None], v, torch.zeros((), dtype=v.dtype,
                                                          device=v.device))

    return (tap(x0, y0) * ((1 - tx) * (1 - ty))[:, None] +
            tap(x0 + 1, y0) * (tx * (1 - ty))[:, None] +
            tap(x0, y0 + 1) * ((1 - tx) * ty)[:, None] +
            tap(x0 + 1, y0 + 1) * (tx * ty)[:, None])


def _head(cin, cout, generator):
    """A 1 x 1 nnx.Conv: uniform(±1/sqrt(fan_in)) weight, zero bias."""
    conv = nn.utils.skip_init(nn.Conv2d, cin, cout, 1)
    uniform_init(conv.weight, generator)
    nn.init.zeros_(conv.bias)
    return conv


@manager.MODELS.add_component
class BEVLaneDet(BaseMonoModel):
    """Batch: `data` [B, H, W, 3] NHWC in [0, 255], `bev_grid` [B, Hb, Wb,
    2] (+ `lane_conf`, `lane_offset`, `lane_height` [B, Hb, Wb] and
    `lane_instance` [B, Hb, Wb] ids, 0 the background, to train).
    test_forward -> `lane_conf` (sigmoid), `lane_offset`, `lane_height`
    [B, Hb, Wb] and `lane_embed` [B, Hb, Wb, E]."""

    def __init__(self,
                 backbone=None,
                 bev_size: Sequence[int] = (100, 25),
                 bev_shape: Sequence[int] = None,
                 output_2d_shape: Sequence[int] = None,
                 train: bool = None,
                 in_channels: int = 256,
                 feat_channels: int = 64,
                 embed_dims: int = 4,
                 push_margin: float = 3.0,
                 pull_margin: float = 0.5,
                 pretrained: str = None,
                 generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        # the reference YAML's names: bev_shape for bev_size; `train` and
        # the 2-D branch's shape have no part here, as in the JAX package
        del output_2d_shape, train
        if bev_shape is not None:
            bev_size = bev_shape
        if backbone is None:
            from ...backbones import ResNet
            backbone = ResNet(depth=34, out_indices=(3,),
                              generator=generator)
            in_channels = 512
        self.backbone = backbone
        self.bev_h, self.bev_w = bev_size
        self.push_margin = push_margin
        self.pull_margin = pull_margin
        self.pretrained = pretrained

        self.reduce = ConvBNReLU(in_channels, feat_channels, 3,
                                 generator=generator)
        self.bev_conv = Sequential(
            ConvBNReLU(feat_channels, feat_channels, 3, generator=generator),
            ConvBNReLU(feat_channels, feat_channels, 3, generator=generator))
        self.conf_head = _head(feat_channels, 1, generator)
        self.offset_head = _head(feat_channels, 1, generator)
        self.embed_head = _head(feat_channels, embed_dims, generator)
        self.height_head = _head(feat_channels, 1, generator)

    def image_features(self, data):
        """NHWC images in [0, 255] -> the reduced feature map [B, F, h,
        w]."""
        img = (data / 255.0).permute(0, 3, 1, 2).contiguous()
        feats = self.backbone(img)
        f = feats[0] if isinstance(feats, (tuple, list)) else feats
        return self.reduce(f)

    def bev_preds(self, batch):
        """-> conf (logits), offset (sigmoid), height [B, Hb, Wb], embed
        [B, E, Hb, Wb]."""
        bev = bilinear_warp(self.image_features(batch["data"]),
                            batch["bev_grid"])
        bev = self.bev_conv(bev)
        return {"conf": self.conf_head(bev)[:, 0],
                "offset": torch.sigmoid(self.offset_head(bev))[:, 0],
                "embed": self.embed_head(bev),
                "height": self.height_head(bev)[:, 0]}

    def _embed_loss(self, emb, inst):
        """The push-pull loss of each frame, averaged: emb [B, E, Hb, Wb],
        inst [B, Hb, Wb]."""
        ids = torch.arange(1, MAX_INST + 1, device=inst.device)
        masks = inst[:, None] == ids[None, :, None, None]   # [B, I, Hb, Wb]
        fm = masks.to(emb.dtype)
        n = masks.sum(dim=(2, 3))
        counts = torch.clamp(n, min=1)
        means = torch.einsum("bihw,bchw->bic", fm, emb) / counts[..., None]
        dev = torch.abs(emb[:, None] - means[..., None, None]) - \
            self.pull_margin                                # [B, I, E, ...]
        pull = torch.sum(fm[:, :, None] * torch.clamp(dev, min=0.) ** 2,
                         dim=(1, 2, 3, 4)) / counts.sum(dim=1)
        valid = n > 0
        diff = means[:, :, None] - means[:, None, :]
        # eps inside the sqrt: the norm at 0 has a NaN gradient otherwise
        dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-8)
        eye = torch.eye(MAX_INST, dtype=torch.bool, device=emb.device)
        pair = valid[:, :, None] & valid[:, None, :] & ~eye
        push = torch.sum(torch.where(
            pair, torch.clamp(self.push_margin - dist, min=0.) ** 2,
            torch.zeros((), dtype=emb.dtype, device=emb.device)),
            dim=(1, 2)) / torch.clamp(pair.sum(dim=(1, 2)), min=1)
        return torch.mean(pull + push)

    def train_forward(self, batch) -> dict:
        preds = self.bev_preds(batch)
        conf_t = batch["lane_conf"]
        logits = preds["conf"]
        zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
        bce = (torch.clamp(logits, min=0) - logits * conf_t +
               torch.log1p(torch.exp(-torch.abs(logits))))
        # balance foreground and background
        fg = conf_t > 0.5
        n_fg = torch.clamp(fg.sum(), min=1)
        n_bg = torch.clamp((~fg).sum(), min=1)
        conf_loss = (torch.sum(torch.where(fg, bce, zero)) / n_fg +
                     torch.sum(torch.where(~fg, bce, zero)) / n_bg)
        offset_loss = torch.sum(torch.where(
            fg, torch.abs(preds["offset"] - batch["lane_offset"]),
            zero)) / n_fg
        height_loss = torch.sum(torch.where(
            fg, torch.abs(preds["height"] - batch["lane_height"]),
            zero)) / n_fg
        embed_loss = self._embed_loss(preds["embed"], batch["lane_instance"])
        total = conf_loss + offset_loss + height_loss + embed_loss
        return {"loss": total, "loss_conf": conf_loss,
                "loss_offset": offset_loss, "loss_height": height_loss,
                "loss_embed": embed_loss}

    def test_forward(self, batch) -> dict:
        raise_if_training(self)
        preds = self.bev_preds(batch)
        return {"lane_conf": torch.sigmoid(preds["conf"]),
                "lane_offset": preds["offset"],
                "lane_height": preds["height"],
                "lane_embed": preds["embed"].permute(0, 2, 3, 1)}

    @staticmethod
    def postprocess_to_samples(outputs: dict, metas: list) -> list:
        """One image Sample a frame: its `lane_conf`, `lane_offset`,
        `lane_height` and `lane_embed` maps as numpy, the meta's keys but
        `path` in its meta. The JAX one drops `lane_height`, which its
        ApolloLaneMetric reads at every confident cell."""
        maps = {k: np.asarray(torch.as_tensor(outputs[k]).cpu())
                for k in ("lane_conf", "lane_offset", "lane_height",
                          "lane_embed")}
        results = []
        for i, meta in enumerate(metas):
            s = Sample(path=meta.get("path"), modality="image")
            for k, v in maps.items():
                s[k] = v[i]
            s.meta.update({k: v for k, v in meta.items() if k != "path"})
            results.append(s)
        return results
