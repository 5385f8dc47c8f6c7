"""CenterNet-style losses of CenterHead, torch port of
paddle3d_tpu/models/losses/centernet_loss.py (gather_feat, FastFocalLoss,
RegLoss, L1Loss). NHWC maps, as in the JAX package. Stateless callables,
registered in LOSSES so that YAML configs build them.
"""
import torch

from ...apis import manager

__all__ = ["FastFocalLoss", "RegLoss", "L1Loss", "gather_feat"]


def gather_feat(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """feat [B, H*W, C], ind [B, M] -> [B, M, C]."""
    return torch.gather(feat, 1, ind.long()[..., None].expand(
        -1, -1, feat.shape[-1]))


@manager.LOSSES.add_component
class FastFocalLoss:
    """Penalty-reduced pixelwise focal loss (CornerNet form)."""

    def __call__(self, out, target, ind, mask, cat):
        """out / target [B, H, W, C] (NHWC, out a probability); ind / mask /
        cat [B, M]."""
        b, h, w, c = out.shape
        mask = mask.to(out.dtype)
        gt_weight = torch.pow(1 - target, 4)
        neg_loss = torch.sum(torch.log(1 - out) * torch.pow(out, 2) *
                             gt_weight)
        pos_pix = gather_feat(out.reshape(b, h * w, c), ind)     # [B, M, C]
        pos_pred = torch.gather(pos_pix, 2, cat.long()[..., None])[..., 0]
        num_pos = torch.sum(mask)
        pos_loss = torch.sum(torch.log(pos_pred) *
                             torch.pow(1 - pos_pred, 2) * mask)
        return torch.where(num_pos == 0, -neg_loss,
                           -(pos_loss + neg_loss) / torch.clamp(num_pos,
                                                                min=1.))


@manager.LOSSES.add_component
class RegLoss:
    """Masked L1 at the object centre indices, per channel."""

    def __call__(self, output, mask, ind, target):
        """output [B, H, W, C]; mask / ind [B, M]; target [B, M, C] ->
        per-channel loss [C]."""
        b, h, w, c = output.shape
        pred = gather_feat(output.reshape(b, h * w, c), ind)     # [B, M, C]
        fmask = mask.to(output.dtype)[..., None]
        loss = torch.abs(pred * fmask - target * fmask)
        loss = loss / (torch.sum(fmask) + 1e-4)
        return torch.sum(loss, dim=(0, 1))


@manager.LOSSES.add_component
class L1Loss:
    def __init__(self, reduction: str = "mean", loss_weight: float = 1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None):
        loss = torch.abs(pred - target)
        if weight is not None:
            loss = loss * weight
        if self.reduction == "mean":
            loss = torch.mean(loss)
        elif self.reduction == "sum":
            loss = torch.sum(loss)
        return self.loss_weight * loss
