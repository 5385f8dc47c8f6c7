"""PointPillars loss, torch port of
paddle3d_tpu/models/detection/pointpillars/pointpillars_loss.py.

A function of the head's predictions and the on-device targets: per-sample
foreground-count normalisation, the sin encoding of the rotation error and
a binary direction target (rot_gt > 0).
"""
import torch
import torch.nn.functional as F

from ....apis import manager

__all__ = ["PointPillarsLoss"]


@manager.LOSSES.add_component
class PointPillarsLoss:
    def __init__(self,
                 num_classes: int,
                 classification_loss,
                 regression_loss,
                 direction_loss=None,
                 classification_loss_weight: float = 1.0,
                 regression_loss_weight: float = 2.0,
                 direction_loss_weight: float = 1.0,
                 fg_cls_weight: float = 1.0,
                 bg_cls_weight: float = 1.0,
                 encode_rot_error_by_sin: bool = True,
                 use_direction_classifier: bool = True,
                 encode_background_as_zeros: bool = True,
                 box_code_size: int = 7):
        self.num_classes = num_classes
        self.cls_loss = classification_loss
        self.reg_loss = regression_loss
        self.dir_loss = direction_loss
        self.cls_loss_w = classification_loss_weight
        self.reg_loss_w = regression_loss_weight
        self.dir_loss_w = direction_loss_weight
        self.fg_cls_weight = fg_cls_weight
        self.bg_cls_weight = bg_cls_weight
        self.encode_rot_error_by_sin = encode_rot_error_by_sin
        self.use_direction_classifier = use_direction_classifier
        self.encode_background_as_zeros = encode_background_as_zeros
        self.box_code_size = box_code_size

    def __call__(self, box_preds, cls_preds, reg_targets, labels,
                 dir_preds=None, anchors=None) -> dict:
        """labels [B, A]: -1 ignore / 0 bg / 1..C fg."""
        fg = (labels > 0).to(box_preds.dtype)
        bg = (labels == 0).to(box_preds.dtype)
        fg_norm = torch.clamp(fg.sum(dim=1, keepdim=True), min=1.0)
        cls_weights = (self.bg_cls_weight * bg +
                       self.fg_cls_weight * fg) / fg_norm
        reg_weights = fg / fg_norm

        cls_targets = torch.where(labels >= 0, labels, 0).long()
        onehot = F.one_hot(cls_targets, self.num_classes + 1).to(
            box_preds.dtype)
        if self.encode_background_as_zeros:
            onehot = onehot[..., 1:]
        cls_loss = self.cls_loss(cls_preds, onehot, weights=cls_weights)

        if self.encode_rot_error_by_sin:
            # sin(a - b) = sin(a) cos(b) - cos(a) sin(b)
            pred_rot = torch.sin(box_preds[..., -1:]) * torch.cos(
                reg_targets[..., -1:])
            tgt_rot = torch.cos(box_preds[..., -1:]) * torch.sin(
                reg_targets[..., -1:])
            box_preds_ = torch.cat([box_preds[..., :-1], pred_rot], -1)
            reg_targets_ = torch.cat([reg_targets[..., :-1], tgt_rot], -1)
        else:
            box_preds_, reg_targets_ = box_preds, reg_targets
        reg_loss = self.reg_loss(box_preds_, reg_targets_,
                                 weights=reg_weights)

        batch_size = box_preds.shape[0]
        loss_cls = torch.sum(cls_loss) / batch_size
        loss_reg = torch.sum(reg_loss) / batch_size
        loss_dict = {"loss_cls": loss_cls, "loss_reg": loss_reg}
        total = self.reg_loss_w * loss_reg + self.cls_loss_w * loss_cls

        if self.use_direction_classifier and dir_preds is not None:
            rot_gt = reg_targets[..., -1] + anchors[None, :, -1]
            dir_targets = (rot_gt > 0).long()
            weights = fg / torch.clamp(fg.sum(dim=-1, keepdim=True), min=1.0)
            dir_loss = self.dir_loss(dir_preds, dir_targets, weights=weights)
            loss_dir = torch.sum(dir_loss) / batch_size
            total = total + self.dir_loss_w * loss_dir
            loss_dict["loss_dir"] = loss_dir

        loss_dict["loss"] = total
        return loss_dict
