"""SMOKE loss, torch port of
paddle3d_tpu/models/detection/smoke/smoke_loss.py (penalty_reduced_focal,
SMOKELossComputation).

Penalty-reduced focal loss on the class heatmap and a disentangled L1 on
the 3-D box corners: each regression group (orientation, dimensions,
location) is decoded with the other two taken from the ground truth, and
the corners are compared in camera space. The regression rows at the
targets' points are a torch.gather under autograd: the row gather K14 has
no VJP, in either package.
"""
import torch
from torch import nn

from ....apis import manager
from .smoke_coder import SMOKECoder

__all__ = ["SMOKELossComputation", "penalty_reduced_focal"]


def penalty_reduced_focal(pred, target, alpha=2.0, beta=4.0):
    """CornerNet focal loss; positives where target == 1."""
    pos = (target == 1.0).to(pred.dtype)
    neg_weights = torch.pow(1 - target, beta)
    pos_loss = torch.log(pred) * torch.pow(1 - pred, alpha) * pos
    neg_loss = torch.log(1 - pred) * torch.pow(pred, alpha) * neg_weights * (
        1 - pos)
    num_pos = torch.sum(pos)
    total = -(torch.sum(pos_loss) + torch.sum(neg_loss))
    return torch.where(num_pos == 0, total,
                       total / torch.clamp(num_pos, min=1.0))


@manager.LOSSES.add_component
class SMOKELossComputation(nn.Module):
    def __init__(self, depth_ref, dim_ref, reg_loss: str = "DisL1",
                 loss_weight=(1., 10.), max_objs: int = 50):
        super().__init__()
        self.coder = SMOKECoder(depth_ref, dim_ref)
        self.reg_loss = reg_loss
        self.loss_weight = tuple(loss_weight)
        self.max_objs = max_objs

    def forward(self, pred_heatmap, pred_regression, target: dict) -> dict:
        """pred_heatmap [B, H, W, C] (already sigmoid), pred_regression
        [B, H, W, R] (NHWC, views of the head's maps); target: the batched
        arrays of Gt2SmokeTarget as tensors on the model's device."""
        hm_loss = penalty_reduced_focal(pred_heatmap, target["hm"])

        b, h, w, r = pred_regression.shape
        pts = target["proj_p"]                           # [B, M, 2] (x, y)
        m = pts.shape[1]
        flat = pred_regression.reshape(b, h * w, r)
        lin = (pts[..., 1] * w + pts[..., 0]).long()
        pois = torch.gather(flat, 1, lin[..., None].expand(-1, -1, r))
        pois = pois.reshape(b * m, r)

        cls_ids = target["cls_ids"].reshape(-1)
        gt_dims = target["dimensions"].reshape(-1, 3)    # (h, w, l)
        gt_locs = target["locations"].reshape(-1, 3)
        gt_rotys = target["rotys"].reshape(-1)
        mask = target["reg_mask"].reshape(-1).to(pred_regression.dtype)

        coder = self.coder
        depths = coder.decode_depth(pois[:, 0])
        k_inv = torch.repeat_interleave(target["K_inv"], m, dim=0)
        down = torch.repeat_interleave(target["down_ratio"], m, dim=0)
        proj = (pts.reshape(-1, 2).to(pois.dtype) + pois[:, 1:3]) * down
        homo = torch.cat([proj, torch.ones_like(proj[:, :1])], dim=1)
        locs = torch.einsum("nij,nj->ni", k_inv, homo * depths[:, None])
        dims = coder.decode_dimension(cls_ids, pois[:, 3:6])
        locs = torch.cat([locs[:, :1], locs[:, 1:2] + dims[:, :1] / 2,
                          locs[:, 2:]], dim=1)           # centre -> bottom
        rotys, _ = coder.decode_orientation(pois[:, 6:8], gt_locs)

        corners = coder.encode_box3d
        gt_box = corners(gt_rotys, gt_dims, gt_locs)
        n_valid = torch.clamp(torch.sum(mask), min=1.0)
        w_mask = mask[:, None, None]
        if self.reg_loss == "DisL1":
            box_ori = corners(rotys, gt_dims, gt_locs)
            box_dim = corners(gt_rotys, dims, gt_locs)
            box_loc = corners(gt_rotys, gt_dims, locs)
            reg = (torch.sum(torch.abs(box_ori - gt_box) * w_mask) +
                   torch.sum(torch.abs(box_dim - gt_box) * w_mask) +
                   torch.sum(torch.abs(box_loc - gt_box) * w_mask)) / n_valid
        else:
            box = corners(rotys, dims, locs)
            reg = torch.sum(torch.abs(box - gt_box) * w_mask) / n_valid
        total = self.loss_weight[0] * hm_loss + \
            self.loss_weight[1] * reg / 3.
        return {"loss": total, "hm_loss": hm_loss, "reg_loss": reg}
