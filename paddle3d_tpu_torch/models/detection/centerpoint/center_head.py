"""CenterPoint head, torch port of
paddle3d_tpu/models/detection/centerpoint/center_head.py (ConvBNReLU1,
SeparateHead, CenterHead with its `loss` and `predict`).

NCHW inside; the per-task outputs leave the head in the JAX package's NHWC
layout, so `predict` and the parity tests see the same arrays. In eval, when
every tower is a 3x3 ConvBNReLU1 and a final conv, the towers' first convs
run as ONE convolution (their BN folded into its weight and bias) and their
final convs as ONE grouped convolution, a group per tower: the function of
the towers, with the work of the towers. The JAX package's block-diagonal
dense form of the final convs is a TPU workaround that multiplies mostly
zeros (~590 GFLOP against ~11 at nuScenes) and has no counterpart here. In
train mode (batch-statistics BN) the towers run one by one.

`predict` is the fixed-shape decode + rotated NMS over all tasks at once,
with the JAX package's [T, B] vmaps written out as leading dimensions.
"""
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ....apis import manager
from ....ops.iou3d_nms import suppress
from ...layers.layer_libs import (BatchNorm2d, default_generator,
                                  uniform_bias_init, uniform_init)
from ...losses.centernet_loss import FastFocalLoss, RegLoss

__all__ = ["ConvBNReLU1", "SeparateHead", "CenterHead"]


def _same_padding(kernel_size: int) -> int:
    if kernel_size % 2 != 1:
        raise ValueError("the head's convs take odd kernels (SAME padding "
                         "is symmetric only then), got {}".format(
                             kernel_size))
    return kernel_size // 2


class ConvBNReLU1(nn.Module):
    """3x3 conv (no bias, SAME) + BN (eps 1e-5, flax momentum 0.9) + ReLU,
    the reference head's ConvModule."""

    def __init__(self, cin: int, cout: int, kernel_size: int, *,
                 generator: torch.Generator = None):
        super().__init__()
        self.conv = nn.utils.skip_init(
            nn.Conv2d, cin, cout, kernel_size,
            padding=_same_padding(kernel_size), bias=False)
        uniform_init(self.conv.weight, default_generator(generator))
        self.bn = BatchNorm2d(cout, eps=1e-5, momentum=0.1)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class SeparateHead(nn.Module):
    """One conv tower per output name (reference: center_head.py:80);
    `towers[name]` is a ModuleList, so nnx paths such as
    `towers.hm.0.conv.kernel` name the same submodule."""

    def __init__(self, in_channels: int, heads: Dict[str, Sequence[int]],
                 head_conv: int = 64, final_kernel: int = 3,
                 init_bias: float = -2.19, *,
                 generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        self.head_names = list(heads.keys())
        self.towers = nn.ModuleDict()
        for name, (classes, num_conv) in heads.items():
            layers = []
            c_in = in_channels
            for _ in range(num_conv - 1):
                layers.append(ConvBNReLU1(c_in, head_conv, final_kernel,
                                          generator=generator))
                c_in = head_conv
            final = nn.utils.skip_init(
                nn.Conv2d, c_in, classes, final_kernel,
                padding=_same_padding(final_kernel))
            uniform_init(final.weight, generator)
            if name == "hm":
                with torch.no_grad():
                    final.bias.fill_(init_bias)
            else:
                uniform_bias_init(final.bias, c_in, generator)
            layers.append(final)
            self.towers[name] = nn.ModuleList(layers)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        out = {}
        for name in self.head_names:
            y = x
            for layer in self.towers[name]:
                y = layer(y)
            out[name] = y
        return out


@manager.HEADS.add_component
@manager.MODELS.add_component
class CenterHead(nn.Module):
    def __init__(self,
                 in_channels: int = 128,
                 tasks: List[dict] = (),
                 weight: float = 0.25,
                 code_weights: Sequence[float] = (),
                 common_heads: Dict[str, Sequence[int]] = None,
                 init_bias: float = -2.19,
                 share_conv_channel: int = 64,
                 num_hm_conv: int = 2,
                 generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        common_heads = dict(common_heads or {})
        self.tasks_cfg = list(tasks)
        self.num_classes = [len(t["class_names"]) for t in tasks]
        self.class_names = [t["class_names"] for t in tasks]
        self.weight = weight
        self.code_weights = list(code_weights)
        self.with_velocity = "vel" in common_heads
        self.box_n_dim = 9 if self.with_velocity else 7

        self.crit = FastFocalLoss()
        self.crit_reg = RegLoss()

        self.shared_conv = ConvBNReLU1(in_channels, share_conv_channel, 3,
                                       generator=generator)
        task_heads = []
        for num_cls in self.num_classes:
            heads = dict(common_heads)
            heads["hm"] = (num_cls, num_hm_conv)
            task_heads.append(SeparateHead(
                share_conv_channel, heads, final_kernel=3,
                init_bias=init_bias, generator=generator))
        self.task_heads = nn.ModuleList(task_heads)

    def forward(self, x: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        """x [B, C, H, W] -> per task {name: [B, H, W, C_name]} (NHWC
        views)."""
        x = self.shared_conv(x)
        if not self.training and self._mergeable():
            preds = self._merged_call(x)
        else:
            preds = [head(x) for head in self.task_heads]
        return [{k: v.permute(0, 2, 3, 1) for k, v in p.items()}
                for p in preds]

    def _towers(self):
        return [(ti, name, head.towers[name])
                for ti, head in enumerate(self.task_heads)
                for name in head.head_names]

    def _mergeable(self) -> bool:
        """Every tower is a ConvBNReLU1 and a final conv of one kernel
        size over the shared input."""
        towers = self._towers()
        if any(len(t) != 2 for _, _, t in towers):
            return False
        shapes = {(tuple(t[0].conv.weight.shape), t[1].kernel_size)
                  for _, _, t in towers}
        return len(shapes) == 1

    def _merged_call(self, x) -> List[Dict[str, torch.Tensor]]:
        """Eval: the towers' first convs as one convolution with their BN
        folded in, their final convs as one grouped convolution."""
        towers = self._towers()
        ng = len(towers)
        w1, b1 = [], []
        for _, _, t in towers:
            bn = t[0].bn
            s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
            w1.append(t[0].conv.weight * s[:, None, None, None])
            b1.append(bn.bias - bn.running_mean * s)
        y = torch.relu(F.conv2d(x, torch.cat(w1), torch.cat(b1),
                                padding=towers[0][2][0].conv.padding))

        outs = [t[1].out_channels for _, _, t in towers]
        po = max(outs)
        final = towers[0][2][1]
        hc, kh, kw = final.weight.shape[1:]
        w2 = final.weight.new_zeros((ng * po, hc, kh, kw))
        b2 = final.weight.new_zeros((ng * po,))
        for gi, (_, _, t) in enumerate(towers):
            w2[gi * po:gi * po + outs[gi]] = t[1].weight
            b2[gi * po:gi * po + outs[gi]] = t[1].bias
        z = F.conv2d(y, w2, b2, padding=final.padding, groups=ng)

        preds = [dict() for _ in self.task_heads]
        for gi, (ti, name, _) in enumerate(towers):
            preds[ti][name] = z[:, gi * po:gi * po + outs[gi]]
        return preds

    # -------------------------------------------------------------- training
    def loss(self, preds: List[dict], targets: List[tuple]) -> dict:
        """preds: per task {name: [B, H, W, C]} (NHWC); targets: per task
        (heatmap, target_bbox, center_idx, mask, label) from
        CenterPointTargetGenerator. -> {"loss", "hm_loss_i", "loc_loss_i"}."""
        total, out = 0., {}
        weights = torch.tensor(self.code_weights,
                               device=preds[0]["hm"].device)
        for i, (task_preds, (hm_t, box_t, idx_t, mask_t, label_t)) in \
                enumerate(zip(preds, targets)):
            hm = torch.clamp(torch.sigmoid(task_preds["hm"]), 1e-4, 1 - 1e-4)
            hm_loss = self.crit(hm, hm_t, idx_t, mask_t, label_t)
            parts = [task_preds["reg"], task_preds["height"],
                     task_preds["dim"]]
            if self.with_velocity:
                parts.append(task_preds["vel"])
            parts.append(task_preds["rot"])
            box_loss = self.crit_reg(torch.cat(parts, dim=-1), mask_t, idx_t,
                                     box_t)
            loc_loss = torch.sum(box_loss * weights)
            total = total + hm_loss + self.weight * loc_loss
            out["hm_loss_{}".format(i)] = hm_loss
            out["loc_loss_{}".format(i)] = loc_loss
        return {"loss": total, **out}

    # ------------------------------------------------------------- inference
    def predict(self, preds: List[dict], test_cfg: dict) -> dict:
        """Decode + rotated NMS over all tasks and scans at once.

        preds: per task {name: [B, H, W, C]} (NHWC). Returns fixed-shape
        box3d_lidar [B, K, 7|9] (bottom-z), scores [B, K], label_preds
        [B, K] int32 (-1 padded), K = num_tasks * nms_post_max_size.
        """
        vx, vy = test_cfg["voxel_size"][0], test_cfg["voxel_size"][1]
        pc_range = test_cfg["point_cloud_range"]
        down_ratio = test_cfg["down_ratio"]
        score_thr = test_cfg["score_threshold"]
        nms_cfg = test_cfg["nms"]
        post_limit = test_cfg.get("post_center_limit_range")
        if nms_cfg.get("type") == "circle":
            raise NotImplementedError(
                "circle NMS is not ported (ROADMAP.md, queue 1, item 16)")

        cmax = max(self.num_classes)
        b, h, w, _ = preds[0]["hm"].shape
        # heatmaps padded to the largest class count with -1e4 logits
        hm = torch.sigmoid(torch.stack([
            F.pad(p["hm"], (0, cmax - nc), value=-1e4)
            for p, nc in zip(preds, self.num_classes)]))     # [T,B,H,W,Cmax]
        # one packed regression map per task: reg 2 | height 1 | dim 3 |
        # rot 2 (| vel 2)
        packed = torch.stack([
            torch.cat([p["reg"], p["height"], p["dim"], p["rot"]]
                      + ([p["vel"]] if "vel" in p else []), dim=-1)
            for p in preds])                                 # [T,B,H,W,8|10]
        t = packed.shape[0]
        dev = packed.device
        cls_off = torch.tensor([sum(self.num_classes[:i])
                                for i in range(t)], device=dev)[:, None,
                                                                None]
        num_cls = torch.tensor(self.num_classes, device=dev)[:, None, None]

        scores_flat = hm.permute(0, 1, 4, 2, 3).reshape(t, b, -1)
        k = min(nms_cfg["nms_pre_max_size"], scores_flat.shape[-1])
        # exact top-k with ties in index order, as the JAX package's CPU
        # top_k (its TPU approx_max_k has no counterpart)
        top_scores, top_idx = torch.sort(scores_flat, dim=-1,
                                         descending=True, stable=True)
        top_scores, top_idx = top_scores[..., :k], top_idx[..., :k]
        cls_id = torch.div(top_idx, h * w, rounding_mode="floor")
        pos = top_idx - cls_id * (h * w)
        ys = torch.div(pos, w, rounding_mode="floor")
        xs = (pos - ys * w).to(torch.float32)
        ys = ys.to(torch.float32)

        flat = packed.reshape(t, b, h * w, -1)
        sel = torch.gather(flat, 2, pos[..., None].expand(
            -1, -1, -1, flat.shape[-1]))                     # [T,B,k,8|10]
        x = (xs + sel[..., 0]) * down_ratio * vx + pc_range[0]
        y = (ys + sel[..., 1]) * down_ratio * vy + pc_range[1]
        cols = [x[..., None], y[..., None], sel[..., 2:3],
                torch.exp(sel[..., 3:6])]
        if self.with_velocity:
            cols.append(sel[..., 8:10])
        cols.append(torch.atan2(sel[..., 6], sel[..., 7])[..., None])
        boxes = torch.cat(cols, dim=-1)                      # [T,B,k,7|9]

        # the cls_id guard drops the padding channels: a zero score
        # threshold would otherwise let them through
        valid = (top_scores >= score_thr) & (cls_id < num_cls)
        if post_limit is not None:
            lim = torch.tensor(post_limit, dtype=boxes.dtype, device=dev)
            valid = valid & ((boxes[..., :3] >= lim[:3]).all(dim=-1)
                             & (boxes[..., :3] <= lim[3:]).all(dim=-1))
        # candidates are already score-descending (top-k order)
        bev = boxes[..., [0, 1, 3, 4, boxes.shape[-1] - 1]]
        _, keep = suppress(bev, valid, nms_cfg["nms_iou_threshold"],
                           nms_cfg["nms_post_max_size"])      # [T,B,post]
        kept = keep >= 0
        safe = torch.where(kept, keep, 0).long()
        out_boxes = torch.where(kept[..., None], torch.gather(
            boxes, 2, safe[..., None].expand(-1, -1, -1, boxes.shape[-1])),
            0.)
        # centre z -> bottom z for the uniform output convention
        out_boxes = torch.cat([
            out_boxes[..., :2],
            (out_boxes[..., 2] + torch.where(kept, -out_boxes[..., 5] / 2,
                                             0.))[..., None],
            out_boxes[..., 3:]], dim=-1)
        out_scores = torch.where(kept, torch.gather(top_scores, 2, safe), -1.)
        out_labels = torch.where(kept, torch.gather(cls_id, 2, safe) + cls_off,
                                 -1).to(torch.int32)

        def tb_to_bk(v):
            moved = v.transpose(0, 1)                        # [B,T,K,...]
            return moved.reshape((b, -1) + tuple(moved.shape[3:]))

        return {"box3d_lidar": tb_to_bk(out_boxes),
                "scores": tb_to_bk(out_scores),
                "label_preds": tb_to_bk(out_labels)}
