"""SSD head for PointPillars, torch port of
paddle3d_tpu/models/detection/pointpillars/pointpillars_head.py.

Three 1x1 convs, then fixed-shape batched post-processing: score/select,
decode the nms_pre_max_size survivors, direction fix, rotated NMS,
-1-padded [B, K] outputs.
"""
import math

import torch
from torch import nn

from ....apis import manager
from ....ops.box_ops import second_box_decode
from ....ops.iou3d_nms import suppress
from ...layers.layer_libs import default_generator, uniform_

__all__ = ["SSDHead"]


def _gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [B, A, C] (or [B, A]), idx [B, K] -> [B, K, C] (or [B, K])."""
    if t.dim() == 2:
        return torch.gather(t, 1, idx)
    return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))


@manager.HEADS.add_component
class SSDHead(nn.Module):
    def __init__(self,
                 num_classes: int,
                 feature_channels: int = 384,
                 num_anchor_per_loc: int = 2,
                 encode_background_as_zeros: bool = True,
                 use_direction_classifier: bool = True,
                 box_code_size: int = 7,
                 nms_score_threshold: float = 0.05,
                 nms_pre_max_size: int = 1000,
                 nms_post_max_size: int = 300,
                 nms_iou_threshold: float = 0.5,
                 prediction_center_limit_range=None,
                 generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        self.encode_background_as_zeros = encode_background_as_zeros
        self.use_direction_classifier = use_direction_classifier
        self.box_code_size = box_code_size
        self.nms_score_threshold = nms_score_threshold
        self.nms_pre_max_size = nms_pre_max_size
        self.nms_post_max_size = nms_post_max_size
        self.nms_iou_threshold = nms_iou_threshold
        self.pred_center_limit_range = (
            list(map(float, prediction_center_limit_range))
            if prediction_center_limit_range is not None else None)
        self._num_classes = (num_classes if encode_background_as_zeros else
                             num_classes + 1)

        def conv1x1(cout):
            conv = nn.utils.skip_init(nn.Conv2d, feature_channels, cout, 1)
            uniform_(conv.weight, feature_channels, generator)
            uniform_(conv.bias, feature_channels, generator)
            return conv

        self.cls_head = conv1x1(num_anchor_per_loc * self._num_classes)
        self.box_head = conv1x1(num_anchor_per_loc * box_code_size)
        if use_direction_classifier:
            self.dir_head = conv1x1(num_anchor_per_loc * 2)

    def forward(self, features: torch.Tensor) -> dict:
        """features [B, C, H, W] -> flat per-anchor predictions in the JAX
        package's (y, x, anchor) order: NCHW outputs go to NHWC before the
        reshape."""
        b = features.shape[0]

        def flat(t, c):
            return t.permute(0, 2, 3, 1).reshape(b, -1, c)

        ret = dict(cls_preds=flat(self.cls_head(features), self._num_classes),
                   box_preds=flat(self.box_head(features),
                                  self.box_code_size))
        if self.use_direction_classifier:
            ret["dir_preds"] = flat(self.dir_head(features), 2)
        return ret

    def post_process(self, preds: dict, anchors: torch.Tensor,
                     anchors_mask: torch.Tensor) -> dict:
        """Fixed-shape batched post-processing.

        Returns dict with box3d_lidar [B,K,7] (bottom-z), scores [B,K]
        (-1 padding) and label_preds [B,K] int32 (-1 padding),
        K = nms_post_max_size.
        """
        box_preds, cls_preds = preds["box_preds"], preds["cls_preds"]
        dir_preds = preds.get("dir_preds")
        if dir_preds is None:
            dir_preds = box_preds.new_zeros(box_preds.shape[:2] + (2,))
        k_pre = min(self.nms_pre_max_size, int(anchors.shape[0]))

        # score/select first, decode only the nms_pre_max_size survivors
        confs = torch.sigmoid(cls_preds if self.encode_background_as_zeros
                              else cls_preds[..., 1:])
        scores = confs.max(dim=-1).values
        labels = torch.argmax(confs, dim=-1)
        sel_scores = torch.where(
            anchors_mask & (scores >= self.nms_score_threshold), scores,
            -math.inf)
        # exact top-k with ties in index order, as the JAX package's CPU
        # top_k (torch.topk leaves the tie order unspecified)
        top_scores, top_idx = torch.sort(sel_scores, dim=-1,
                                         descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :k_pre], top_idx[:, :k_pre]
        bp = _gather_rows(box_preds, top_idx)
        dp = _gather_rows(dir_preds, top_idx)
        lab = _gather_rows(labels, top_idx)
        boxes = second_box_decode(bp, anchors.to(bp.dtype)[top_idx])

        if self.use_direction_classifier:
            dir_labels = torch.argmax(dp, dim=-1)
            flip = (boxes[..., 6] > 0) ^ dir_labels.bool()
            boxes = torch.cat([boxes[..., :6], (boxes[..., 6] + torch.where(
                flip, math.pi, 0.).to(boxes.dtype))[..., None]], dim=-1)

        valid = torch.isfinite(top_scores)
        if self.pred_center_limit_range is not None:
            lim = torch.tensor(self.pred_center_limit_range,
                               dtype=boxes.dtype, device=boxes.device)
            inside = ((boxes[..., :3] >= lim[:3]).all(dim=-1)
                      & (boxes[..., :3] <= lim[3:]).all(dim=-1))
            valid = valid & inside

        # bottom-z -> centre-z for the BEV NMS box footprint
        boxes_c = torch.cat([boxes[..., :2],
                             (boxes[..., 2] + boxes[..., 5] * 0.5)[..., None],
                             boxes[..., 3:]], dim=-1)
        _, keep = suppress(boxes_c, valid, self.nms_iou_threshold,
                           self.nms_post_max_size)
        kept = keep >= 0
        safe = torch.where(kept, keep, 0).long()
        return {
            "box3d_lidar": torch.where(kept[..., None],
                                       _gather_rows(boxes, safe), 0.),
            "scores": torch.where(kept, torch.gather(top_scores, 1, safe),
                                  -1.),
            "label_preds": torch.where(kept, torch.gather(lab, 1, safe),
                                       -1).to(torch.int32),
        }
