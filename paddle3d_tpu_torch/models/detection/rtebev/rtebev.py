"""RTEBev real-time multi-view 3-D detector, torch port of
paddle3d_tpu/models/detection/rtebev/rtebev.py (RTEBev).

Camera images -> ResNet and FPN (all three levels kept) -> the
multi-scale-depth LSS view transformer (MSLSSViewTransformerBEVDepth: the
camera-conditioned depth net, the frustum lifted into the ego frame, the
pool onto the BEV grid: K7 or K2 forward, K5 backward on the card) -> the
current BEV and num_adj adjacent frames' BEVs, channels concatenated ->
CustomResNet + FPN_LSS -> RTEBevHead (hybrid-matching queries, NMS-free).

Batch contract (fixed shapes), BEVDet's (models/detection/bevdet) plus:
    bev_adj:    [B, (F,) gy, gx, C] (optional) earlier frames' BEVs, each
                frame's own pooled BEV (the deploy protocol: a video
                caller feeds back what _frame_bev gave), already aligned
                into the current ego frame; concatenated as they are
    img_adj:    [B, (F,) N, H, W, 3] with rots_adj / trans_adj (optional)
                adjacent frames, encoded without gradient (train-mode
                BatchNorm still updates its running stats: the current
                frame first, then the adjacent frames in order)
    gt_depth:   [B, N, H, W] metric LiDAR depth (0: no return), optional,
                for the depth loss when use_depth
Without either, the current BEV stands in for the earlier frames,
detached. Each frame pooled is one launch of the segment sum.
test_forward refuses a model in train mode and returns the predictions
only, as the JAX package's does; export_forward is test_forward.

postprocess_to_samples is PETR's, as in the JAX package. Not ported: the
JAX model's knobs that no config of the repo sets: pre_process, start_temporal_epoch, align_after_view_transfromation.
"""
import math

import torch

from ....apis import manager
from ....ops.box_ops import limit_period
from ...base.base_model import BaseMultiViewModel, raise_if_training
from ..petr.petr3d import PETR

__all__ = ["RTEBev"]

_MATS = ("rots", "trans", "cam2imgs", "post_rots", "post_trans", "bda")


@manager.MODELS.add_component
class RTEBev(BaseMultiViewModel):
    def __init__(self,
                 img_backbone,
                 img_neck,
                 img_view_transformer,
                 img_bev_encoder_backbone,
                 img_bev_encoder_neck,
                 pts_bbox_head=None,
                 bbox_head=None,
                 num_adj: int = 0,
                 use_depth: bool = False,
                 use_ms_depth: bool = False,
                 test_cfg: dict = None):
        super().__init__()
        self.img_backbone = img_backbone
        self.img_neck = img_neck
        self.img_view_transformer = img_view_transformer
        self.img_bev_encoder_backbone = img_bev_encoder_backbone
        self.img_bev_encoder_neck = img_bev_encoder_neck
        self.bbox_head = pts_bbox_head if pts_bbox_head is not None else \
            bbox_head
        self.num_adj = int(num_adj)
        self.num_frame = self.num_adj + 1
        self.use_depth = use_depth
        self.use_ms_depth = use_ms_depth
        self.test_cfg = dict(test_cfg or {})

    # ------------------------------------------------------------- encoders
    def image_features(self, imgs):
        """imgs [B, N, H, W, 3] -> every neck level [B, N, C, h_i, w_i],
        finest first."""
        b, n, h, w, c = imgs.shape
        x = self.img_backbone(imgs.reshape(b * n, h, w, c).permute(
            0, 3, 1, 2).contiguous())
        if self.img_neck is not None:
            x = self.img_neck(x)
        feats = list(x) if isinstance(x, (tuple, list)) else [x]
        return [f.reshape((b, n) + tuple(f.shape[1:])) for f in feats]

    def _frame_bev(self, imgs, rots, trans, cam2imgs, post_rots, post_trans,
                   bda):
        """One frame -> (BEV [B, gy, gx, C] NHWC, depth [B, N, D, h, w])."""
        feats = self.image_features(imgs)
        return self.img_view_transformer(
            feats[:3] if self.use_ms_depth else feats[0], rots, trans,
            cam2imgs, post_rots, post_trans, bda)

    def _multi_frame_bev(self, batch):
        """-> (the current BEV and num_adj earlier frames' after it,
        channels last, [B, gy, gx, C * num_frame]; the current frame's
        depth)."""
        bev, depth = self._frame_bev(batch["img"],
                                     *(batch[k] for k in _MATS))
        return self._temporal_bev(bev, batch), depth

    def _temporal_bev(self, bev, batch):
        """The current BEV [B, gy, gx, C] with num_adj earlier frames'
        after it: from bev_adj, else from img_adj (encoded without
        gradient), else the current BEV again, detached."""
        if self.num_adj == 0:
            return bev
        bevs = [bev]
        if batch.get("bev_adj") is not None:
            bev_adj = batch["bev_adj"]
            if bev_adj.dim() == 4:
                bev_adj = bev_adj[:, None]
            for f in range(self.num_adj):
                bevs.append(bev_adj[:, min(f, bev_adj.shape[1] - 1)]
                            .detach())
        elif batch.get("img_adj") is None:
            bevs.extend([bev.detach()] * self.num_adj)
        else:
            img_adj, rots_adj, trans_adj = (batch["img_adj"],
                                            batch["rots_adj"],
                                            batch["trans_adj"])
            if img_adj.dim() == 5:              # one frame, no frame axis
                img_adj = img_adj[:, None]
            if rots_adj.dim() == 4:
                rots_adj, trans_adj = rots_adj[:, None], trans_adj[:, None]
            have = img_adj.shape[1]
            with torch.no_grad():
                for f in range(self.num_adj):
                    fi = min(f, have - 1)
                    bevs.append(self._frame_bev(
                        img_adj[:, fi], rots_adj[:, fi], trans_adj[:, fi],
                        *(batch[k] for k in _MATS[2:]))[0])
        return torch.cat(bevs, dim=-1)

    def extract_feat(self, batch):
        """-> (the BEV neck's map [B, C, H, W], the current frame's depth
        [B, N, D, h, w])."""
        bev, depth = self._multi_frame_bev(batch)
        x = self.img_bev_encoder_neck(self.img_bev_encoder_backbone(
            bev.permute(0, 3, 1, 2).contiguous()))
        if isinstance(x, (tuple, list)):
            x = x[0]
        return x, depth

    # ---------------------------------------------------------------- entry
    def train_forward(self, batch) -> dict:
        """-> {"loss" (the total), the head's hybrid losses, loss_depth
        with use_depth and a gt_depth}."""
        feats, depth = self.extract_feat(batch)
        all_cls, all_bbox = self.bbox_head(feats, training=True)
        gt_boxes = batch["gt_boxes"]
        # bottom z -> centre z, the yaw wrapped
        gt_boxes = torch.cat([
            gt_boxes[..., :2], gt_boxes[..., 2:3] + gt_boxes[..., 5:6] / 2,
            gt_boxes[..., 3:6],
            limit_period(gt_boxes[..., 6:7], 0.5, 2 * math.pi),
            gt_boxes[..., 7:]], dim=-1)
        losses = self.bbox_head.loss(all_cls, all_bbox, gt_boxes,
                                     batch["gt_labels"])
        if self.use_depth and "gt_depth" in batch:
            dl = self.img_view_transformer.get_depth_loss(batch["gt_depth"],
                                                          depth)
            losses["loss_depth"] = dl
            losses["loss"] = losses["loss"] + dl
        return losses

    @torch.no_grad()
    def test_forward(self, batch) -> dict:
        """-> box3d_lidar [B, K, 9] (bottom z), scores [B, K], label_preds
        [B, K] (-1 where a score is not above test_cfg's threshold)."""
        raise_if_training(self)
        feats, _ = self.extract_feat(batch)
        return self.bbox_head.predict(
            *self.bbox_head(feats, training=False),
            score_threshold=self.test_cfg.get("score_threshold", 0.0))

    postprocess_to_samples = staticmethod(PETR.postprocess_to_samples)
