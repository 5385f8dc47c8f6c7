"""BEVDet / BEVDet4D multi-view 3-D detector, torch port of
paddle3d_tpu/models/detection/bevdet/bevdet.py (BEVDet).

Camera images -> image backbone (and neck) -> LSS view transform (the
depth net, the frustum lifted into the ego frame, the pool onto the BEV
grid: K7 or K2 forward, K5 backward on the card) -> BEV encoder
(CustomResNet + FPN_LSS) -> CenterHead -> decode + rotated NMS (test) or
the CenterPoint targets and losses (train). BEVDet4D concatenates num_adj
earlier frames' BEVs after the current one's; they are explicit batch
state, not module attributes.

Batch contract (fixed shapes):
    img:        [B, N, H, W, 3] NHWC images (normalised by the dataset)
    rots:       [B, N, 3, 3] camera -> ego rotation
    trans:      [B, N, 3]    camera -> ego translation
    cam2imgs:   [B, N, 3, 3] intrinsics of the image before augmentation
    post_rots:  [B, N, 3, 3], post_trans [B, N, 3]: the image
                augmentation (resize, crop, flip) in pixels
    bda:        [B, 3, 3]    the BEV augmentation
    gt_boxes:   [B, G, 7|9] bottom-z ego boxes (+ vx, vy), gt_labels
                [B, G] (-1 padded), to train
    prev_bev:   [B, gy, gx, C * num_adj] (optional) earlier frames' BEVs
    img_adj:    [B, (F,) N, H, W, 3] with rots_adj / trans_adj (optional)
                adjacent frames whose camera -> ego matrices already map
                into the current ego frame; encoded without gradient.
Without either, the current BEV stands in for the earlier frames. Each
frame's images run the backbone as one NCHW batch; each frame pooled is
one launch of the segment sum. test_forward refuses a model in train mode;
its bev_feature is the BEV the encoder took (the current frame's C
channels, then the earlier frames'), as the JAX package returns it: a
video caller hands the first C channels on as the next frame's prev_bev.

postprocess_to_samples is CenterPoint's, as in the JAX package. Not
ported: the JAX model's knobs that no config of the repo sets: pts_bbox_head, pre_process, use_depth (the depth loss is
added whenever the view transformer has one and the batch a gt_depth, as
the JAX package adds it for the BEVDepth view transformers),
align_after_view_transfromation, start_temporal_epoch.
"""
import math

import torch

from ....apis import manager
from ....ops.box_ops import limit_period
from ...base.base_model import BaseMultiViewModel, raise_if_training
from ..centerpoint.centerpoint import CenterPoint
from ..centerpoint.centerpoint_target import CenterPointTargetGenerator

__all__ = ["BEVDet"]


@manager.MODELS.add_component
class BEVDet(BaseMultiViewModel):
    def __init__(self,
                 img_backbone,
                 img_neck,
                 img_view_transformer,
                 img_bev_encoder_backbone,
                 img_bev_encoder_neck,
                 bbox_head,
                 test_cfg: dict = None,
                 target_assign_cfg: dict = None,
                 temporal: bool = False,
                 num_adj: int = None):
        super().__init__()
        self.img_backbone = img_backbone
        self.img_neck = img_neck
        self.img_view_transformer = img_view_transformer
        self.img_bev_encoder_backbone = img_bev_encoder_backbone
        self.img_bev_encoder_neck = img_bev_encoder_neck
        self.bbox_head = bbox_head
        # the reference's BEVDet4D surface: num_adj adjacent frames
        # concatenated; `temporal: True` is num_adj 1
        self.num_adj = int(num_adj) if num_adj is not None else \
            (1 if temporal else 0)
        self.temporal = self.num_adj > 0
        self.test_cfg = dict(test_cfg or {})

        ta = dict(target_assign_cfg or {})
        grid = img_view_transformer.grid_config
        self.target_generator = CenterPointTargetGenerator(
            tasks=self.bbox_head.tasks_cfg,
            down_ratio=ta.get("down_ratio", 1),
            point_cloud_range=[grid["x"][0], grid["y"][0], grid["z"][0],
                               grid["x"][1], grid["y"][1], grid["z"][1]],
            voxel_size=[grid["x"][2], grid["y"][2],
                        grid["z"][1] - grid["z"][0]],
            gaussian_overlap=ta.get("gaussian_overlap", 0.1),
            max_objs=ta.get("max_objs", 500),
            min_radius=ta.get("min_radius", 2),
            with_velocity=self.bbox_head.with_velocity)

    def image_features(self, imgs):
        """imgs [B, N, H, W, 3] -> the view transformer's input [B, N, C,
        h, w]."""
        b, n, h, w, c = imgs.shape
        x = self.img_backbone(imgs.reshape(b * n, h, w, c).permute(
            0, 3, 1, 2).contiguous())
        if self.img_neck is not None:
            x = self.img_neck(x)
        f = x[0] if isinstance(x, (tuple, list)) else x
        return f.reshape((b, n) + tuple(f.shape[1:]))

    def _camera_bev(self, imgs, rots, trans, cam2imgs, post_rots,
                    post_trans, bda):
        """One frame -> (BEV [B, gy, gx, C] NHWC, depth [B, N, D, h, w])."""
        return self.img_view_transformer(
            self.image_features(imgs), rots, trans, cam2imgs, post_rots,
            post_trans, bda)

    def _temporal_bev(self, bev, batch):
        """The current BEV with num_adj earlier frames' after it (channels
        last): from prev_bev, else from img_adj (encoded without
        gradient), else the current BEV again, detached."""
        if "prev_bev" in batch:
            prev = batch["prev_bev"]
            frames = ([prev] if prev.shape[-1] == bev.shape[-1] *
                      self.num_adj else [prev] * self.num_adj)
        elif "img_adj" in batch:
            img_adj, rots_adj, trans_adj = (batch["img_adj"],
                                            batch["rots_adj"],
                                            batch["trans_adj"])
            if img_adj.dim() == 5:
                img_adj, rots_adj, trans_adj = (img_adj[:, None],
                                                rots_adj[:, None],
                                                trans_adj[:, None])
            have = img_adj.shape[1]
            frames = []
            with torch.no_grad():
                for f in range(self.num_adj):
                    fi = min(f, have - 1)
                    frames.append(self._camera_bev(
                        img_adj[:, fi], rots_adj[:, fi], trans_adj[:, fi],
                        batch["cam2imgs"], batch["post_rots"],
                        batch["post_trans"], batch["bda"])[0])
        else:
            frames = [bev.detach()] * self.num_adj
        return torch.cat([bev] + frames, dim=-1)

    def extract_bev(self, batch):
        """-> (the neck's features [B, C, H, W], the encoder's input BEV
        [B, gy, gx, C'] NHWC, depth [B, N, D, h, w])."""
        bev, depth = self._camera_bev(
            batch["img"], batch["rots"], batch["trans"], batch["cam2imgs"],
            batch["post_rots"], batch["post_trans"], batch["bda"])
        if self.temporal:
            bev = self._temporal_bev(bev, batch)
        feats = self.img_bev_encoder_backbone(
            bev.permute(0, 3, 1, 2).contiguous())
        return self.img_bev_encoder_neck(feats), bev, depth

    def train_forward(self, batch) -> dict:
        """-> {"loss" (the total), the head's losses, and loss_depth with
        a BEVDepth view transformer and a gt_depth [B, N, H, W]}.
        Train-mode BN: batch statistics, running stats updated (an
        adjacent frame's too, after the current frame's)."""
        feats, _, depth = self.extract_bev(batch)
        preds = self.bbox_head(feats)
        gt_boxes = batch["gt_boxes"]
        gt_boxes = torch.cat([
            gt_boxes[..., :6],
            limit_period(gt_boxes[..., 6:7], 0.5, 2 * math.pi),
            gt_boxes[..., 7:]], dim=-1)
        targets = self.target_generator(gt_boxes, batch["gt_labels"])
        losses = self.bbox_head.loss(preds, targets)
        if hasattr(self.img_view_transformer, "get_depth_loss") and \
                "gt_depth" in batch:
            dl = self.img_view_transformer.get_depth_loss(batch["gt_depth"],
                                                          depth)
            losses["loss_depth"] = dl
            losses["loss"] = losses["loss"] + dl
        return losses

    @torch.no_grad()
    def test_forward(self, batch) -> dict:
        """-> box3d_lidar [B, K, 7|9] (bottom z), scores [B, K],
        label_preds [B, K] (-1 padded), bev_feature [B, gy, gx, C']."""
        raise_if_training(self)
        feats, bev, _ = self.extract_bev(batch)
        out = self.bbox_head.predict(self.bbox_head(feats), self.test_cfg)
        out["bev_feature"] = bev
        return out

    postprocess_to_samples = staticmethod(CenterPoint.postprocess_to_samples)
