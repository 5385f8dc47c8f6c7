"""PETR multi-view 3-D detector, torch port of
paddle3d_tpu/models/detection/petr/petr3d.py (PETR: v1, v2, query
denoising, the BEV segmentation head).

Batch contract (fixed shapes):
    img:             [B, N_cam, H, W, 3] NHWC images
    img2lidars:      [B, N_cam, 4, 4]   lidar <- normalised-image frustum
                                        ([0, 1] image coordinates times
                                        depth)
    gt_boxes:        [B, G, 7|9] bottom-z lidar boxes (+ vx, vy)
    gt_labels:       [B, G] (-1 padded)
    gt_semantic_map: [B, bev_h, bev_w, C] in {0, 1} (with a seg head)
    lidar2cams:      [B, N_cam, 4, 4]   lidar -> each camera's frame (for a
                                        head that wants_lidar2cams: CAPE)

The N images of a sample run through the backbone and the neck as one
NCHW batch; the neck's first (finest) level is the head's feature map.
version 2 (PETRv2) takes the previous frame's images as N/2 more views,
whose img2lidar matrices carry the ego motion, and adds a learned time
embedding to each frame's features (when their channels fit it); the
version defaults to 2 for a head with_time (CAPE-T), else 1. With
dn_config, train_forward adds noisy gt queries (heads/denoising.py) drawn
from an explicit torch.Generator. test_forward refuses a model in train
mode, as the port's other models do.

`postprocess_to_samples` gives nuScenes-lidar Samples (velocities and the
segmentation head's map where present). Not ported yet: the JAX model's
other names for its parts
(img_backbone / img_neck / pts_bbox_head, a PETRHead's with_time and
with_denoise), which the reference type names bring (ROADMAP.md, queue 1,
item 5): no config of the repo sets them.
"""
import numpy as np
import torch
from torch import nn

from ....apis import manager
from ....geometries import BBoxes3D, CoordMode
from ....sample import Sample
from ...base.base_model import BaseMultiViewModel, raise_if_training
from ...heads.denoising import (DenoisingConfig, build_dn_queries,
                                dn_attn_mask)
from ...heads.petr_head import PETRHead
from ...heads.petr_seg_head import PETRSegHead
from ...layers.layer_libs import default_generator

__all__ = ["PETR"]


@manager.MODELS.add_component
class PETR(BaseMultiViewModel):
    def __init__(self, backbone=None, neck=None, head=None, seg_head=None,
                 use_grid_mask: bool = False, version: int = None,
                 dn_config: dict = None, pretrained: str = None,
                 generator: torch.Generator = None):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        if isinstance(head, dict):
            # the reference's PETRHeadseg spec (det queries and num_lane
            # seg queries in one head) -> a PETRHead and a PETRSegHead
            spec = {k: v for k, v in head.items() if k != "type"}
            num_lane = int(spec.pop("num_lane", 256))
            patch = 16
            side = int(round(num_lane ** 0.5)) * patch
            seg_spec = {k: v for k, v in spec.items()
                        if k not in ("num_query", "num_classes")}
            head = PETRHead(**spec)
            if seg_head is None:
                seg_head = PETRSegHead(num_classes=3, bev_size=(side, side),
                                       patch_size=patch, **seg_spec)
        if version is None:
            version = 2 if getattr(head, "with_time", False) else 1
        self.head = head
        self.seg_head = seg_head
        self.use_grid_mask = use_grid_mask
        self.version = version
        self.pretrained = pretrained
        self.dn_cfg = DenoisingConfig(**dn_config) if dn_config else None
        # the DN noise is drawn on the host, whatever the model's device
        self.dn_generator = torch.Generator().manual_seed(0)
        # a test sets a callable (B, G) -> heads/denoising.dn_draws' dict
        # to hand the step given draws
        self.dn_draws = None
        if version >= 2:
            self.time_embed = nn.Parameter(torch.randn(
                (2, head.embed_dims),
                generator=default_generator(generator)) * 0.02)

    def _extract_feats(self, imgs: torch.Tensor) -> torch.Tensor:
        """imgs [B, N, H, W, 3] -> the neck's first level [B, N, C, h, w]
        (+ the time embedding in v2)."""
        b, n, h, w, c = imgs.shape
        feats = self.backbone(
            imgs.reshape(b * n, h, w, c).permute(0, 3, 1, 2).contiguous())
        if self.neck is not None:
            feats = self.neck(feats)
        f = feats[0]
        f = f.reshape((b, n) + tuple(f.shape[1:]))
        if self.version >= 2 and f.shape[2] <= self.time_embed.shape[-1]:
            # the first half of the views: the current frame, the second
            # half the previous one
            half = n // 2
            te = self.time_embed[:, :f.shape[2], None, None]
            f = torch.cat([f[:, :half] + te[0], f[:, half:] + te[1]], dim=1)
        return f

    def _head_kwargs(self, batch) -> dict:
        if getattr(self.head, "wants_lidar2cams", False) and \
                "lidar2cams" in batch:
            return {"lidar2cams": batch["lidar2cams"]}
        return {}

    def train_forward(self, batch) -> dict:
        feats = self._extract_feats(batch["img"])
        gt_boxes = batch["gt_boxes"].clone()
        gt_boxes[..., 2] += batch["gt_boxes"][..., 5] / 2   # bottom -> centre
        gt_labels = batch["gt_labels"]
        dn_meta = dn_ref = attn_mask = None
        if self.dn_cfg is not None:
            dn_meta = build_dn_queries(
                gt_boxes, gt_labels, self.head.num_classes,
                self.head.pc_range, self.dn_cfg, generator=self.dn_generator,
                draws=self.dn_draws(*gt_labels.shape) if self.dn_draws
                else None)
            dn_ref = dn_meta["ref"]
            attn_mask = dn_attn_mask(self.head.num_query, dn_meta["groups"],
                                     dn_meta["group_size"], feats.device)
        all_cls, all_bbox = self.head(feats, batch["img2lidars"],
                                      dn_ref=dn_ref, attn_mask=attn_mask,
                                      **self._head_kwargs(batch))
        losses = self.head.loss(all_cls, all_bbox, gt_boxes, gt_labels,
                                dn_meta=dn_meta)
        if self.seg_head is not None and "gt_semantic_map" in batch:
            seg_losses = self.seg_head.loss(
                self.seg_head(feats, batch["img2lidars"]),
                batch["gt_semantic_map"])
            losses["loss"] = losses["loss"] + seg_losses.pop("loss_seg")
            losses.update(seg_losses)
        return losses

    @torch.no_grad()
    def test_forward(self, batch) -> dict:
        raise_if_training(self)
        feats = self._extract_feats(batch["img"])
        out = self.head.predict(*self.head(feats, batch["img2lidars"],
                                           **self._head_kwargs(batch)))
        if self.seg_head is not None:
            out.update(self.seg_head.predict(
                self.seg_head(feats, batch["img2lidars"])))
        return out

    @staticmethod
    def postprocess_to_samples(outputs: dict, metas: list) -> list:
        """Fixed-shape outputs (numpy: box3d_lidar [B, K, 7 | 9] bottom-z,
        scores, label_preds, -1 padded; seg_probs with a seg head) -> one
        Sample a meta (the JAX package's PETR.postprocess_to_samples,
        petr3d.py:147-168)."""
        boxes = np.asarray(outputs["box3d_lidar"])
        scores = np.asarray(outputs["scores"])
        labels = np.asarray(outputs["label_preds"])
        results = []
        for i, meta in enumerate(metas):
            valid = scores[i] >= 0
            s = Sample(path=meta.get("path"), modality="multiview")
            b = boxes[i][valid]
            s.bboxes_3d = BBoxes3D(
                b[:, :7], origin=[.5, .5, 0.],
                coordmode=CoordMode.NuScenesLidar, rot_axis=2)
            if b.shape[-1] >= 9:
                s.bboxes_3d.velocities = b[:, 7:9]
            s.labels = labels[i][valid]
            s.confidences = scores[i][valid]
            if "seg_probs" in outputs:
                s.pred_semantic_map = np.asarray(outputs["seg_probs"][i])
            s.meta.update(
                {k: v for k, v in meta.items() if k not in ("path",)})
            results.append(s)
        return results
