"""SMOKE monocular 3-D detector, torch port of
paddle3d_tpu/models/detection/smoke/smoke.py (SMOKE).

DLA backbone -> SMOKEPredictor -> (train) the disentangled-L1 loss, or
(test) heatmap NMS and a top-k decode, all at fixed shapes, in camera-frame
outputs. Images arrive as the JAX package takes them, NHWC [B, H, W, 3] in
[0, 255], and run NCHW through the convs. The decode's row gather is the
hand-written K14 (ops/gather.gather_rows): the top-k rows of the NCHW
regression map, read in place as the strided [B, H*W, R] view
(reg.flatten(2).transpose(1, 2)), the port of the JAX decode's
reg.reshape(h*w, -1)[pos]. `postprocess_to_samples` gives the runtime's
camera-frame Samples (boxes, 2-D boxes, alphas), which KittiMetric scores
as camera-frame predictions.
"""
import numpy as np
import torch

from ....apis import manager
from ....ops import gather
from ....sample import Sample
from ...base.base_model import BaseMonoModel
from ...layers.layer_libs import heatmap_nms
from .smoke_coder import SMOKECoder
from .smoke_loss import SMOKELossComputation

__all__ = ["SMOKE"]


@manager.MODELS.add_component
class SMOKE(BaseMonoModel):
    def __init__(self,
                 backbone,
                 head,
                 loss=None,
                 depth_ref=(28.01, 16.32),
                 dim_ref=((3.88, 1.63, 1.53), (0.84, 1.76, 0.66),
                          (1.76, 1.73, 0.6)),
                 max_detection: int = 50,
                 det_threshold: float = 0.25,
                 pretrained: str = None):
        super().__init__()
        self.backbone = backbone
        self.head = head
        if loss is None:
            # the reference configs pass no loss block: build it, as the
            # JAX package does
            loss = SMOKELossComputation(depth_ref, dim_ref,
                                        max_objs=max_detection)
        self.loss_fn = loss
        self.coder = SMOKECoder(depth_ref, dim_ref)
        self.max_detection = max_detection
        self.det_threshold = det_threshold
        self.pretrained = pretrained

    def _maps(self, images):
        """NHWC images in [0, 255] -> (heatmap, regression), NHWC views."""
        x = images.permute(0, 3, 1, 2).contiguous() / 255.0
        return self.head(self.backbone(x))

    def train_forward(self, batch) -> dict:
        hm, reg = self._maps(batch["data"])
        return self.loss_fn(hm, reg, batch["target"])

    @torch.no_grad()
    def test_forward(self, batch) -> dict:
        """-> box3d_cam [B, K, 7] (x, y_bottom, z, h, w, l, ry), scores
        [B, K] (-1 padded), label_preds [B, K] (-1 padded), bbox_2d
        [B, K, 4] (feature-map scale x down_ratio = image pixels), alphas
        [B, K]."""
        target = batch["target"]
        hm, reg = self._maps(batch["data"])
        hm = heatmap_nms(hm)
        b, h, w, c = hm.shape
        k = self.max_detection
        # class-major scores, as the JAX decode flattens [C, H, W]; top-k
        # as a stable descending sort: ties in index order, as
        # jax.lax.top_k breaks them (after the NMS, zeros and plateaus tie)
        scores_flat = hm.permute(0, 3, 1, 2).reshape(b, c * h * w)
        top_scores, top_idx = torch.sort(scores_flat, dim=-1,
                                         descending=True, stable=True)
        top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
        cls_id = torch.div(top_idx, h * w, rounding_mode="floor")
        pos = top_idx - cls_id * (h * w)
        ys = torch.div(pos, w, rounding_mode="floor")
        xs = (pos - ys * w).to(torch.float32)
        ys = ys.to(torch.float32)
        # the NCHW regression map as [B, H*W, R] rows, read in place
        rows = reg.permute(0, 3, 1, 2).flatten(2).transpose(1, 2)
        pois = gather.gather_rows(rows, pos.to(torch.int32))  # [B, K, R]

        down = target["down_ratio"][:, None, :]               # [B, 1, 2]
        depths = self.coder.decode_depth(pois[..., 0])
        proj = (torch.stack([xs, ys], dim=-1) + pois[..., 1:3]) * down
        homo = torch.cat([proj, torch.ones_like(proj[..., :1])], dim=-1)
        locs = torch.einsum("bij,bkj->bki", target["K_inv"],
                            homo * depths[..., None])
        dims = self.coder.decode_dimension(cls_id, pois[..., 3:6])
        locs = torch.cat([locs[..., :1], locs[..., 1:2] + dims[..., :1] / 2,
                          locs[..., 2:]], dim=-1)
        rotys, alphas = self.coder.decode_orientation(pois[..., 6:8], locs)
        boxes = torch.cat([locs, dims, rotys[..., None]], dim=-1)
        valid = top_scores >= self.det_threshold
        if pois.shape[-1] >= 10:
            half = pois[..., 8:10] / 2 * down
            bbox2d = torch.cat([proj - half, proj + half], dim=-1)
        else:
            bbox2d = boxes.new_zeros((b, k, 4))
        return {
            "box3d_cam": boxes,
            "scores": torch.where(valid, top_scores, -1.),
            "label_preds": torch.where(valid, cls_id, -1),
            "bbox_2d": bbox2d,
            "alphas": alphas,
        }

    @staticmethod
    def postprocess_to_samples(outputs: dict, metas: list) -> list:
        """Fixed-shape outputs (numpy, -1 padded) -> one camera-frame
        Sample a meta: the rows with a score >= 0, (x, y, z, h, w, l, ry)
        boxes, 2-D boxes, labels, confidences and alphas (the JAX package's
        SMOKE.postprocess_to_samples, smoke.py:108-127)."""
        boxes = np.asarray(outputs["box3d_cam"])
        scores = np.asarray(outputs["scores"])
        labels = np.asarray(outputs["label_preds"])
        bbox2d = np.asarray(outputs["bbox_2d"])
        alphas = np.asarray(outputs["alphas"])
        results = []
        for i, meta in enumerate(metas):
            valid = scores[i] >= 0
            s = Sample(path=meta.get("path"), modality="image")
            s.bboxes_3d = boxes[i][valid]      # camera frame (x,y,z,h,w,l,ry)
            s.bboxes_2d = bbox2d[i][valid]
            s.labels = labels[i][valid]
            s.confidences = scores[i][valid]
            s.alpha = alphas[i][valid]
            s.frame = "camera"
            s.meta.update(
                {k: v for k, v in meta.items() if k not in ("path",)})
            results.append(s)
        return results
