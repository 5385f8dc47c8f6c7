"""DD3D monocular FCOS-style detector, torch port of
paddle3d_tpu/models/detection/dd3d/dd3d.py (DD3D).

Image -> backbone (DLABase34 or VoVNet-99) -> FPN -> at each level a
shared tower of GroupNorm convs (eps 1e-6) and four 3 x 3 heads: class
logits, centerness, the 2-D box (l, t, r, b; softplus times the stride)
and eight 3-D terms (depth, scaled by the level's learned depth_scale and
depth_ref, the projected-centre offset, log dims over a class reference,
the (sin, cos) orientation). Training assigns every pixel of a level to the
smallest in-range gt 2-D box that holds it (the first on ties) and sums the
focal class loss, the 2-D box smooth-L1, the centerness BCE and the 3-D L1
terms over the foreground. Serving takes each level's top max_detection
(pixel, class) scores (sigmoid(cls) x sigmoid(ctr), a stable descending
sort: jax.lax.top_k's order on ties) and unprojects their centres through
K_inv. No hand kernel is on this path: the convolutions run on cuDNN and
the decode is a sort and gathers.

Batch contract (fixed shapes):
    data:         [B, H, W, 3] NHWC images in [0, 255]
    K_inv:        [B, 3, 3] the inverse intrinsics (test_forward)
    gt_boxes_2d:  [B, G, 4] x1, y1, x2, y2 in input pixels (train)
    gt_boxes_cam: [B, G, 7] x, y, z, h, w, l, ry in the camera frame
    gt_labels:    [B, G] (-1 padded)
The head outputs are kept NHWC, so that a level's flat index is the JAX
package's (y, x, class).

`postprocess_to_samples` gives camera-frame Samples. The runtime cannot
train or serve DD3D's configs yet: they pair KittiMonoDataset with no
target transform, so a batch holds `data` alone, without the gt keys above
and K_inv, as in the JAX package (ROADMAP.md, section 3; queue 1, item 5).
"""
from typing import Sequence

import numpy as np

import torch
import torch.nn.functional as F
from torch import nn

from ....apis import manager
from ....sample import Sample
from ...base.base_model import BaseMonoModel, raise_if_training
from ...layers.layer_libs import Sequential, default_generator, uniform_init
from ...losses.weighted_loss import sigmoid_focal_loss, smooth_l1_loss

__all__ = ["DD3D"]

GN_EPS = 1e-6       # flax nnx.GroupNorm's epsilon


def _conv(cin, cout, bias, generator):
    """nnx.Conv(3 x 3, "SAME") with uniform(±1/sqrt(fan_in)) weights and
    a constant bias (or none)."""
    conv = nn.utils.skip_init(nn.Conv2d, cin, cout, 3, padding=1,
                              bias=bias is not None)
    uniform_init(conv.weight, generator)
    if bias is not None:
        nn.init.constant_(conv.bias, bias)
    return conv


def _conv_gn_relu(cin, cout, generator):
    return Sequential(_conv(cin, cout, None, generator),
                      nn.GroupNorm(min(32, cout), cout, eps=GN_EPS),
                      nn.ReLU())


def _level_grid(h, w, stride, like):
    """Pixel centres of a level, (py, px) [h, w] in input pixels."""
    ys = (torch.arange(h, device=like.device, dtype=like.dtype) + 0.5) * \
        stride
    xs = (torch.arange(w, device=like.device, dtype=like.dtype) + 0.5) * \
        stride
    return torch.meshgrid(ys, xs, indexing="ij")


@manager.MODELS.add_component
class DD3D(BaseMonoModel):
    def __init__(self,
                 backbone,
                 neck=None,
                 num_classes: int = 3,
                 in_channels: int = 256,
                 feat_channels: int = 128,
                 num_convs: int = 2,
                 strides: Sequence[int] = (8, 16, 32),
                 size_ranges: Sequence[Sequence[float]] = ((0, 64),
                                                           (64, 128),
                                                           (128, 1e8)),
                 depth_ref: Sequence[float] = (28.01, 16.32),
                 dim_ref=((3.88, 1.63, 1.53), (0.84, 1.76, 0.66),
                          (1.76, 1.73, 0.6)),
                 max_detection: int = 100,
                 score_threshold: float = 0.2,
                 pretrained: str = None,
                 fpn=None,
                 fcos2d_head: dict = None,
                 fcos3d_head: dict = None,
                 fcos2d_loss: dict = None,
                 fcos3d_loss: dict = None,
                 fcos2d_inference: dict = None,
                 fcos3d_inference: dict = None,
                 feature_locations_offset: str = None,
                 prepare_targets: dict = None,
                 generator: torch.Generator = None):
        super().__init__()
        # the reference YAML's FCOS2D / 3D sub-components fold into the
        # shared tower; their specs translate the knobs that overlap
        del feature_locations_offset, prepare_targets, fcos3d_head
        del fcos2d_loss, fcos3d_loss, fcos3d_inference
        if fpn is not None and neck is None:
            neck = fpn
        if isinstance(fcos2d_head, dict):
            num_classes = fcos2d_head.get("num_classes", num_classes)
            strides3 = fcos2d_head.get("in_strides", None)
            if strides3:
                strides = list(strides3)[:len(strides)] if \
                    len(strides3) >= len(strides) else strides
            chans = fcos2d_head.get("in_channels")
            if chans:
                in_channels = chans[0]
            num_convs = fcos2d_head.get("num_cls_convs", num_convs)
        if isinstance(fcos2d_inference, dict):
            score_threshold = fcos2d_inference.get("pre_nms_thresh",
                                                   score_threshold)
            max_detection = fcos2d_inference.get("post_nms_topk",
                                                 max_detection)
        generator = default_generator(generator)
        self.backbone = backbone
        self.neck = neck
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.size_ranges = tuple(tuple(r) for r in size_ranges)
        self.depth_ref = tuple(map(float, depth_ref))
        self.register_buffer("dim_ref", torch.tensor(dim_ref,
                                                     dtype=torch.float32),
                             persistent=False)
        self.max_detection = max_detection
        self.score_threshold = score_threshold
        self.pretrained = pretrained

        towers = []
        c = in_channels
        for _ in range(num_convs):
            towers.append(_conv_gn_relu(c, feat_channels, generator))
            c = feat_channels
        self.tower = nn.ModuleList(towers)
        self.cls_head = _conv(feat_channels, num_classes, -2.19, generator)
        self.ctr_head = _conv(feat_channels, 1, 0.0, generator)
        self.box2d_head = _conv(feat_channels, 4, 0.0, generator)
        # 3-D: depth 1, offset 2, dims 3, orientation (sin, cos) 2
        self.box3d_head = _conv(feat_channels, 8, 0.0, generator)
        # a learned depth scale a level
        self.depth_scales = nn.Parameter(torch.ones(len(self.strides)))

    def forward_levels(self, img):
        """img [B, 3, H, W] -> level_outputs of the FPN's maps."""
        feats = self.backbone(img)
        if self.neck is not None:
            feats = self.neck(feats)
        return self.level_outputs(feats)

    def level_outputs(self, feats):
        """The FPN's NCHW maps -> a dict a level of NHWC maps: cls [B, h,
        w, C], ctr [B, h, w, 1], box2d [B, h, w, 4] (pixels), depth [B, h,
        w], offset [B, h, w, 2], dims [B, h, w, 3], ori [B, h, w, 2], and
        its stride."""
        outs = []
        for lvl, f in enumerate(feats[:len(self.strides)]):
            x = f
            for layer in self.tower:
                x = layer(x)

            def nhwc(head):
                return head(x).permute(0, 2, 3, 1)
            b3d = nhwc(self.box3d_head)
            stride = self.strides[lvl]
            outs.append({
                "cls": nhwc(self.cls_head),
                "ctr": nhwc(self.ctr_head),
                "box2d": F.softplus(nhwc(self.box2d_head)) * stride,
                "depth": b3d[..., 0] * self.depth_ref[1] *
                self.depth_scales[lvl] + self.depth_ref[0],
                "offset": b3d[..., 1:3],
                "dims": b3d[..., 3:6],
                "ori": b3d[..., 6:8],
                "stride": stride,
            })
        return outs

    @staticmethod
    def _images(batch):
        return (batch["data"] / 255.0).permute(0, 3, 1, 2).contiguous()

    # ----------------------------------------------------------------- train
    def train_forward(self, batch) -> dict:
        """-> {"loss", "loss_cls", "loss_box2d", "loss_ctr", "loss_3d"}.
        Each level's FCOS assignment: a pixel centre strictly inside a gt
        2-D box whose largest (l, t, r, b) lies in the level's size range
        is foreground, assigned the smallest such box (the first on ties);
        each loss a level is its sum over the batch over the level's
        foreground count (at least 1)."""
        gt2d = batch["gt_boxes_2d"]
        gt3d = batch["gt_boxes_cam"]
        gt_labels = batch["gt_labels"].long()
        outs = self.forward_levels(self._images(batch))
        nc = self.num_classes
        total_cls = total_box = total_ctr = total_3d = 0.
        for lvl, out in enumerate(outs):
            b, h, w, _ = out["cls"].shape
            stride = out["stride"]
            py, px = _level_grid(h, w, stride, gt2d)
            lo, hi = self.size_ranges[lvl]
            g = gt2d[..., None, None, :]                 # [B, G, 1, 1, 4]
            ltrb = torch.stack([px - g[..., 0], py - g[..., 1],
                                g[..., 2] - px, g[..., 3] - py], dim=-1)
            inside = ltrb.amin(dim=-1) > 0
            max_reg = ltrb.amax(dim=-1)
            valid = inside & (max_reg >= lo) & (max_reg <= hi) & \
                (gt_labels >= 0)[:, :, None, None]
            area = ((gt2d[..., 2] - gt2d[..., 0]) *
                    (gt2d[..., 3] - gt2d[..., 1]))[:, :, None, None]
            area = torch.where(valid, area, 1e10)
            gi = torch.argmin(area, dim=1)               # [B, h, w]
            fg = valid.any(dim=1)
            tgt_cls = torch.where(fg, torch.gather(
                gt_labels, 1, gi.reshape(b, -1)).reshape(b, h, w), nc)
            onehot = F.one_hot(tgt_cls, nc + 1)[..., :nc].to(
                out["cls"].dtype)
            num_fg = torch.clamp(fg.sum(), min=1)
            total_cls = total_cls + sigmoid_focal_loss(
                out["cls"], onehot).sum() / num_fg

            tgt_ltrb = torch.gather(
                ltrb, 1, gi[:, None, :, :, None].expand(-1, -1, -1, -1, 4)
            )[:, 0]
            total_box = total_box + torch.where(
                fg[..., None], smooth_l1_loss(out["box2d"] / stride,
                                              tgt_ltrb / stride),
                0.).sum() / num_fg

            lr = tgt_ltrb[..., [0, 2]]
            tb = tgt_ltrb[..., [1, 3]]
            ctr_tgt = torch.sqrt(torch.clamp(
                (lr.amin(-1) / torch.clamp(lr.amax(-1), min=1e-6)) *
                (tb.amin(-1) / torch.clamp(tb.amax(-1), min=1e-6)), 0, 1))
            c = out["ctr"][..., 0]
            ctr_bce = (torch.clamp(c, min=0) - c * ctr_tgt +
                       torch.log1p(torch.exp(-c.abs())))
            total_ctr = total_ctr + torch.where(fg, ctr_bce, 0.).sum() / \
                num_fg

            # 3-D: depth, dims and orientation at the foreground
            tgt3d = torch.gather(
                gt3d, 1, gi.reshape(b, -1, 1).expand(-1, -1, 7)).reshape(
                    b, h, w, 7)
            depth_l1 = (out["depth"] - tgt3d[..., 2]).abs()
            ref = self.dim_ref.to(out["dims"].dtype)[
                torch.clamp(tgt_cls, 0, nc - 1)]
            dims_l1 = (ref * torch.exp(out["dims"]) -
                       tgt3d[..., 3:6]).abs().sum(-1)
            ori = out["ori"] / torch.clamp(
                torch.linalg.norm(out["ori"], dim=-1, keepdim=True),
                min=1e-6)
            ori_l1 = ((ori[..., 0] - torch.sin(tgt3d[..., 6])).abs() +
                      (ori[..., 1] - torch.cos(tgt3d[..., 6])).abs())
            total_3d = total_3d + torch.where(
                fg, depth_l1 + dims_l1 + ori_l1, 0.).sum() / num_fg

        loss = total_cls + total_box + 0.5 * total_ctr + total_3d
        return {"loss": loss, "loss_cls": total_cls, "loss_box2d": total_box,
                "loss_ctr": total_ctr, "loss_3d": total_3d}

    # ------------------------------------------------------------------ test
    @torch.no_grad()
    def test_forward(self, batch) -> dict:
        """-> box3d_cam [B, L * K, 7] (x, y, z, h, w, l, ry; y at the
        bottom), scores [B, L * K], label_preds [B, L * K]; K =
        min(max_detection, h * w * C) a level, entries under
        score_threshold at -1. The model must be in eval mode."""
        raise_if_training(self)
        return self.decode(self.forward_levels(self._images(batch)),
                           batch["K_inv"])

    def decode(self, outs, k_inv):
        """level_outputs and K_inv [B, 3, 3] -> test_forward's outputs."""
        nc = self.num_classes
        boxes_all, scores_all, labels_all = [], [], []
        for out in outs:
            b, h, w, _ = out["cls"].shape
            stride = out["stride"]
            scores = torch.sigmoid(out["cls"]) * torch.sigmoid(out["ctr"])
            py, px = _level_grid(h, w, stride, scores)
            flat = scores.reshape(b, -1)
            k = min(self.max_detection, flat.shape[1])
            top, idx = torch.sort(flat, dim=1, descending=True, stable=True)
            top, idx = top[:, :k], idx[:, :k]
            pix = torch.div(idx, nc, rounding_mode="floor")
            label = idx % nc

            def at(t, c):                # [B, h, w(, c)] at pix -> [B, K, c]
                return torch.gather(t.reshape(b, h * w, c), 1,
                                    pix[..., None].expand(-1, -1, c))
            off = at(out["offset"], 2)
            u = px.reshape(-1)[pix] + off[..., 0] * stride
            v = py.reshape(-1)[pix] + off[..., 1] * stride
            z = at(out["depth"], 1)[..., 0]
            xyz = torch.einsum("bij,bnj->bni", k_inv,
                               torch.stack([u * z, v * z, z], dim=-1))
            dims = self.dim_ref.to(scores.dtype)[label] * torch.exp(
                at(out["dims"], 3))
            o = at(out["ori"], 2)
            ry = torch.atan2(o[..., 0], o[..., 1])
            xyz = torch.stack([xyz[..., 0], xyz[..., 1] + dims[..., 0] / 2,
                               xyz[..., 2]], dim=-1)
            boxes_all.append(torch.cat([xyz, dims, ry[..., None]], dim=-1))
            keep = top >= self.score_threshold
            scores_all.append(torch.where(keep, top, -1.))
            labels_all.append(torch.where(keep, label, -1))
        return {"box3d_cam": torch.cat(boxes_all, dim=1),
                "scores": torch.cat(scores_all, dim=1),
                "label_preds": torch.cat(labels_all, dim=1)}

    @staticmethod
    def postprocess_to_samples(outputs: dict, metas: list) -> list:
        """Fixed-shape outputs (numpy, -1 padded) -> one camera-frame
        Sample a meta: boxes, labels and confidences of the rows with a
        score >= 0 (the JAX package's DD3D.postprocess_to_samples,
        dd3d.py:282-296)."""
        boxes = np.asarray(outputs["box3d_cam"])
        scores = np.asarray(outputs["scores"])
        labels = np.asarray(outputs["label_preds"])
        results = []
        for i, meta in enumerate(metas):
            valid = scores[i] >= 0
            s = Sample(path=meta.get("path"), modality="image")
            s.bboxes_3d = boxes[i][valid]
            s.labels = labels[i][valid]
            s.confidences = scores[i][valid]
            s.frame = "camera"
            s.meta.update({k: v for k, v in meta.items() if k != "path"})
            results.append(s)
        return results
