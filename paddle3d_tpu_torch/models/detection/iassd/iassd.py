"""IA-SSD point-based single-stage detector, torch port of
paddle3d_tpu/models/detection/iassd/iassd.py.

Instance-aware downsampling: early SA layers sample by farthest point,
later ones keep the top-k most confident foreground points (ctr_aware); a
vote layer shifts the survivors toward instance centroids, the features of
the last SA set are grouped around the votes, and a point head regresses
centre offset, size and angle per candidate; rotated NMS at the end. All
stages are the masked fixed-capacity batch layout of
models/common/pointnet2_modules.

Training: each candidate (the votes, and the sampled points of every
confidence layer) is assigned to the nearest valid gt box in BEV, foreground
when inside that box's circumscribed circle; sigmoid focal loss on the
classes, smooth-L1 on (centre offset, size, sin / cos of the yaw) of the
foreground votes, and the SA layers' confidences supervised the same way.
The farthest-point and ball-query indices are constants; gradients flow
through the grouping gathers, as in the JAX package.
"""
from typing import Sequence

import torch
import torch.nn.functional as F

from ....apis import manager
from ....ops.iou3d_nms import nms_bev
from ....ops.pointnet2 import first_argmax, gather_operation
from ...base.base_model import BaseLidarModel, raise_if_training
from ...common.pointnet2_modules import (PointMLP, SAModuleMSG, Sequential,
                                         VoteLayer, group_max, linear)
from ...layers.layer_libs import default_generator
from ...losses.weighted_loss import sigmoid_focal_loss, smooth_l1_loss

__all__ = ["IASSD"]


@manager.MODELS.add_component
class IASSD(BaseLidarModel):
    def __init__(self,
                 num_classes: int = 3,
                 input_channel: int = 4,
                 npoint_list: Sequence[int] = (4096, 1024, 512, 256),
                 sample_method_list: Sequence[str] = ("d-fps", "d-fps",
                                                      "ctr_aware",
                                                      "ctr_aware"),
                 radius_list=((0.2, 0.8), (0.8, 1.6), (1.6, 4.8),
                              (4.8, 6.4)),
                 nsample_list=((16, 32), (16, 32), (16, 32), (16, 32)),
                 mlps=(((16, 16, 32), (32, 32, 64)),
                       ((64, 64, 128), (64, 96, 128)),
                       ((128, 128, 256), (128, 256, 256)),
                       ((256, 256, 512), (256, 512, 512))),
                 aggregation_mlps=((64,), (128,), (256,), (512,)),
                 confidence_mlps=((), (), (128,), (256,)),
                 vote_mlps: Sequence[int] = (128,),
                 max_translate_range: Sequence[float] = (3.0, 3.0, 2.0),
                 cls_fc: Sequence[int] = (256, 256),
                 reg_fc: Sequence[int] = (256, 256),
                 nms_cfg: dict = None,
                 point_cloud_range: Sequence[float] = (0, -40, -3, 70.4, 40,
                                                       1),
                 pretrained: str = None,
                 backbone: dict = None,
                 head: dict = None,
                 generator: torch.Generator = None):
        # The IASSD_Backbone / IASSD_Head dict specs of the reference YAMLs
        # unpack onto this flat surface. The 6-slot layer list folds: SA
        # layers with radii -> the first grouping stages; the radius-less
        # ctr_aware slot -> the 4th (sampling) stage, taking the final SA
        # slot's grouping params; Vote_Layer mlps -> vote_mlps.
        super().__init__()
        if isinstance(backbone, dict):
            bt = backbone
            types = list(bt["layer_types"])
            radii = list(bt["radius_list"])
            sa = [i for i, t in enumerate(types)
                  if t == "SA_Layer" and radii[i]]
            sample_only = [i for i, t in enumerate(types)
                           if t == "SA_Layer" and not radii[i]]
            vote_i = types.index("Vote_Layer")
            first, last = sa[:-1], sa[-1]
            fourth = sample_only[0] if sample_only else last

            def pick(key, idxs):
                vals = list(bt[key])
                return [vals[i] for i in idxs]

            npoint_list = pick("npoint_list", first) + \
                [bt["npoint_list"][fourth]]
            sample_method_list = [
                (s or "d-fps").lower()
                for s in pick("sample_method_list", first) +
                [bt["sample_method_list"][fourth] or "ctr_aware"]]
            radius_list = pick("radius_list", first + [last])
            nsample_list = pick("nsample_list", first + [last])
            mlps = pick("mlps", first + [last])
            aggregation_mlps = pick("aggregation_mlps", first + [last])
            confidence_mlps = pick("confidence_mlps", first) + [[]]
            vm = bt["mlps"][vote_i]
            vote_mlps = list(vm) if vm else vote_mlps
            max_translate_range = bt.get("max_translate_range",
                                         max_translate_range)
            input_channel = bt.get("input_channel", input_channel)
            num_classes = bt.get("num_classes", num_classes)
        if isinstance(head, dict):
            cls_fc = head.get("cls_fc", cls_fc)
            reg_fc = head.get("reg_fc", reg_fc)
            num_classes = head.get("num_classes", num_classes)
        g = default_generator(generator)
        self.num_classes = num_classes
        self.point_cloud_range = list(map(float, point_cloud_range))
        self.nms_cfg = dict(nms_cfg or dict(
            score_threshold=0.1, iou_threshold=0.01, pre_max_size=512,
            post_max_size=128))
        self.pretrained = pretrained

        self.sa_modules = torch.nn.ModuleList()
        cin = input_channel - 3
        for k in range(len(npoint_list)):
            mod = SAModuleMSG(
                npoint=npoint_list[k],
                radii=radius_list[k],
                nsamples=nsample_list[k],
                mlps=[list(m) for m in mlps[k]],
                in_channels=cin,
                sample_type=sample_method_list[k],
                aggregation_mlp=list(aggregation_mlps[k]) or None,
                confidence_mlp=list(confidence_mlps[k]) or None,
                num_classes=num_classes,
                generator=g)
            self.sa_modules.append(mod)
            cin = mod.out_channels
        self.vote = VoteLayer(vote_mlps, cin, max_translate_range,
                              generator=g)
        # centre-feature aggregation around the votes: grouping only, its
        # centres are given (sample_type "identity")
        self.ctr_agg = SAModuleMSG(
            npoint=npoint_list[-1], radii=(4.8, 6.4), nsamples=(16, 32),
            mlps=[[256, 256, 512], [256, 512, 1024]],
            in_channels=vote_mlps[-1], sample_type="identity", generator=g)
        self.cls_head = Sequential(
            PointMLP([self.ctr_agg.out_channels] + list(cls_fc), generator=g),
            linear(cls_fc[-1], num_classes, g, bias_value=-2.19))
        # box: (dx, dy, dz, w, l, h, sin, cos)
        self.reg_head = Sequential(
            PointMLP([self.ctr_agg.out_channels] + list(reg_fc), generator=g),
            linear(reg_fc[-1], 8, g))

    # -------------------------------------------------------------- backbone
    def _backbone(self, points):
        mask = torch.isfinite(points).all(dim=-1)
        xyz = torch.where(mask[..., None], points[..., :3], 0.)
        feats = torch.where(mask[..., None], points[..., 3:], 0.)
        scores = None
        sa_confs = []
        for mod in self.sa_modules:
            xyz, feats, mask, conf = mod(xyz, feats, mask, scores)
            if conf is not None:
                scores = conf
                sa_confs.append((conf, xyz, mask))
        votes, vfeats, _ = self.vote(xyz, feats, mask)
        # aggregate features around the votes from the last SA set
        nf = self._aggregate(votes, xyz, vfeats, mask)
        return votes, nf, mask, sa_confs, scores

    def _aggregate(self, centers, xyz, feats, mask):
        """Group the support set around given centres (no resampling)."""
        mod = self.ctr_agg
        nf = torch.cat([
            group_max(mlp, radius, nsample, xyz, feats, mask, centers)
            for radius, nsample, mlp in zip(mod.radii, mod.nsamples,
                                            mod.scale_mlps)], dim=-1)
        if mod.aggregation is not None:
            nf = mod.aggregation(nf)
        return nf

    @staticmethod
    @torch.no_grad()
    def _assign(centers, gt_center, gt_labels):
        """Point-in-gt-BEV assignment: each centre [B, M, 3] to the nearest
        valid gt box (ties to the lowest index, as jnp.argmin), foreground
        when inside its circumscribed footprint circle. -> (gt index
        [B, M], foreground [B, M])."""
        diff = centers[:, :, None, :2] - gt_center[:, None, :, :2]
        d = torch.linalg.vector_norm(diff, dim=-1)
        d = torch.where((gt_labels >= 0)[:, None, :], d, 1e9)
        gi = first_argmax(-d, dim=-1)
        gd = torch.gather(d, 2, gi[..., None])[..., 0]
        gt = gather_operation(gt_center, gi)
        radius = 0.5 * torch.sqrt(gt[..., 3] ** 2 + gt[..., 4] ** 2)
        return gi, gd < radius

    def _cls_targets(self, gi, fg, gt_labels):
        """-> one-hot class targets [B, M, num_classes], zero rows on the
        background."""
        tgt = torch.where(fg, torch.gather(gt_labels, 1, gi),
                          self.num_classes)
        return F.one_hot(tgt.long(), self.num_classes + 1)[
            ..., :self.num_classes]

    def train_forward(self, batch) -> dict:
        """batch {"data": points [B, N, 4] (NaN padded), "gt_boxes" [B, G,
        7] (bottom-z), "gt_labels" [B, G] (classes from 0, -1 padded)} ->
        {"loss" (the sum), "loss_cls", "loss_box", "loss_sa"}; the
        foreground count of each loss is taken over the whole batch.
        Train-mode BN: batch statistics, running stats updated."""
        gt_boxes, gt_labels = batch["gt_boxes"], batch["gt_labels"]
        centers, feats, mask, sa_confs, _ = self._backbone(batch["data"])
        cls_logits = self.cls_head(feats)                  # [B, M, C]
        reg = self.reg_head(feats)                         # [B, M, 8]
        gt_center = torch.cat([
            gt_boxes[..., :2],
            (gt_boxes[..., 2] + gt_boxes[..., 5] / 2)[..., None],
            gt_boxes[..., 3:]], dim=-1)

        gi, fg = self._assign(centers, gt_center, gt_labels)
        fg = fg & mask
        num_fg = fg.sum().clamp(min=1)
        cls_loss = (sigmoid_focal_loss(
            cls_logits, self._cls_targets(gi, fg, gt_labels)) *
            mask[..., None]).sum() / num_fg
        tgt_box = gather_operation(gt_center, gi)          # [B, M, 7+]
        tgt = torch.cat([tgt_box[..., :3] - centers, tgt_box[..., 3:6],
                         torch.sin(tgt_box[..., 6:7]),
                         torch.cos(tgt_box[..., 6:7])], dim=-1)
        reg_loss = torch.where(fg[..., None], smooth_l1_loss(reg, tgt),
                               0.).sum() / num_fg

        # SA confidence (the instance-aware sampling's supervision)
        sa_loss = cls_logits.new_zeros(())
        for conf, cxyz, cmask in sa_confs:
            cgi, cfg = self._assign(cxyz, gt_center, gt_labels)
            cfg = cfg & cmask
            sa_loss = sa_loss + (sigmoid_focal_loss(
                conf, self._cls_targets(cgi, cfg, gt_labels)) *
                cmask[..., None]).sum() / cfg.sum().clamp(min=1)
        return {"loss": cls_loss + reg_loss + sa_loss, "loss_cls": cls_loss,
                "loss_box": reg_loss, "loss_sa": sa_loss}

    # ------------------------------------------------------------------ test
    @torch.no_grad()
    def test_forward(self, batch) -> dict:
        """batch {"data": points [B, N, 4] f32, NaN padded} -> box3d_lidar
        [B, K, 7] (bottom-z), scores [B, K], label_preds [B, K] (-1
        padded), K = nms_cfg post_max_size. The model must be in eval mode
        (`.eval()`)."""
        raise_if_training(self)
        centers, feats, mask, _, _ = self._backbone(batch["data"])
        cls_logits = self.cls_head(feats)
        reg = self.reg_head(feats)
        cfg = self.nms_cfg

        scores = torch.sigmoid(cls_logits)
        score = scores.max(dim=-1).values
        label = first_argmax(scores, dim=-1)
        center = centers + reg[..., :3]
        dims = reg[..., 3:6]
        yaw = torch.atan2(reg[..., 6], reg[..., 7])
        boxes = torch.cat([
            center[..., :2], (center[..., 2] - dims[..., 2] / 2)[..., None],
            dims, yaw[..., None]], dim=-1)
        valid = mask & (score >= cfg["score_threshold"])
        nms_scores = torch.where(valid, score, -torch.inf)
        keep, _ = nms_bev(boxes[..., [0, 1, 3, 4, 6]], nms_scores,
                          cfg["iou_threshold"],
                          pre_max_size=min(cfg["pre_max_size"],
                                           boxes.shape[1]),
                          post_max_size=cfg["post_max_size"])
        kept = keep >= 0
        safe = torch.where(kept, keep, 0)
        return {
            "box3d_lidar": torch.where(kept[..., None],
                                       gather_operation(boxes, safe), 0.),
            "scores": torch.where(kept, gather_operation(score, safe), -1.),
            "label_preds": torch.where(kept, gather_operation(label, safe),
                                       -1).to(torch.int32),
        }
