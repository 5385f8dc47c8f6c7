"""PV-RCNN and Voxel-RCNN two-stage detectors, torch port of
paddle3d_tpu/models/detection/pv_rcnn/pv_rcnn.py.

Stage 1: voxel means -> sparse 3-D encoder -> dense BEV -> SECOND backbone
and FPN -> Anchor3DHead proposals. Stage 2: RoI-grid pooling over a support
set (PV-RCNN: farthest-point keypoints encoded by VoxelSetAbstraction;
Voxel-RCNN: the voxel centres of the last sparse stages), then cls/reg
refinement. The BEV keeps the JAX package's NHWC layout and goes to NCHW
only around the conv stack.

Training: the RPN loss; proposals as constants; rotated-IoU proposal
targets (heads/proposal_target_layer.py) drawn with the model's own
generator; the RoI head on the sampled RoIs over a support set whose
gradients flow back into the sparse stages; the refinement loss. The point
head's keypoint weighting is not ported yet: ROADMAP.md, queue 1, item 8b.
"""
import torch

from ....apis import manager
from ....ops.voxelize import voxel_mean_batch
from ...base.base_model import BaseLidarModel, raise_if_training
from ...heads.proposal_target_layer import (ProposalTargetConfig,
                                            proposal_targets)
from ...heads.roi_head import RoIGridHead
from ...middle_encoders.sparse_resnet import stage_voxel_centers
from ...voxel_encoders.voxel_encoder import VoxelMean

__all__ = ["PVRCNN", "VoxelRCNN"]


class _TwoStageBase(BaseLidarModel):
    def __init__(self, voxelizer, voxel_encoder, middle_encoder, backbone,
                 neck, rpn_head=None, roi_head=None, pretrained=None,
                 target_config=None, sampler_seed: int = 0,
                 dense_head=None, point_head=None, num_class=None,
                 post_process_cfg=None):
        # dense_head / num_class / post_process_cfg are the reference
        # configs' names for the same things
        super().__init__()
        self.voxelizer = voxelizer
        self.voxel_encoder = voxel_encoder
        self.middle_encoder = middle_encoder
        self.backbone = backbone
        self.neck = neck
        self.rpn_head = rpn_head if rpn_head is not None else dense_head
        assert self.rpn_head is not None, "rpn_head/dense_head required"
        self.roi_head = roi_head
        if point_head is not None:
            raise NotImplementedError(
                "the point head (Predicted Keypoint Weighting) arrives with "
                "ROADMAP.md, queue 1, item 8b")
        if not isinstance(voxel_encoder, VoxelMean):
            raise NotImplementedError(
                "the port's two-stage models run a VoxelMean encoder; got "
                "{} (HardVFE arrives with ROADMAP.md, queue 1, item 8b)"
                .format(type(voxel_encoder).__name__))
        self.post_process_cfg = post_process_cfg
        self.pretrained = pretrained
        # the proposal-target sampler: its config and the generator of its
        # uniform draws (on the CPU, moved to the batch's device)
        self.target_cfg = ProposalTargetConfig(**(target_config or {}))
        self.sampler_generator = torch.Generator().manual_seed(sampler_seed)

    def sampler_draws(self, b: int, p: int, device) -> torch.Tensor:
        """[B, 3, P] uniforms in [0, 1) for the fg, hard-bg and easy-bg
        priorities of proposal_targets, from the model's generator."""
        return torch.rand((b, 3, p), generator=self.sampler_generator).to(
            device)

    def _stage1(self, points, training: bool):
        """-> (rpn predictions, BEV [B, H, W, C] NHWC, sparse stages), with
        the entry point's voxel cap (train or test)."""
        feats, coords, _, vmask = voxel_mean_batch(
            points, self.voxelizer.voxel_size,
            self.voxelizer.point_cloud_range,
            self.voxelizer.max_num_points_in_voxel,
            self.voxelizer.max_num_voxels_for(training),
            self.voxel_encoder.in_channels)
        bev, stages = self.middle_encoder(feats, coords, vmask,
                                          return_stages=True)
        dense = self.neck(self.backbone(
            bev.permute(0, 3, 1, 2).contiguous()))
        return self.rpn_head(dense), bev, stages

    def _stage_supports(self, stages, picks):
        """Sparse stages -> [(xyz, feats, mask), ...] support sets."""
        out = []
        for i in picks:
            st, stride = stages[i]
            centers = stage_voxel_centers(
                st, stride, self.voxelizer.voxel_size,
                self.voxelizer.point_cloud_range)
            out.append((centers, st.features, st.mask))
        return out

    def _support_set(self, points, bev, stages):
        raise NotImplementedError

    def train_forward(self, batch) -> dict:
        """batch {"data": points [B, N, 4] (NaN padded), "gt_boxes" [B, G,
        7] (bottom-z), "gt_labels" [B, G] (classes from 0, -1 padded)} ->
        {"loss_rpn_cls", "loss_rpn_reg", "loss_rcnn_cls", "loss_rcnn_reg",
        "loss" (their sum)}. Train-mode BN: batch statistics, running stats
        updated."""
        points = batch["data"]
        gt_boxes, gt_labels = batch["gt_boxes"], batch["gt_labels"]
        preds, bev, stages = self._stage1(points, True)
        losses = self.rpn_head.loss(preds, gt_boxes, gt_labels)
        with torch.no_grad():
            rois, roi_scores, roi_labels = self.rpn_head.proposals(
                {k: v.detach() for k, v in preds.items()})
        targets = proposal_targets(
            self.sampler_draws(rois.shape[0], rois.shape[1], rois.device),
            rois, roi_labels >= 0, roi_labels, roi_scores, gt_boxes,
            gt_labels, self.target_cfg)
        supports = self._support_set(points, bev, stages)
        cls_pred, reg_pred = self.roi_head(targets["rois"], supports)
        losses["loss_rcnn_cls"], losses["loss_rcnn_reg"] = \
            RoIGridHead.refine_loss(cls_pred, reg_pred, targets)
        losses["loss"] = sum(losses.values())
        return losses

    @staticmethod
    def _refine(rois, roi_scores, roi_labels, cls_pred, reg_pred) -> dict:
        """Apply the residuals in the roi frame."""
        diag = 0.5 * torch.sqrt(rois[..., 3] ** 2 + rois[..., 4] ** 2)
        center = torch.cat([rois[..., :2],
                            (rois[..., 2] + rois[..., 5] / 2)[..., None]],
                           dim=-1)
        new_center = center + reg_pred[..., :3] * diag[..., None]
        new_dims = rois[..., 3:6] * torch.exp(reg_pred[..., 3:6])
        new_yaw = rois[..., 6] + reg_pred[..., 6]
        boxes = torch.cat([
            new_center[..., :2],
            (new_center[..., 2] - new_dims[..., 2] / 2)[..., None], new_dims,
            new_yaw[..., None]], dim=-1)
        conf = torch.sigmoid(cls_pred) * roi_scores
        valid = roi_labels >= 0
        return {"box3d_lidar": boxes,
                "scores": torch.where(valid, conf, -1.),
                "label_preds": torch.where(valid, roi_labels, -1)}

    @torch.no_grad()
    def test_forward(self, batch) -> dict:
        """batch {"data": points [B, N, 4] f32, NaN padded} -> box3d_lidar
        [B, P, 7] (bottom-z), scores [B, P], label_preds [B, P] (-1
        padded), P = the RPN's num_proposals. The model must be in eval
        mode (`.eval()`)."""
        raise_if_training(self)
        points = batch["data"]
        preds, bev, stages = self._stage1(points, False)
        rois, roi_scores, roi_labels = self.rpn_head.proposals(preds)
        supports = self._support_set(points, bev, stages)
        cls_pred, reg_pred = self.roi_head(rois, supports)
        return self._refine(rois, roi_scores, roi_labels, cls_pred, reg_pred)


@manager.MODELS.add_component
class VoxelRCNN(_TwoStageBase):
    """Stage-2 support = the voxel centres of the last sparse stages, one
    level per radius of the RoI head (multi-level voxel query)."""

    def __init__(self, voxelizer, voxel_encoder, middle_encoder, backbone,
                 neck, rpn_head=None, roi_head=None, point_encoder=None,
                 pretrained=None, target_config=None, sampler_seed: int = 0,
                 **ref_kwargs):
        # point_encoder accepted (and ignored) so Voxel-RCNN configs can
        # share a _base_ with PV-RCNN configs.
        super().__init__(voxelizer, voxel_encoder, middle_encoder, backbone,
                         neck, rpn_head, roi_head, pretrained=pretrained,
                         target_config=target_config,
                         sampler_seed=sampler_seed, **ref_kwargs)

    def _support_set(self, points, bev, stages):
        n_levels = len(self.roi_head.radii)
        picks = list(range(len(stages)))[-n_levels:]
        while len(picks) < n_levels:
            picks = [picks[0]] + picks
        return self._stage_supports(stages, picks)


@manager.MODELS.add_component
class PVRCNN(_TwoStageBase):
    """Stage-2 support = farthest-point keypoints aggregated by
    VoxelSetAbstraction."""

    def __init__(self, voxelizer, voxel_encoder, middle_encoder, backbone,
                 neck, rpn_head=None, roi_head=None, point_encoder=None,
                 pretrained=None, target_config=None, sampler_seed: int = 0,
                 **ref_kwargs):
        super().__init__(voxelizer, voxel_encoder, middle_encoder, backbone,
                         neck, rpn_head, roi_head, pretrained=pretrained,
                         target_config=target_config,
                         sampler_seed=sampler_seed, **ref_kwargs)
        assert point_encoder is not None
        self.point_encoder = point_encoder

    def _support_set(self, points, bev, stages):
        sparse_stages = None
        if getattr(self.point_encoder, "stage_channels", None):
            n = len(self.point_encoder.stage_channels)
            sparse_stages = self._stage_supports(
                stages, list(range(len(stages)))[-n:])
        return self.point_encoder(points, bev, sparse_stages=sparse_stages)
