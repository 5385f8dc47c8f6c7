"""nuScenes multi-modality dataset, a copy of
paddle3d_tpu/datasets/nuscenes/nuscenes_multi_modality.py (reference:
paddle3d/datasets/nuscenes/nuscenes_multi_modality.py:31 NuscenesMMDataset).

One sample carries both modalities, so that BEVFusion's LiDAR and camera
streams train together: the key-frame scan with its sweep references for
LoadPointCloud, and the six camera views with lidar2img / img2lidar and the
BEVDet camera matrices (rots / trans / cam2imgs / post_rots, what the LSS
view transformer takes). The collate merges the LiDAR and multi-view
contracts. Its transforms run on the joint sample, after the images.
"""
import os
from typing import List

import numpy as np

from ...apis import manager
from ...geometries import BBoxes3D, CoordMode
from ...sample import Sample
from ...utils.transform3d import invert_transform
from ..base import collate_lidar
from .nuscenes_multiview_det import NuscenesMVDataset

__all__ = ["NuscenesMMDataset"]


@manager.DATASETS.add_component
class NuscenesMMDataset(NuscenesMVDataset):
    max_points = 300000
    max_gt_boxes = 128
    point_dim = 5  # x, y, z, intensity, time_lag

    def __init__(self, dataset_root: str, version: str = "v1.0-mini",
                 mode: str = "train", class_names: List[str] = None,
                 transforms=None, image_size=(256, 704),
                 cameras: List[str] = None, max_sweeps: int = 10,
                 max_points: int = None, with_depth_dist: bool = False,
                 depth_stride: int = 8,
                 cam_depth_range=(4.0, 45.0, 1.0), constant_std=None):
        """`with_depth_dist` adds per-camera Gaussian depth targets
        `img_depth` [N, H/s, W/s, 1 + D] (channel 0 a patch's least depth,
        then the bins' distribution) for BEVFusion's camera depth loss
        (reference: transforms/reader.py:511 project_pts_to_img_depth,
        bevfusion/utils.py:40 generate_guassian_depth_target)."""
        super().__init__(dataset_root, version, mode, class_names,
                         transforms=transforms, image_size=image_size,
                         cameras=cameras, bevdet_format=True)
        self.max_sweeps = max_sweeps
        if max_points is not None:
            self.max_points = max_points
        self.with_depth_dist = with_depth_dist
        self.depth_stride = int(depth_stride)
        self.cam_depth_range = list(map(float, cam_depth_range))
        self.constant_std = constant_std

    def _gaussian_depth_targets(self, lidar_sd, lidar2imgs) -> np.ndarray:
        """-> [N, H/s, W/s, 1 + D]: a patch's least depth, then the Gaussian
        bins."""
        from scipy.special import erf

        s = self.depth_stride
        lo, hi, step = self.cam_depth_range
        full = self._depth_maps(lidar_sd, lidar2imgs)  # [N, H, W] (0: none)
        n, hh, ww = full.shape
        patches = full.reshape(n, hh // s, s, ww // s, s).transpose(
            0, 1, 3, 2, 4).reshape(n, hh // s, ww // s, s * s)
        valid = patches > 0
        vnum = np.maximum(valid.sum(-1), 1)
        big = np.where(valid, patches, np.inf)
        min_depth = np.min(big, axis=-1)
        min_depth = np.where(np.isfinite(min_depth), min_depth, 0.)
        if self.constant_std is None:
            mean = np.where(valid, patches, 0.).sum(-1) / vnum
            var = (np.where(valid, (patches - mean[..., None]) ** 2,
                            0.)).sum(-1) / vnum
            std = np.sqrt(var)
            std = np.where(valid.sum(-1) <= 1, 1.0, std)
        else:
            std = np.full(min_depth.shape, float(self.constant_std))
        # CDF differences of Normal(min / step, std / step) at the bin edges
        edges = np.arange(lo, hi + 1, step, np.float32)  # D + 1 edges
        mu = (min_depth / step)[..., None]
        sg = np.maximum(std / step, 1e-3)[..., None]
        cdf = 0.5 * (1 + erf((edges / step - mu) / (sg * np.sqrt(2.0))))
        dist = (cdf[..., 1:] - cdf[..., :-1]).astype(np.float32)
        return np.concatenate([min_depth[..., None].astype(np.float32),
                               dist], axis=-1)

    def _sample(self, index: int) -> Sample:
        token = self.sample_tokens[index]
        rec = self.sample[token]
        lidar_sd = self.lidar_sd(token)
        lidar_from_global = invert_transform(self._sd_transforms(lidar_sd))

        sample = Sample(
            path=os.path.join(self.dataset_root, lidar_sd["filename"]),
            modality="multimodal")
        sample.meta.id = token

        # the camera views and matrices (multi-view and BEVDet contracts)
        (imgs, lidar2imgs, img2lidars, rots, trans, cam2imgs,
         post_rots, lidar2cams) = self._load_views(rec, lidar_from_global)
        sample.img = imgs
        sample.meta.lidar2imgs = lidar2imgs
        sample.meta.img2lidars = img2lidars
        sample.meta.lidar2cams = lidar2cams
        sample.meta.rots = rots
        sample.meta.trans = trans
        sample.meta.cam2imgs = cam2imgs
        sample.meta.post_rots = post_rots

        # the sweep references for LoadPointCloud (NuscenesPCDataset's)
        ref_from_global = lidar_from_global
        t_ref = lidar_sd["timestamp"] / 1e6
        sweeps = []
        prev = lidar_sd["prev"]
        while prev and len(sweeps) < self.max_sweeps:
            swd = self.sample_data[prev]
            sweep = Sample(
                path=os.path.join(self.dataset_root, swd["filename"]),
                modality="lidar")
            sweep.meta.ref_from_curr = (
                ref_from_global @ self._sd_transforms(swd))[:3, :]
            sweep.meta.time_lag = t_ref - swd["timestamp"] / 1e6
            sweeps.append(sweep)
            prev = swd["prev"]
        sample.sweeps = sweeps

        if not self.is_test_mode:
            boxes, labels, names, num_pts, attrs = self.annotations(token)
            sample.bboxes_3d = BBoxes3D(
                boxes[:, :7], coordmode=CoordMode.NuScenesLidar,
                origin=[.5, .5, 0.], rot_axis=2, velocities=boxes[:, 7:9])
            sample.labels = labels
            sample.attrs = attrs

        if self.with_depth_dist:
            sample.meta.img_depth = self._gaussian_depth_targets(
                lidar_sd, lidar2imgs)
        return sample

    def collate_fn(self, samples: List[Sample]):
        batch, metas = collate_lidar(samples, self.max_points,
                                     self.max_gt_boxes, self.point_dim)
        b = len(samples)
        n_cam = len(self.cameras)
        # velocities ride along as extra gt columns (9-value boxes)
        vel = np.zeros((b, self.max_gt_boxes, 2), np.float32)
        for i, s in enumerate(samples):
            if s.bboxes_3d is not None and \
                    getattr(s.bboxes_3d, "velocities", None) is not None:
                g = min(len(s.bboxes_3d), self.max_gt_boxes)
                vel[i, :g] = np.asarray(s.bboxes_3d.velocities)[:g]
        batch["gt_boxes"] = np.concatenate([batch["gt_boxes"], vel], axis=-1)
        batch.update({
            "img": np.stack([s.img for s in samples]) / 255.0,
            "lidar2imgs": np.stack([s.meta.lidar2imgs for s in samples]),
            "img2lidars": np.stack([s.meta.img2lidars for s in samples]),
            "rots": np.stack([s.meta.rots for s in samples]),
            "trans": np.stack([s.meta.trans for s in samples]),
            "cam2imgs": np.stack([s.meta.cam2imgs for s in samples]),
            "post_rots": np.stack([s.meta.post_rots for s in samples]),
            "post_trans": np.zeros((b, n_cam, 3), np.float32),
            "bda": np.broadcast_to(np.eye(3, dtype=np.float32),
                                   (b, 3, 3)).copy(),
        })
        if self.with_depth_dist:
            batch["img_depth"] = np.stack(
                [s.meta.img_depth for s in samples])
        return batch, metas
