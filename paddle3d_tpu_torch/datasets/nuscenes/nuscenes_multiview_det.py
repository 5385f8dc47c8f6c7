"""nuScenes multi-view datasets, a copy of
paddle3d_tpu/datasets/nuscenes/nuscenes_multiview_det.py (reference:
paddle3d/datasets/nuscenes/nuscenes_multiview_det.py:51 NuscenesMVDataset,
:798 NuscenesMVSegDataset; nuscenes_metric.py:179 NuScenesSegMetric).

Each sample holds the six camera images, read by the port's own decoders
(utils/image.read_image: JPEG or PNG by signature, in place of Pillow),
resized to image_size with Pillow's default BICUBIC (utils/image.resize,
byte-equal), per-camera lidar2img / img2lidar / lidar2cam matrices, the
can-bus signal and lidar-frame gt. Options: `bevdet_format` (the BEVDet
camera matrices), `adjacent` (earlier key frames' images with
cam -> current-lidar matrices), `with_depth` (the key-frame scan
projected into per-camera depth maps). Fixed-shape collate: images
[B, N_cam, H, W, 3] / 255, matrices [B, N_cam, 4, 4].

As NuscenesPCDataset, `ds[i]` is `ds.get(i)`: its random transforms draw
from `transforms.sample_rng(0, 0, i)`, and the DataLoader hands each sample
the generator of its seed, epoch and index. NuscenesMVSegDataset attaches
the map path before the transforms run without unsetting the dataset's
transforms a call (the JAX one swaps them out, which loader threads would
race on).
"""
import os
from typing import List

import numpy as np

from ...apis import manager
from ...sample import Sample
from ...transforms.base import sample_rng
from ...utils.image import BICUBIC, read_image, resize
from ...utils.transform3d import invert_transform, quat_yaw
from .nuscenes_det import NuscenesDetDataset
from .nuscenes_metric import NuScenesMetric

__all__ = ["NuscenesMVDataset", "NuscenesMVSegDataset", "NuScenesSegMetric",
           "CAMERA_CHANNELS"]

CAMERA_CHANNELS = [
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT", "CAM_BACK",
    "CAM_BACK_LEFT", "CAM_BACK_RIGHT"
]


def load_view(path: str, size) -> tuple:
    """A camera image at path, resized to size = (h, w) with BICUBIC:
    -> (float32 [h, w, 3], (w0, h0) before the resize)."""
    img = read_image(path)
    h0, w0 = img.shape[:2]
    h, w = size
    return resize(img, (w, h), BICUBIC).astype(np.float32), (w0, h0)


@manager.DATASETS.add_component
class NuscenesMVDataset(NuscenesDetDataset):
    max_gt_boxes = 128

    def __init__(self, dataset_root: str, version: str = "v1.0-mini",
                 mode: str = "train", class_names: List[str] = None,
                 transforms=None, image_size=(320, 800),
                 cameras: List[str] = None, bevdet_format: bool = False,
                 adjacent=False, with_depth: bool = False):
        """`bevdet_format` adds the BEVDet camera-matrix contract
        (rots / trans / cam2imgs / post_rots / post_trans / bda; reference
        transforms/bevdet_reader.py:116 PrepareImageInputs); `adjacent`
        (bool or a frame count, reference multi_adj_frame_id_cfg) adds the
        earlier key frames' images with cam -> CURRENT-lidar matrices (ego
        motion composed in); `with_depth` projects the key-frame scan into
        per-camera sparse depth maps `gt_depth` [N, H, W] (reference
        transforms/bevdet_reader.py:12 PointToMultiViewDepth)."""
        super().__init__(dataset_root, version, mode, class_names,
                         transforms, max_sweeps=0)
        self.image_size = tuple(image_size)  # (H, W)
        self.cameras = cameras or CAMERA_CHANNELS
        self.bevdet_format = bevdet_format
        self.num_adj = int(adjacent)
        self.adjacent = self.num_adj > 0
        self.with_depth = with_depth

    def _load_views(self, rec, lidar_from_global):
        """One frame's camera views and matrices. `lidar_from_global` fixes
        the TARGET lidar frame: the key frame's with an ADJACENT frame's
        record gives cam -> key-lidar matrices, ego motion composed in."""
        imgs, lidar2imgs, img2lidars, lidar2cams = [], [], [], []
        rots, trans, cam2imgs, post_rots = [], [], [], []
        h_out, w_out = self.image_size
        for cam in self.cameras:
            sd = self.sample_data[rec["data"][cam]]
            cs = self.calibrated_sensor[sd["calibrated_sensor_token"]]
            img, (w0, h0) = load_view(
                os.path.join(self.dataset_root, sd["filename"]),
                self.image_size)
            imgs.append(img)
            cam_from_lidar = (
                invert_transform(self._sd_transforms(sd)) @
                invert_transform(lidar_from_global))
            k = np.eye(4, dtype=np.float64)
            intr = np.asarray(cs["camera_intrinsic"], np.float64)
            # intrinsics for [0, 1] image coordinates
            sx, sy = 1.0 / w0, 1.0 / h0
            k[0, :3] = intr[0] * sx
            k[1, :3] = intr[1] * sy
            k[2, 2] = 1.0
            lidar2img = k @ cam_from_lidar
            lidar2imgs.append(lidar2img.astype(np.float32))
            lidar2cams.append(cam_from_lidar.astype(np.float32))
            img2lidars.append(np.linalg.inv(lidar2img).astype(np.float32))
            # BEVDet contract: pixel intrinsics, cam -> lidar rot / trans,
            # the resize folded into post_rot
            lidar_from_cam = np.linalg.inv(cam_from_lidar)
            rots.append(lidar_from_cam[:3, :3].astype(np.float32))
            trans.append(lidar_from_cam[:3, 3].astype(np.float32))
            cam2imgs.append(intr.astype(np.float32))
            post_rots.append(np.diag([w_out / w0, h_out / h0,
                                      1.0]).astype(np.float32))
        return (np.stack(imgs), np.stack(lidar2imgs), np.stack(img2lidars),
                np.stack(rots), np.stack(trans), np.stack(cam2imgs),
                np.stack(post_rots), np.stack(lidar2cams))

    def _depth_maps(self, lidar_sd: dict, lidar2imgs) -> np.ndarray:
        """Key-frame LiDAR points -> per-camera sparse depth maps [N, H, W]
        (the least depth a pixel, 0 = no return)."""
        h, w = self.image_size
        pts = np.fromfile(
            os.path.join(self.dataset_root, lidar_sd["filename"]),
            np.float32).reshape(-1, 5)[:, :3]
        hom = np.concatenate(
            [pts, np.ones((len(pts), 1), np.float32)], axis=1)
        out = np.zeros((len(lidar2imgs), h, w), np.float32)
        for i, l2i in enumerate(lidar2imgs):
            proj = hom @ l2i.T  # [0, 1] image coordinates times depth
            d = proj[:, 2]
            keep = d > 1.0
            u = (proj[:, 0] / np.maximum(d, 1e-6) * w).astype(np.int64)
            v = (proj[:, 1] / np.maximum(d, 1e-6) * h).astype(np.int64)
            keep &= (u >= 0) & (u < w) & (v >= 0) & (v < h)
            u, v, d = u[keep], v[keep], d[keep]
            # the least depth a pixel: descending, so the smallest is last
            order = np.argsort(-d)
            out[i, v[order], u[order]] = d[order]
        return out

    def _can_bus(self, token: str) -> np.ndarray:
        """The 18-value can-bus signal: [0:3] the ego translation since the
        previous key frame (global frame), [3:7] the ego rotation, [-2] the
        ego yaw, [-1] the yaw change since the previous key frame."""
        sd = self.lidar_sd(token)
        ep = self.ego_pose[sd["ego_pose_token"]]
        pos = np.asarray(ep["translation"], np.float64)
        quat = np.asarray(ep["rotation"], np.float64)
        yaw = quat_yaw(quat)
        rec = self.sample[token]
        can = np.zeros(18, np.float32)
        can[3:7] = quat
        can[-2] = yaw
        if rec.get("prev"):
            psd = self.lidar_sd(rec["prev"])
            pep = self.ego_pose[psd["ego_pose_token"]]
            can[0:3] = pos - np.asarray(pep["translation"], np.float64)
            dyaw = yaw - quat_yaw(np.asarray(pep["rotation"], np.float64))
            can[-1] = np.arctan2(np.sin(dyaw), np.cos(dyaw))
        return can

    def __getitem__(self, index: int) -> Sample:
        return self.get(index)

    def get(self, index: int, rng: np.random.RandomState = None) -> Sample:
        sample = self._sample(index)
        sample.rng = sample_rng(0, 0, index) if rng is None else rng
        if self.transforms is not None:
            sample = self.transforms(sample)
        return sample

    def _sample(self, index: int) -> Sample:
        """The sample at index before its transforms."""
        token = self.sample_tokens[index]
        rec = self.sample[token]
        lidar_sd = self.lidar_sd(token)
        lidar_from_global = invert_transform(self._sd_transforms(lidar_sd))

        (imgs, lidar2imgs, img2lidars, rots, trans, cam2imgs,
         post_rots, lidar2cams) = self._load_views(rec, lidar_from_global)

        sample = Sample(path=lidar_sd["filename"], modality="multiview")
        sample.meta.id = token
        sample.img = imgs
        sample.meta.lidar2imgs = lidar2imgs
        sample.meta.img2lidars = img2lidars
        sample.meta.lidar2cams = lidar2cams
        sample.meta.can_bus = self._can_bus(token)
        if self.bevdet_format:
            sample.meta.rots = rots
            sample.meta.trans = trans
            sample.meta.cam2imgs = cam2imgs
            sample.meta.post_rots = post_rots
        if self.adjacent:
            imgs_f, rots_f, trans_f = [], [], []
            cur = rec
            for _ in range(self.num_adj):
                prev_tok = cur.get("prev")
                cur = self.sample[prev_tok] if prev_tok else cur
                (img_adj, _, _, rots_adj, trans_adj, _, _,
                 _) = self._load_views(cur, lidar_from_global)
                imgs_f.append(img_adj)
                rots_f.append(rots_adj)
                trans_f.append(trans_adj)
            if self.num_adj == 1:  # one frame: no frame axis
                sample.img_adj = imgs_f[0]
                sample.meta.rots_adj = rots_f[0]
                sample.meta.trans_adj = trans_f[0]
            else:
                sample.img_adj = np.stack(imgs_f)
                sample.meta.rots_adj = np.stack(rots_f)
                sample.meta.trans_adj = np.stack(trans_f)
        if self.with_depth:
            sample.meta.gt_depth = self._depth_maps(lidar_sd, lidar2imgs)

        if not self.is_test_mode:
            boxes, labels, names, num_pts, attrs = self.annotations(token)
            sample.bboxes_3d = boxes  # [G, 9] with velocities
            sample.labels = labels
        return sample

    def collate_fn(self, samples: List[Sample]):
        b = len(samples)
        g = self.max_gt_boxes
        gt_boxes = np.zeros((b, g, 9), np.float32)
        gt_labels = np.full((b, g), -1, np.int32)
        for i, s in enumerate(samples):
            if s.bboxes_3d is not None and len(s.bboxes_3d):
                n = min(len(s.bboxes_3d), g)
                gt_boxes[i, :n] = np.asarray(s.bboxes_3d)[:n]
                gt_labels[i, :n] = np.asarray(s.labels)[:n]
        batch = {
            "img": np.stack([s.img for s in samples]) / 255.0,
            "lidar2imgs": np.stack([s.meta.lidar2imgs for s in samples]),
            "img2lidars": np.stack([s.meta.img2lidars for s in samples]),
            "lidar2cams": np.stack([s.meta.lidar2cams for s in samples]),
            "can_bus": np.stack([s.meta.can_bus for s in samples]),
            "gt_boxes": gt_boxes,
            "gt_labels": gt_labels,
        }
        if self.bevdet_format:
            batch["rots"] = np.stack([s.meta.rots for s in samples])
            batch["trans"] = np.stack([s.meta.trans for s in samples])
            batch["cam2imgs"] = np.stack(
                [s.meta.cam2imgs for s in samples])
            batch["post_rots"] = np.stack(
                [s.meta.post_rots for s in samples])
            batch["post_trans"] = np.zeros(
                (b, len(self.cameras), 3), np.float32)
            batch["bda"] = np.broadcast_to(
                np.eye(3, dtype=np.float32), (b, 3, 3)).copy()
        if self.adjacent:
            batch["img_adj"] = np.stack(
                [s.img_adj for s in samples]) / 255.0
            batch["rots_adj"] = np.stack(
                [s.meta.rots_adj for s in samples])
            batch["trans_adj"] = np.stack(
                [s.meta.trans_adj for s in samples])
        if self.with_depth:
            batch["gt_depth"] = np.stack(
                [s.meta.gt_depth for s in samples])
        metas = [{"path": s.path, "id": s.meta.get("id")} for s in samples]
        return batch, metas

    @property
    def metric(self) -> NuScenesMetric:
        return NuScenesMetric(self)


@manager.DATASETS.add_component
class NuscenesMVSegDataset(NuscenesMVDataset):
    """Multi-view detection with BEV segmentation gt: each key frame's BEV
    map masks (drivable / lane / vehicle) in `maps_root/<token>.npz`, which
    LoadMapsFromFiles reads from meta.map_filename; the collate adds
    gt_semantic_map [B, H, W, C]."""

    def __init__(self, dataset_root: str, version: str = "v1.0-mini",
                 mode: str = "train", class_names: List[str] = None,
                 transforms=None, image_size=(320, 800),
                 cameras: List[str] = None, maps_root: str = None,
                 map_classes: int = 3):
        super().__init__(dataset_root, version=version, mode=mode,
                         class_names=class_names, transforms=transforms,
                         image_size=image_size, cameras=cameras)
        self.maps_root = maps_root or os.path.join(dataset_root, "maps_bev")
        self.map_classes = int(map_classes)

    def _sample(self, index: int) -> Sample:
        sample = super()._sample(index)
        sample.meta.map_filename = os.path.join(
            self.maps_root, "{}.npz".format(self.sample_tokens[index]))
        return sample

    def collate_fn(self, samples: List[Sample]):
        batch, metas = super().collate_fn(samples)
        if samples[0].get("gt_semantic_map") is not None:
            batch["gt_semantic_map"] = np.stack(
                [s.gt_semantic_map for s in samples])
        return batch, metas

    @property
    def metric(self) -> "NuScenesSegMetric":
        return NuScenesSegMetric(self)


class NuScenesSegMetric(NuScenesMetric):
    """The detection metric and a BEV IoU a class: predictions carry
    pred_semantic_map probabilities, compared at 0.5 to the gt npz masks."""

    SEG_CLASSES = ("drive", "lane", "vehicle")

    def __init__(self, dataset, class_names=None):
        super().__init__(dataset, class_names)
        self._inter = np.zeros(dataset.map_classes, np.float64)
        self._union = np.zeros(dataset.map_classes, np.float64)

    def update(self, predictions, ground_truths=None):
        super().update(predictions, ground_truths)
        for pred in predictions:
            probs = pred.get("pred_semantic_map")
            if probs is None:
                continue
            token = pred.meta.get("id")
            with np.load(os.path.join(self.dataset.maps_root,
                                      "{}.npz".format(token))) as f:
                gt = f["arr_0"] > 0.5
            hit = np.asarray(probs) > 0.5
            for c in range(gt.shape[-1]):
                self._inter[c] += np.sum(hit[..., c] & gt[..., c])
                self._union[c] += np.sum(hit[..., c] | gt[..., c])

    def compute(self, verbose: bool = False) -> dict:
        out = super().compute(verbose)
        for c in range(len(self._inter)):
            name = (self.SEG_CLASSES[c]
                    if c < len(self.SEG_CLASSES) else str(c))
            out["IoU_{}".format(name)] = float(
                self._inter[c] / max(self._union[c], 1.0))
        return out
