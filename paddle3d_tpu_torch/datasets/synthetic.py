"""Synthetic datasets without images, a copy of the LiDAR, range-image and
classification parts of paddle3d_tpu/datasets/synthetic.py:
SyntheticDataset / SyntheticMetric (the LiDAR tiny configs),
SyntheticRangeDataset / SyntheticRangeMetric (SqueezeSegV3's) and
SyntheticClsDataset / SyntheticClsMetric (PAConv's). Each scene is drawn
from `default_rng(seed * k + index)` with the JAX module's k, so the
scenes are the JAX ones array for array. The camera sets (MV, Mono, Depth)
wait for ROADMAP.md, queue 1, item 5.

Procedurally generated scenes, so that tests and smoke runs need no data
on disk: random boxes with points sampled on them plus ground clutter,
scored by a center-distance recall / precision, so that the whole train ->
eval -> metric loop runs hermetically.
"""
from typing import List

import numpy as np

from ..apis import manager
from ..geometries import BBoxes3D, CoordMode
from ..sample import Sample
from ..transforms.base import sample_rng
from .base import BaseDataset, MetricABC

__all__ = ["SyntheticDataset", "SyntheticMetric", "SyntheticRangeDataset",
           "SyntheticRangeMetric", "SyntheticClsDataset",
           "SyntheticClsMetric"]


@manager.DATASETS.add_component
class SyntheticDataset(BaseDataset):
    def __init__(self,
                 num_samples: int = 64,
                 num_points: int = 2048,
                 max_boxes: int = 6,
                 point_cloud_range=(0., -20., -2., 40., 20., 2.),
                 class_sizes=((1.6, 3.9, 1.56),),
                 mode: str = "train",
                 seed: int = 0,
                 point_dim: int = 4,
                 with_velocity: bool = False):
        self.num_samples = num_samples
        self.num_points = num_points
        self.max_boxes = max_boxes
        self.pc_range = np.asarray(point_cloud_range, np.float32)
        self.class_sizes = np.asarray(class_sizes, np.float32)
        self.mode = mode
        self.seed = seed
        self.max_points = num_points
        self.max_gt_boxes = max_boxes
        # nuScenes-style scenes: 5-dim points (x,y,z,intensity,dt) and
        # 9-dim boxes (+vx,vy); box z at mid-height like the nuScenes GT
        self.point_dim = int(point_dim)
        self.with_velocity = bool(with_velocity)

    def __len__(self):
        return self.num_samples

    def _gen(self, index: int):
        rng = np.random.default_rng(self.seed * 100003 + index)
        n_boxes = int(rng.integers(1, self.max_boxes + 1))
        cls = rng.integers(0, len(self.class_sizes), n_boxes)
        sizes = self.class_sizes[cls]
        lo, hi = self.pc_range[:3], self.pc_range[3:]
        centers = rng.uniform(lo[:2] + 4, hi[:2] - 4, (n_boxes, 2))
        z = np.full((n_boxes, 1), float(lo[2]) + 0.2)
        yaw = rng.uniform(-np.pi, np.pi, (n_boxes, 1))
        cols = [centers, z, sizes, yaw]
        if self.with_velocity:
            cols.append(np.zeros((n_boxes, 2), np.float32))  # static scene
        boxes = np.concatenate(cols, axis=1).astype(np.float32)

        pts = []
        per_box = self.num_points // (2 * max(n_boxes, 1))
        for b in boxes:
            local = rng.uniform([-.5, -.5, 0.], [.5, .5, 1.],
                                (per_box, 3)) * [b[3], b[4], b[5]]
            c, s = np.cos(b[6]), np.sin(b[6])
            xy = local[:, :2] @ np.array([[c, s], [-s, c]], np.float32)
            p = np.concatenate(
                [xy + b[:2], local[:, 2:3] + b[2],
                 rng.uniform(0, 1, (per_box, 1))], axis=1)
            pts.append(p)
        n_bg = self.num_points - per_box * n_boxes
        bg = np.concatenate([
            rng.uniform(lo, hi, (n_bg, 3)),
            rng.uniform(0, 1, (n_bg, 1))
        ], axis=1)
        pts.append(bg)
        points = np.concatenate(pts).astype(np.float32)
        if self.point_dim > 4:
            extra = rng.uniform(
                0, 0.45, (len(points), self.point_dim - 4)).astype(
                np.float32)
            points = np.concatenate([points, extra], axis=1)
        return points, boxes, cls.astype(np.int32)

    def __getitem__(self, index: int) -> Sample:
        points, boxes, labels = self._gen(index)
        sample = Sample(path="synthetic://{}".format(index), modality="lidar")
        sample.data = points
        sample.bboxes_3d = BBoxes3D(
            boxes, coordmode=CoordMode.KittiLidar, origin=[.5, .5, 0.])
        sample.labels = labels
        sample.meta.id = index
        return sample

    @property
    def metric(self) -> "SyntheticMetric":
        return SyntheticMetric(self)


class SyntheticMetric(MetricABC):
    """Center-distance recall/precision at 2m — enough signal for smoke
    training runs without a full AP implementation."""

    def __init__(self, dataset: SyntheticDataset, dist_thresh: float = 2.0):
        self.dataset = dataset
        self.dist_thresh = dist_thresh
        self._tp = 0
        self._n_gt = 0
        self._n_pred = 0

    def update(self, predictions: List[Sample], ground_truths=None):
        for pred in predictions:
            idx = pred.meta.get("id")
            _, gt_boxes, _ = self.dataset._gen(idx)
            self._n_gt += len(gt_boxes)
            if pred.bboxes_3d is None or len(pred.bboxes_3d) == 0:
                continue
            pb = np.asarray(pred.bboxes_3d)
            self._n_pred += len(pb)
            if len(gt_boxes) == 0:
                continue
            d = np.linalg.norm(
                pb[:, None, :2] - gt_boxes[None, :, :2], axis=-1)
            matched = np.zeros(len(gt_boxes), bool)
            for row in np.argsort(d.min(axis=1)):
                j = int(np.argmin(np.where(matched, np.inf, d[row])))
                if not matched[j] and d[row, j] < self.dist_thresh:
                    matched[j] = True
            self._tp += int(matched.sum())

    def compute(self, verbose: bool = False) -> dict:
        recall = self._tp / max(self._n_gt, 1)
        precision = self._tp / max(self._n_pred, 1)
        return {"recall@2m": recall, "precision@2m": precision}


@manager.DATASETS.add_component
class SyntheticRangeDataset(BaseDataset):
    """Synthetic range-image segmentation dataset (SqueezeSegV3 contract:
    data [H, W, 5], proj_labels [H, W], proj_mask [H, W]) for hermetic
    TIPC/CI chains without SemanticKITTI on disk. Labels are geometric
    (range bands + an object disk) so a tiny model can overfit."""

    def __init__(self, num_samples: int = 16, image_hw=(16, 64),
                 num_classes: int = 4, mode: str = "train", seed: int = 0,
                 transforms=None):
        if isinstance(transforms, list):
            from ..transforms import Compose
            transforms = Compose(transforms)
        self.transforms = transforms
        self.num_samples = num_samples
        self.image_hw = tuple(image_hw)
        self.num_classes = num_classes
        self.mode = mode
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def _gen(self, index: int):
        rng = np.random.default_rng(self.seed * 9091 + index)
        h, w = self.image_hw
        rr = rng.uniform(2, 50, (h, w)).astype(np.float32)
        xyz = rng.normal(0, 10, (h, w, 3)).astype(np.float32)
        remission = rng.uniform(0, 1, (h, w, 1)).astype(np.float32)
        img = np.concatenate([rr[..., None], xyz, remission], axis=-1)
        labels = np.clip((rr / 50 * (self.num_classes - 1)).astype(np.int32)
                         + 1, 1, self.num_classes - 1)
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        yy, xx = np.mgrid[0:h, 0:w]
        labels[(yy - cy) ** 2 + (xx - cx) ** 2 < (h // 4) ** 2] = 0
        mask = np.ones((h, w), bool)
        return img, labels, mask

    def __getitem__(self, index: int) -> Sample:
        return self.get(index)

    def get(self, index: int, rng: np.random.RandomState = None) -> Sample:
        img, labels, mask = self._gen(index)
        sample = Sample(path="synthetic-range://{}".format(index),
                        modality="lidar")
        sample.data = img
        sample.labels = labels
        sample.meta.id = index
        sample.meta.proj_mask = mask
        sample.rng = sample_rng(self.seed, 0, index) if rng is None else rng
        if self.transforms is not None:
            sample = self.transforms(sample)
        return sample

    def collate_fn(self, samples: List[Sample]):
        batch = {
            "data": np.stack([np.asarray(s.data, np.float32)
                              for s in samples]),
            "proj_labels": np.stack(
                [np.asarray(s.labels, np.int32) for s in samples]),
            "proj_mask": np.stack(
                [np.asarray(s.meta.proj_mask) for s in samples]),
        }
        metas = [{"path": s.path, "id": s.meta.get("id")} for s in samples]
        return batch, metas

    @property
    def metric(self) -> "SyntheticRangeMetric":
        return SyntheticRangeMetric(self)


class SyntheticRangeMetric(MetricABC):
    def __init__(self, dataset):
        self.dataset = dataset
        n = dataset.num_classes
        self.conf = np.zeros((n, n), np.int64)

    def update(self, predictions: List[Sample], ground_truths=None):
        for pred in predictions:
            _, gt, mask = self.dataset._gen(pred.meta.get("id"))
            p = np.asarray(pred.labels).reshape(gt.shape)
            np.add.at(self.conf, (gt[mask], p[mask]), 1)

    def compute(self, verbose: bool = False) -> dict:
        tp = np.diag(self.conf).astype(np.float64)
        denom = np.maximum(
            self.conf.sum(0) + self.conf.sum(1) - tp, 1)
        return {"mIoU": float((tp / denom).mean()),
                "acc": float(tp.sum() / max(self.conf.sum(), 1))}


@manager.DATASETS.add_component
class SyntheticClsDataset(BaseDataset):
    """Synthetic point-cloud classification dataset (PAConv contract:
    data [N, 3], labels scalar) — class = which octant the cluster
    occupies, learnable by a tiny model."""

    def __init__(self, num_samples: int = 16, num_points: int = 256,
                 num_classes: int = 4, mode: str = "train", seed: int = 0,
                 transforms=None):
        if isinstance(transforms, list):
            from ..transforms import Compose
            transforms = Compose(transforms)
        self.transforms = transforms
        self.num_samples = num_samples
        self.num_points = num_points
        self.num_classes = num_classes
        self.mode = mode
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def _gen(self, index: int):
        rng = np.random.default_rng(self.seed * 31337 + index)
        label = int(rng.integers(0, self.num_classes))
        center = np.array([(label % 2) * 2 - 1,
                           ((label // 2) % 2) * 2 - 1, 0.0], np.float32)
        pts = center + rng.normal(0, 0.3,
                                  (self.num_points, 3)).astype(np.float32)
        return pts.astype(np.float32), label

    def __getitem__(self, index: int) -> Sample:
        return self.get(index)

    def get(self, index: int, rng: np.random.RandomState = None) -> Sample:
        pts, label = self._gen(index)
        sample = Sample(path="synthetic-cls://{}".format(index),
                        modality="lidar")
        sample.data = pts
        sample.labels = np.int64(label)
        sample.meta.id = index
        sample.rng = sample_rng(self.seed, 0, index) if rng is None else rng
        if self.transforms is not None:
            sample = self.transforms(sample)
        return sample

    def collate_fn(self, samples: List[Sample]):
        batch = {
            "data": np.stack([np.asarray(s.data, np.float32)
                              for s in samples]),
            "labels": np.asarray([int(s.labels) for s in samples],
                                 np.int64),
        }
        metas = [{"path": s.path, "id": s.meta.get("id")} for s in samples]
        return batch, metas

    @property
    def metric(self) -> "SyntheticClsMetric":
        return SyntheticClsMetric(self)


class SyntheticClsMetric(MetricABC):
    def __init__(self, dataset):
        self.dataset = dataset
        self.correct = 0
        self.total = 0

    def update(self, predictions: List[Sample], ground_truths=None):
        for pred in predictions:
            _, gt = self.dataset._gen(pred.meta.get("id"))
            self.correct += int(int(np.asarray(pred.labels)) == gt)
            self.total += 1

    def compute(self, verbose: bool = False) -> dict:
        return {"acc": self.correct / max(self.total, 1)}
