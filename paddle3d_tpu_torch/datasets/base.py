"""Dataset base classes, a copy of paddle3d_tpu/datasets/base.py
(BaseDataset, MetricABC, collate_lidar).

The collate contract is the JAX package's: a batch is (device_batch,
metas), device_batch a dict of fixed-shape numpy arrays (points NaN-padded
to `max_points`, gt boxes zero-padded to `max_gt_boxes` with -1 labels)
that the caller hands to torch, metas the host-side list of per-sample
info (paths, calibs, ids).
"""
import abc
from typing import List

import numpy as np

from ..sample import Sample

__all__ = ["BaseDataset", "MetricABC", "collate_lidar"]


class MetricABC(abc.ABC):
    @abc.abstractmethod
    def update(self, predictions: List[Sample], ground_truths=None):
        ...

    @abc.abstractmethod
    def compute(self, verbose: bool = False) -> dict:
        ...


class BaseDataset(abc.ABC):
    """Map-style dataset yielding Sample records."""

    mode: str = "train"
    # fixed-shape capacities used by collate; datasets override
    max_points: int = 120000
    max_gt_boxes: int = 64
    point_dim: int = 4

    @property
    def is_train_mode(self) -> bool:
        return self.mode == "train"

    @property
    def is_test_mode(self) -> bool:
        return self.mode == "test"

    @abc.abstractmethod
    def __getitem__(self, index: int) -> Sample:
        ...

    @abc.abstractmethod
    def __len__(self) -> int:
        ...

    def get(self, index: int, rng=None) -> Sample:
        """The sample at index, its random transforms drawing from rng (a
        numpy RandomState; the DataLoader passes the generator of its seed,
        epoch and index). A dataset whose samples draw nothing ignores
        it."""
        return self[index]

    @property
    def metric(self) -> MetricABC:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return self.__class__.__name__

    @property
    def labels(self):
        """The class-name list."""
        return list(getattr(self, "class_names", []))

    def collate_fn(self, samples: List[Sample]):
        return collate_lidar(samples, self.max_points, self.max_gt_boxes,
                             self.point_dim)


def collate_lidar(samples: List[Sample], max_points: int, max_gt: int,
                  point_dim: int):
    """Pad a list of lidar Samples into one fixed-shape batch."""
    b = len(samples)
    points = np.full((b, max_points, point_dim), np.nan, np.float32)
    gt_boxes = np.zeros((b, max_gt, 7), np.float32)
    gt_labels = np.full((b, max_gt), -1, np.int32)
    metas = []
    for i, s in enumerate(samples):
        pts = np.asarray(s.data, np.float32)
        n = min(len(pts), max_points)
        points[i, :n, :pts.shape[1]] = pts[:n, :point_dim]
        if s.bboxes_3d is not None and len(s.bboxes_3d):
            g = min(len(s.bboxes_3d), max_gt)
            gt_boxes[i, :g] = np.asarray(s.bboxes_3d)[:g, :7]
            gt_labels[i, :g] = np.asarray(s.labels)[:g]
        meta = {"path": s.path, "id": s.meta.get("id")}
        if s.calibs is not None:
            meta["calibs"] = s.calibs
        metas.append(meta)
    batch = {"data": points, "gt_boxes": gt_boxes, "gt_labels": gt_labels}
    return batch, metas
