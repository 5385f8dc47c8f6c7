"""ModelNet40 classification dataset and accuracy metric, a copy of
paddle3d_tpu/datasets/modelnet40/modelnet40.py.

Layout: {root}/{split}/{class_name}/*.npy, each [N, 3] float32, the class
list from the sorted directory names; or one {root}/{split}.npz with
`points` and `labels` arrays (and optionally `class_names`).

The JAX class stores the per-cloud labels as `self.labels`, which
BaseDataset defines as a read-only property (the class-name list), so its
constructor raises AttributeError on either layout (ROADMAP.md, section
3). The port keeps them as `cloud_labels`; `labels` stays the class
names.
"""
import os
from typing import List

import numpy as np

from ...apis import manager
from ...sample import Sample
from ..base import BaseDataset, MetricABC

__all__ = ["ModelNet40", "AccuracyMetric"]


@manager.DATASETS.add_component
class ModelNet40(BaseDataset):
    def __init__(self, dataset_root: str, num_points: int = 1024,
                 mode: str = "train", transforms=None):
        self.dataset_root = dataset_root
        self.num_points = num_points
        self.mode = mode
        self.transforms = transforms

        npz = os.path.join(dataset_root, "{}.npz".format(mode))
        if os.path.exists(npz):
            data = np.load(npz)
            self.points = data["points"]
            self.cloud_labels = data["labels"]
            self.class_names = [str(c) for c in data.get(
                "class_names", range(int(self.cloud_labels.max()) + 1))]
        else:
            split_dir = os.path.join(dataset_root, mode)
            self.class_names = sorted(os.listdir(split_dir))
            files, labels = [], []
            for ci, cname in enumerate(self.class_names):
                cdir = os.path.join(split_dir, cname)
                for f in sorted(os.listdir(cdir)):
                    files.append(os.path.join(cdir, f))
                    labels.append(ci)
            self.files = files
            self.cloud_labels = np.asarray(labels, np.int64)
            self.points = None

    def __len__(self):
        return (len(self.cloud_labels) if self.points is None
                else self.points.shape[0])

    def __getitem__(self, index: int) -> Sample:
        """The cloud's first num_points points in test mode; in train mode
        a random subset (numpy's global RNG, as the JAX package draws it);
        a cloud with fewer points is drawn with replacement."""
        if self.points is not None:
            pts = np.asarray(self.points[index], np.float32)
        else:
            pts = np.load(self.files[index]).astype(np.float32)
        n = pts.shape[0]
        if n >= self.num_points:
            idx = np.random.choice(n, self.num_points, replace=False) \
                if self.is_train_mode else np.arange(self.num_points)
        else:
            idx = np.random.choice(n, self.num_points, replace=True)
        sample = Sample(path=None, modality="lidar")
        sample.data = pts[idx, :3]
        sample.labels = int(self.cloud_labels[index])
        sample.meta.id = index
        if self.transforms is not None:
            sample = self.transforms(sample)
        return sample

    def collate_fn(self, samples: List[Sample]):
        batch = {
            "data": np.stack([s.data for s in samples]),
            "labels": np.asarray([s.labels for s in samples], np.int32),
        }
        metas = [{"id": s.meta.get("id"), "label": s.labels}
                 for s in samples]
        return batch, metas

    @property
    def metric(self) -> "AccuracyMetric":
        return AccuracyMetric()


class AccuracyMetric(MetricABC):
    """Top-1 accuracy of predicted Samples (`labels`) against the label
    their meta carries."""

    def __init__(self):
        self.correct = 0
        self.total = 0

    def update(self, predictions: List[Sample], ground_truths=None):
        for pred in predictions:
            self.correct += int(pred.labels == pred.meta.get("label"))
            self.total += 1

    def compute(self, verbose: bool = False) -> dict:
        return {"acc": self.correct / max(self.total, 1)}
