"""Class-balanced GT-paste augmentation, the port of
paddle3d_tpu/transforms/sampling.py (reference: paddle3d/transforms/
sampling.py:33 SamplingDatabase, :293 Sampler).

Pastes pre-cropped object point clouds (built by
`python -m paddle3d_tpu_torch.tools.create_det_gt_database`) into the
scene, skipping pastes whose BEV box collides with an existing or an
already pasted box. It computes what the JAX transform computes (the
filters, n_wanted = max - existing a class, the collision test, the
relative points moved to the box centre and cut to the scene's columns,
labels and difficulties appended; the scene's own points inside a pasted
box stay), with two departures:

  * draws: the JAX Sampler keeps a shuffled permutation and a cursor
    across samples and reshuffles from numpy's global state, so its picks
    depend on the order in which the loader's threads built the samples
    before. Here a class's picks are `rng.permutation(len(annos))[:n]` of
    the sample's own generator (`transforms.rng_of`: the DataLoader's seed,
    epoch and index), so they depend on (seed, epoch, index) alone. Within
    one sample no entry is drawn twice, as within one JAX epoch of the
    cursor; across samples an entry may come again before the others have;
  * velocities: the JAX transform rebuilds the boxes without their
    velocities, so NuscenesPCDataset's collate writes zero velocity for
    every box of a pasted sample. Here a pasted sample keeps its boxes'
    velocities, and a pasted box takes its database entry's `velocity`
    (zero where the entry has none).
"""
import os
import pickle
from typing import Dict, List

import numpy as np

from ..apis import manager
from ..geometries import BBoxes3D, PointCloud, box_collision_test
from ..sample import Sample
from ..utils.logger import logger
from .base import TransformABC, rng_of

__all__ = ["SamplingDatabase", "Sampler"]


class Sampler:
    """One class's annotation list; a sample's picks come from its own
    generator."""

    def __init__(self, cls_name: str, annos: List[dict]):
        self.cls_name = cls_name
        self.annos = annos
        self.length = len(annos)

    def sampling(self, num: int, rng: np.random.RandomState) -> List[dict]:
        """min(num, len) distinct annotations in the order drawn."""
        picks = rng.permutation(self.length)[:num]
        return [self.annos[i] for i in picks]


@manager.TRANSFORMS.add_component
class SamplingDatabase(TransformABC):
    def __init__(self,
                 min_num_points_in_box_per_class: Dict[str, int],
                 max_num_samples_per_class: Dict[str, int],
                 database_anno_path: str,
                 database_root: str,
                 class_names: List[str],
                 ignored_difficulty: List[int] = None):
        self.min_num_points = min_num_points_in_box_per_class
        self.max_num_samples = max_num_samples_per_class
        self.database_root = database_root
        self.class_names = class_names
        self.ignored_difficulty = ignored_difficulty or []

        with open(database_anno_path, "rb") as f:
            database_anno = pickle.load(f)
        self.samplers = {}
        for cls_name, annos in database_anno.items():
            if cls_name not in class_names:
                continue
            filtered = [
                a for a in annos
                if a["num_points_in_box"] >= self.min_num_points.get(
                    cls_name, 0)
                and a.get("difficulty", 0) not in self.ignored_difficulty
            ]
            if filtered:
                self.samplers[cls_name] = Sampler(cls_name, filtered)
            logger.debug("SamplingDatabase[{}]: {} -> {} annos".format(
                cls_name, len(annos), len(filtered)))

    def _load_points(self, anno: dict) -> np.ndarray:
        path = os.path.join(self.database_root, anno["lidar_file"])
        return np.fromfile(path, np.float32).reshape(
            -1, anno.get("lidar_dim", 4))

    def __call__(self, sample: Sample) -> Sample:
        if sample.bboxes_3d is None:
            return sample
        rng = rng_of(sample)
        existing = np.asarray(sample.bboxes_3d)
        old_vel = sample.bboxes_3d.velocities
        labels = list(np.asarray(sample.labels))
        diffs = getattr(sample, "difficulties", None)
        diffs = list(np.asarray(diffs)) if diffs is not None else None
        pts = np.asarray(sample.data)

        new_boxes, new_points, new_vel = [], [], []
        all_bev = existing[:, [0, 1, 3, 4, 6]] if len(existing) else \
            np.zeros((0, 5), np.float32)

        for cls_name, sampler in self.samplers.items():
            cls_idx = self.class_names.index(cls_name)
            n_existing = int(np.sum(np.asarray(labels) == cls_idx))
            n_wanted = self.max_num_samples.get(cls_name, 0) - n_existing
            if n_wanted <= 0:
                continue
            for anno in sampler.sampling(n_wanted, rng):
                box = np.asarray(anno["box3d"], np.float32)
                coll = box_collision_test(box[None, [0, 1, 3, 4, 6]], all_bev)
                if coll.any():
                    continue
                obj_pts = self._load_points(anno)
                # database points are stored relative to the box center
                if anno.get("points_relative", True):
                    obj_pts = obj_pts.copy()
                    obj_pts[:, :3] += box[:3]
                new_boxes.append(box)
                new_points.append(obj_pts[:, :pts.shape[1]])
                new_vel.append(anno.get("velocity"))
                labels.append(cls_idx)
                if diffs is not None:
                    diffs.append(anno.get("difficulty", 0))
                all_bev = np.vstack([all_bev, box[None, [0, 1, 3, 4, 6]]])

        if new_boxes:
            boxes = np.vstack([existing, np.stack(new_boxes)]) if len(
                existing) else np.stack(new_boxes)
            velocities = None
            if old_vel is not None or any(v is not None for v in new_vel):
                old = (np.asarray(old_vel, np.float32).reshape(-1, 2)
                       if old_vel is not None else
                       np.zeros((len(existing), 2), np.float32))
                pasted = np.asarray([v if v is not None else (0.0, 0.0)
                                     for v in new_vel], np.float32)
                velocities = np.concatenate([old, pasted])
            sample.bboxes_3d = BBoxes3D(
                boxes, coordmode=sample.bboxes_3d.coordmode,
                velocities=velocities, origin=sample.bboxes_3d.origin,
                rot_axis=sample.bboxes_3d.rot_axis)
            sample.labels = np.asarray(labels, np.int32)
            if diffs is not None:
                sample.difficulties = np.asarray(diffs, np.int32)
            sample.data = PointCloud(
                np.vstack([pts] + new_points).astype(pts.dtype))
        return sample
