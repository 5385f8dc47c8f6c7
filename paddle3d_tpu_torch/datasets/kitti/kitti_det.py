"""KITTI detection datasets, a copy of paddle3d_tpu/datasets/kitti/kitti_det.py
(KittiDetDataset, KittiPCDataset; reference: paddle3d/datasets/kitti/
kitti_det.py:28 and kitti_pointcloud_det.py:27).

Layout:
    {root}/ImageSets/{train,val,trainval,test}.txt
    {root}/training/{velodyne,label_2,calib,image_2}/{id}.*
    {root}/testing/{velodyne,calib,image_2}/{id}.*

The JAX dataset opens the image with Pillow only to read its size; the port
reads the width and height from the PNG's IHDR chunk (utils/png.png_size),
so it needs no image library. A missing image gives `image_shape = None`,
as there.
"""
import os
from typing import List

import numpy as np

from ...apis import manager
from ...geometries import BBoxes3D, CoordMode
from ...sample import Sample
from ...transforms.base import sample_rng
from ...utils.png import png_size
from ..base import BaseDataset
from . import kitti_utils
from .kitti_metric import KittiMetric

__all__ = ["KittiDetDataset", "KittiPCDataset", "png_size"]


class KittiDetDataset(BaseDataset):
    CLASS_NAMES = ["Car", "Cyclist", "Pedestrian"]

    def __init__(self,
                 dataset_root: str,
                 class_names: List[str] = None,
                 transforms=None,
                 mode: str = "train"):
        self.dataset_root = dataset_root
        self.mode = mode.lower()
        self.class_names = class_names or self.CLASS_NAMES
        if isinstance(transforms, list):
            from ...transforms import Compose
            transforms = Compose(transforms)
        self.transforms = transforms
        if self.mode not in ("train", "val", "trainval", "test"):
            raise ValueError("mode should be train/val/trainval/test")

        split_file = os.path.join(dataset_root, "ImageSets",
                                  "{}.txt".format(self.mode))
        with open(split_file) as f:
            self.ids = [line.strip() for line in f if line.strip()]

    @property
    def base_dir(self) -> str:
        return os.path.join(self.dataset_root,
                            "testing" if self.is_test_mode else "training")

    def calib_path(self, idx: str) -> str:
        return os.path.join(self.base_dir, "calib", "{}.txt".format(idx))

    def label_path(self, idx: str) -> str:
        return os.path.join(self.base_dir, "label_2", "{}.txt".format(idx))

    def velodyne_path(self, idx: str) -> str:
        return os.path.join(self.base_dir, "velodyne", "{}.bin".format(idx))

    def image_path(self, idx: str) -> str:
        return os.path.join(self.base_dir, "image_2", "{}.png".format(idx))

    def load_calib(self, idx: str) -> kitti_utils.Calibration:
        return kitti_utils.Calibration.from_file(self.calib_path(idx))

    def load_anno(self, idx: str) -> dict:
        anno = kitti_utils.parse_label_file(self.label_path(idx))
        anno["difficulty"] = kitti_utils.compute_difficulty(
            anno["bbox"], anno["occluded"], anno["truncated"])
        return anno

    def __len__(self):
        return len(self.ids)

    def frame_labels(self, index: int):
        """Annotation-only class ids (for class-balanced resampling)."""
        anno = self.load_anno(self.ids[index])
        return np.asarray([
            self.class_names.index(n) for n in anno["name"]
            if n in self.class_names
        ], np.int32)

    @property
    def metric(self) -> KittiMetric:
        gts = [self.load_anno(i) for i in self.ids]
        calibs = [self.load_calib(i) for i in self.ids]
        return KittiMetric(
            groundtruths=gts, classmap=dict(enumerate(self.class_names)),
            calibs=calibs, ids=self.ids)


@manager.DATASETS.add_component
class KittiPCDataset(KittiDetDataset):
    """Point-cloud KITTI detection (reference: kitti_pointcloud_det.py:27).
    `ds[i]` is `ds.get(i)`: its random transforms draw from
    `transforms.sample_rng(0, 0, i)`; the DataLoader hands each sample the
    generator of its seed, epoch and index."""

    max_points = 120000
    max_gt_boxes = 64
    point_dim = 4

    def __getitem__(self, index: int) -> Sample:
        return self.get(index)

    def get(self, index: int, rng: np.random.RandomState = None) -> Sample:
        idx = self.ids[index]
        sample = Sample(path=self.velodyne_path(idx), modality="lidar")
        sample.meta.id = idx
        sample.rng = sample_rng(0, 0, index) if rng is None else rng
        calib = self.load_calib(idx)
        sample.calibs = calib.as_matrices()

        if not self.is_test_mode:
            anno = self.load_anno(idx)
            keep = np.isin(anno["name"], self.class_names)
            boxes_lidar = kitti_utils.camera_anno_to_lidar_boxes(
                {k: v[keep] for k, v in anno.items()}, calib)
            sample.bboxes_3d = BBoxes3D(
                boxes_lidar, coordmode=CoordMode.KittiLidar,
                origin=[.5, .5, 0.], rot_axis=2)
            sample.labels = np.array(
                [self.class_names.index(n) for n in anno["name"][keep]],
                np.int32)
            sample.difficulties = anno["difficulty"][keep]
        sample.meta.image_shape = png_size(self.image_path(idx))

        if self.transforms is not None:
            sample = self.transforms(sample)
        return sample
