"""KITTI depth-supervised mono dataset for CADDN, a copy of
paddle3d_tpu/datasets/kitti/kitti_depth_det.py (reference:
paddle3d/datasets/kitti/kitti_depth_det.py:59 KittiDepthDataset +
kitti_metric.py:198 KittiDepthMetric).

Each sample carries the camera image resized to the fixed output size
(utils/image.resize, BICUBIC: Pillow's default for RGB, which the JAX
dataset relies on), the pixel-scale img2lidar matrix (intrinsics rescaled
to that size), LIDAR-frame gt boxes, and a lidar-projected depth map at the
feature-map resolution, the target of the FFE depth-distribution loss.
`ds[i]` is `ds.get(i)`, as the port's other datasets have it.
"""
from typing import List, Sequence

import numpy as np

from ...apis import manager
from ...geometries import BBoxes3D, CoordMode
from ...sample import Sample
from ...transforms.base import sample_rng
from ...utils.image import BICUBIC, resize
from ...utils.png import read_png
from . import kitti_utils
from .kitti_det import KittiDetDataset
from .kitti_metric import KittiMetric

__all__ = ["KittiDepthDataset", "KittiDepthMetric"]


class KittiDepthMetric(KittiMetric):
    """KITTI AP over bbox/bev/3d for depth-supervised camera models
    (reference: kitti_metric.py:198: the same evaluator; predictions arrive
    in the lidar frame and are converted through the calib)."""

    def __init__(self, groundtruths, classmap, calibs, ids):
        super().__init__(groundtruths, classmap, calibs, ids,
                         metrics=("bbox", "bev", "3d"))


@manager.DATASETS.add_component
class KittiDepthDataset(KittiDetDataset):
    max_gt_boxes = 50

    def __init__(self,
                 dataset_root: str,
                 mode: str = "train",
                 class_names: List[str] = None,
                 transforms=None,
                 image_size: Sequence[int] = (384, 1280),
                 depth_downsample_factor: int = 4,
                 point_cloud_range: Sequence[float] = None,
                 voxel_size: Sequence[float] = None,
                 remove_outside_boxes: bool = True):
        super().__init__(dataset_root, mode=mode, class_names=class_names,
                         transforms=transforms)
        self.image_size = tuple(image_size)  # (H, W) fixed output
        self.depth_downsample_factor = int(depth_downsample_factor)
        self.point_cloud_range = (np.asarray(point_cloud_range, np.float32)
                                  if point_cloud_range is not None else None)
        self.voxel_size = voxel_size
        self.remove_outside_boxes = remove_outside_boxes

    def _depth_map(self, points, calib, scale_xy):
        """Project lidar points into the (resized) image; the closest depth
        per cell of the downsampled grid (reference CaDDN points -> depth
        map)."""
        ds = self.depth_downsample_factor
        h, w = self.image_size
        hh, ww = h // ds, w // ds
        depth = np.zeros((hh, ww), np.float32)

        pts_rect = calib.lidar_to_rect(points[:, :3])
        uv, z = calib.rect_to_img(pts_rect)
        u = np.floor(uv[:, 0] * scale_xy[0] / ds).astype(np.int64)
        v = np.floor(uv[:, 1] * scale_xy[1] / ds).astype(np.int64)
        ok = (z > 0) & (u >= 0) & (u < ww) & (v >= 0) & (v < hh)
        u, v, z = u[ok], v[ok], z[ok]
        if len(z):
            # sorted by depth descending, so that the closest point of a
            # cell is written last (numpy's fancy assignment keeps the last)
            order = np.argsort(-z)
            depth[v[order], u[order]] = z[order]
        return depth

    def __getitem__(self, index: int) -> Sample:
        return self.get(index)

    def get(self, index: int, rng: np.random.RandomState = None) -> Sample:
        idx = self.ids[index]
        sample = Sample(path=self.image_path(idx), modality="image")
        sample.meta.id = idx
        sample.rng = sample_rng(0, 0, index) if rng is None else rng
        calib = self.load_calib(idx)
        sample.calibs = calib.as_matrices()

        h_out, w_out = self.image_size
        img = read_png(self.image_path(idx))
        h0, w0 = img.shape[:2]
        sample.data = np.asarray(resize(img, (w_out, h_out), BICUBIC),
                                 np.float32)
        sample.meta.image_shape = (h0, w0)
        sx, sy = w_out / w0, h_out / h0

        # pixel-scale lidar2img on the resized image
        p2 = np.vstack([calib.P2, [0., 0., 0., 1.]]).astype(np.float64)
        scale = np.diag([sx, sy, 1.0, 1.0])
        lidar2img = scale @ p2 @ calib.R0_4x4 @ calib.V2C_4x4
        sample.meta.lidar2img = lidar2img.astype(np.float32)
        sample.meta.img2lidar = np.linalg.inv(lidar2img).astype(np.float32)

        # depth target from the lidar scan
        points = np.fromfile(self.velodyne_path(idx),
                             np.float32).reshape(-1, 4)
        sample.meta.depth_map = self._depth_map(points, calib, (sx, sy))

        if not self.is_test_mode:
            anno = self.load_anno(idx)
            keep = np.isin(anno["name"], self.class_names)
            boxes_lidar = kitti_utils.camera_anno_to_lidar_boxes(
                {k: v[keep] for k, v in anno.items()}, calib)
            labels = np.array(
                [self.class_names.index(n) for n in anno["name"][keep]],
                np.int32)
            if self.remove_outside_boxes and \
                    self.point_cloud_range is not None and len(boxes_lidar):
                lo, hi = self.point_cloud_range[:3], self.point_cloud_range[3:]
                inside = np.all((boxes_lidar[:, :3] >= lo) &
                                (boxes_lidar[:, :3] <= hi), axis=1)
                boxes_lidar, labels = boxes_lidar[inside], labels[inside]
            sample.bboxes_3d = BBoxes3D(
                boxes_lidar, coordmode=CoordMode.KittiLidar,
                origin=[.5, .5, 0.], rot_axis=2)
            sample.labels = labels

        if self.transforms is not None:
            sample = self.transforms(sample)
        return sample

    def collate_fn(self, samples: List[Sample]):
        b = len(samples)
        g = self.max_gt_boxes
        gt_boxes = np.zeros((b, g, 7), np.float32)
        gt_labels = np.full((b, g), -1, np.int32)
        for i, s in enumerate(samples):
            if s.bboxes_3d is not None and len(s.bboxes_3d):
                n = min(len(s.bboxes_3d), g)
                gt_boxes[i, :n] = np.asarray(s.bboxes_3d)[:n, :7]
                gt_labels[i, :n] = np.asarray(s.labels)[:n]
        batch = {
            "data": np.stack(
                [np.asarray(s.data, np.float32) for s in samples]),
            "img2lidars": np.stack(
                [s.meta.img2lidar for s in samples]),
            "depth_map": np.stack(
                [s.meta.depth_map for s in samples]),
            "gt_boxes": gt_boxes,
            "gt_labels": gt_labels,
        }
        metas = [{"path": s.path, "id": s.meta.get("id")} for s in samples]
        return batch, metas

    @property
    def metric(self) -> KittiDepthMetric:
        gts = [self.load_anno(i) for i in self.ids]
        calibs = [self.load_calib(i) for i in self.ids]
        return KittiDepthMetric(
            groundtruths=gts, classmap=dict(enumerate(self.class_names)),
            calibs=calibs, ids=self.ids)
