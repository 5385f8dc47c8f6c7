"""Point-cloud augmentations, a copy of the point and box transforms of
paddle3d_tpu/transforms/transform.py, from GlobalRotate to
SamplePointByVoxels (reference: paddle3d/transforms/transform.py).

Host-side numpy, run in the data loader's workers. Each draw comes from the
sample's generator (`transforms/base.py`), in the order the JAX transform
draws from numpy's global state: `random_sample()` for its
`np.random.random()`, the same method otherwise. HardVoxelize and the image
transforms wait for ROADMAP.md, queue 1, item 5.
"""
from typing import Sequence

import numpy as np

from ..apis import manager
from ..geometries import PointCloud, box_collision_test, points_in_rbbox_bev
from ..sample import Sample
from .base import TransformABC, rng_of

__all__ = [
    "GlobalRotate", "GlobalScale", "GlobalTranslate", "GlobalRotScaleTrans",
    "RandomFlip3D", "RandomVerticalFlip", "RandomHorizontalFlip",
    "ShufflePoint", "FilterBBoxOutsideRange", "FilterPointOutsideRange",
    "SamplePoint", "RandomObjectPerturb", "SamplePointByVoxels",
]


@manager.TRANSFORMS.add_component
class GlobalRotate(TransformABC):
    """Rotate the whole scene about z (reference: transform.py:136)."""

    def __init__(self, min_rot: float = -np.pi / 4, max_rot: float = np.pi / 4):
        self.min_rot = min_rot
        self.max_rot = max_rot

    def __call__(self, sample: Sample) -> Sample:
        angle = rng_of(sample).uniform(self.min_rot, self.max_rot)
        sample.data.rotate_around_z(angle)
        if sample.bboxes_3d is not None:
            sample.bboxes_3d.rotate_around_z(angle)
        return sample


@manager.TRANSFORMS.add_component
class GlobalScale(TransformABC):
    """(reference: transform.py:157)."""

    def __init__(self, min_scale: float = 0.95, max_scale: float = 1.05,
                 size=None):
        self.min_scale = min_scale
        self.max_scale = max_scale

    def __call__(self, sample: Sample) -> Sample:
        factor = rng_of(sample).uniform(self.min_scale, self.max_scale)
        sample.data.scale(factor)
        if sample.bboxes_3d is not None:
            sample.bboxes_3d.scale(factor)
        return sample


@manager.TRANSFORMS.add_component
class GlobalTranslate(TransformABC):
    """(reference: transform.py:183)."""

    def __init__(self, translation_std: Sequence[float] = (0.2, 0.2, 0.2),
                 distribution: str = "normal"):
        self.translation_std = np.asarray(translation_std, np.float32)
        self.distribution = distribution

    def __call__(self, sample: Sample) -> Sample:
        if self.distribution == "normal":
            t = rng_of(sample).normal(scale=self.translation_std, size=3)
        else:
            t = rng_of(sample).uniform(low=-self.translation_std,
                                  high=self.translation_std, size=3)
        sample.data.translate(t)
        if sample.bboxes_3d is not None:
            sample.bboxes_3d.translate(t)
        return sample


@manager.TRANSFORMS.add_component
class GlobalRotScaleTrans(TransformABC):
    """Combined rotate + scale + translate in one transform (reference:
    mmdet3d-style GlobalRotScaleTrans used by the nuScenes/bevdet configs —
    same op order as applying GlobalRotate/Scale/Translate in sequence)."""

    def __init__(self, rot_range: Sequence[float] = (-0.78539816, 0.78539816),
                 scale_ratio_range: Sequence[float] = (0.95, 1.05),
                 translation_std: Sequence[float] = (0., 0., 0.)):
        self.rot = GlobalRotate(rot_range[0], rot_range[1])
        self.scale = GlobalScale(scale_ratio_range[0], scale_ratio_range[1])
        self.trans = GlobalTranslate(translation_std)

    def __call__(self, sample: Sample) -> Sample:
        return self.trans(self.scale(self.rot(sample)))


@manager.TRANSFORMS.add_component
class RandomFlip3D(TransformABC):
    """Independent BEV-horizontal / BEV-vertical flips with per-axis ratios
    (reference: bevf_transforms.py:919 — its 'horizontal' flip negates Y,
    i.e. this repo's RandomVerticalFlip; 'vertical' negates X)."""

    def __init__(self, flip_ratio_bev_horizontal: float = 0.5,
                 flip_ratio_bev_vertical: float = 0.0, **kwargs):
        self.h = RandomVerticalFlip(flip_ratio_bev_horizontal)   # y -> -y
        self.v = RandomHorizontalFlip(flip_ratio_bev_vertical)   # x -> -x

    def __call__(self, sample: Sample) -> Sample:
        return self.v(self.h(sample))


@manager.TRANSFORMS.add_component
class RandomVerticalFlip(TransformABC):
    """Flip across the x axis (y -> -y) with prob 0.5
    (reference: transform.py:106)."""

    def __init__(self, prob: float = 0.5):
        self.prob = prob

    def __call__(self, sample: Sample) -> Sample:
        if rng_of(sample).random_sample() < self.prob:
            sample.data.flip_around_x_axis()
            if sample.bboxes_3d is not None:
                sample.bboxes_3d.vertical_flip()
        return sample


@manager.TRANSFORMS.add_component
class RandomHorizontalFlip(TransformABC):
    """Flip across the y axis (x -> -x) with prob 0.5
    (reference: transform.py:45)."""

    def __init__(self, prob: float = 0.5):
        self.prob = prob

    def __call__(self, sample: Sample) -> Sample:
        if rng_of(sample).random_sample() < self.prob:
            sample.data.flip_around_y_axis()
            if sample.bboxes_3d is not None:
                sample.bboxes_3d.horizontal_flip()
        return sample


@manager.TRANSFORMS.add_component
class ShufflePoint(TransformABC):
    """(reference: transform.py:234)."""

    def __call__(self, sample: Sample) -> Sample:
        sample.data.shuffle(rng_of(sample))
        return sample


@manager.TRANSFORMS.add_component
class FilterBBoxOutsideRange(TransformABC):
    """Drop gt boxes whose BEV footprint misses the range
    (reference: transform.py:322)."""

    def __init__(self, point_cloud_range: Sequence[float]):
        self.point_cloud_range = np.asarray(point_cloud_range, np.float32)

    def __call__(self, sample: Sample) -> Sample:
        if sample.bboxes_3d is None or len(sample.bboxes_3d) == 0:
            return sample
        mask = sample.bboxes_3d.get_mask_of_bboxes_outside_range(
            self.point_cloud_range)
        sample.bboxes_3d = sample.bboxes_3d.masked_select(mask)
        sample.labels = sample.labels[mask]
        if getattr(sample, "difficulties", None) is not None:
            sample.difficulties = sample.difficulties[mask]
        return sample


@manager.TRANSFORMS.add_component
class FilterPointOutsideRange(TransformABC):
    """(reference: transform.py:337)."""

    def __init__(self, point_cloud_range: Sequence[float]):
        self.point_cloud_range = np.asarray(point_cloud_range, np.float32)

    def __call__(self, sample: Sample) -> Sample:
        pts = np.asarray(sample.data)
        r = self.point_cloud_range
        mask = np.all((pts[:, :3] >= r[:3]) & (pts[:, :3] <= r[3:6]), axis=1)
        sample.data = PointCloud(pts[mask])
        return sample


@manager.TRANSFORMS.add_component
class SamplePoint(TransformABC):
    """Random subsample to a fixed point count (reference: transform.py:263)."""

    def __init__(self, num_points: int):
        self.num_points = num_points

    def __call__(self, sample: Sample) -> Sample:
        pts = np.asarray(sample.data)
        n = pts.shape[0]
        if n >= self.num_points:
            idx = rng_of(sample).choice(n, self.num_points, replace=False)
        else:
            idx = np.concatenate([
                np.arange(n),
                rng_of(sample).choice(n, self.num_points - n, replace=True)
            ])
        sample.data = PointCloud(pts[idx])
        return sample


@manager.TRANSFORMS.add_component
class RandomObjectPerturb(TransformABC):
    """Independently jitter each gt box (+ its interior points)
    (reference: transform.py:395). Accepts a perturbation only if the moved
    box collides with no other box."""

    def __init__(self,
                 rotation_range=(-np.pi / 4, np.pi / 4),
                 translation_std=(1.0, 1.0, 0.5),
                 max_num_attempts: int = 100):
        if isinstance(rotation_range, (int, float)):
            rotation_range = (-rotation_range, rotation_range)
        self.rotation_range = rotation_range
        self.translation_std = np.asarray(translation_std, np.float32)
        self.max_num_attempts = max_num_attempts

    def __call__(self, sample: Sample) -> Sample:
        boxes = sample.bboxes_3d
        if boxes is None or len(boxes) == 0:
            return sample
        pts = np.asarray(sample.data)
        arr = np.asarray(boxes)
        n = len(arr)
        in_box = points_in_rbbox_bev(pts, arr, origin=boxes.origin)  # [P,N]
        rng = rng_of(sample)

        for i in range(n):
            for _ in range(self.max_num_attempts):
                t = rng.normal(scale=self.translation_std, size=3)
                r = rng.uniform(*self.rotation_range)
                cand = arr[i].copy()
                cand[:3] += t
                cand[6] += r
                others = np.delete(arr, i, axis=0)
                coll = box_collision_test(
                    cand[None, [0, 1, 3, 4, 6]], others[:, [0, 1, 3, 4, 6]])
                if not coll.any():
                    # move the box's points with it
                    sel = in_box[:, i]
                    local = pts[sel, :3] - arr[i, :3]
                    c, s = np.cos(r), np.sin(r)
                    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]],
                                   np.float32)
                    pts[sel, :3] = local @ rot.T + cand[:3]
                    arr[i] = cand
                    break
        sample.data = PointCloud(pts)
        np.asarray(sample.bboxes_3d)[...] = arr
        return sample


@manager.TRANSFORMS.add_component
class SamplePointByVoxels(TransformABC):
    """Voxel-grid downsample then cap to num_points
    (reference: transform.py:274 SamplePointByVoxels — keep at most one
    point per fine voxel before random sampling, preserving coverage)."""

    def __init__(self, num_points: int, voxel_size=(0.1, 0.1, 0.1),
                 point_cloud_range=(0., -40., -3., 70.4, 40., 1.)):
        self.num_points = num_points
        self.voxel_size = np.asarray(voxel_size, np.float32)
        self.point_cloud_range = np.asarray(point_cloud_range, np.float32)

    def __call__(self, sample: Sample) -> Sample:
        pts = np.asarray(sample.data)
        lo = self.point_cloud_range[:3]
        hi = self.point_cloud_range[3:]
        grid = np.maximum(((hi - lo) / self.voxel_size).astype(np.int64), 1)
        cell = np.floor((pts[:, :3] - lo) / self.voxel_size).astype(np.int64)
        inb = np.all((cell >= 0) & (cell < grid), axis=1)
        pts = pts[inb]
        cell = cell[inb]
        key = (cell[:, 0] * grid[1] + cell[:, 1]) * grid[2] + cell[:, 2]
        _, first = np.unique(key, return_index=True)
        pts = pts[np.sort(first)]
        if pts.shape[0] > self.num_points:
            sel = rng_of(sample).choice(pts.shape[0], self.num_points,
                                   replace=False)
            pts = pts[sel]
        elif pts.shape[0] < self.num_points:
            extra = rng_of(sample).choice(pts.shape[0],
                                     self.num_points - pts.shape[0])
            pts = np.concatenate([pts, pts[extra]], axis=0)
        sample.data = PointCloud(pts)
        return sample
