"""Synthetic datasets, a copy of paddle3d_tpu/datasets/synthetic.py:
SyntheticDataset / SyntheticMetric (the LiDAR tiny configs),
SyntheticMVDataset / SyntheticMVMetric (PETR's), SyntheticMonoDataset /
SyntheticMonoMetric (SMOKE's), SyntheticDepthDataset / SyntheticDepthMetric
(CADDN's), SyntheticRangeDataset / SyntheticRangeMetric (SqueezeSegV3's)
and SyntheticClsDataset / SyntheticClsMetric (PAConv's). Each scene is
drawn from `default_rng(seed * k + index)` with the JAX module's k, so the
scenes are the JAX ones array for array; the camera sets render their
images in memory (filled, shaded cuboids through each camera), so they need
no image decoder. A dataset whose transforms draw (the mono set's
Gt2SmokeTarget) hands each sample its generator, as the port's other
datasets do.

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

__all__ = ["SyntheticDataset", "SyntheticMetric", "SyntheticMVDataset",
           "SyntheticMVMetric", "SyntheticMonoDataset", "SyntheticMonoMetric",
           "SyntheticDepthDataset", "SyntheticDepthMetric",
           "SyntheticRangeDataset", "SyntheticRangeMetric",
           "SyntheticClsDataset", "SyntheticClsMetric"]


_CLASS_PALETTE = np.array([
    [200, 60, 50], [60, 170, 70], [60, 90, 200], [210, 180, 60],
    [170, 70, 190], [80, 190, 190], [230, 130, 60], [130, 130, 220],
    [90, 160, 90], [190, 90, 130]], np.float32)


def _convex_hull(pts):
    """Andrew's monotone chain; pts [M, 2] -> hull vertices CCW."""
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def turn(o, a, b):
        # np.cross(a - o, b - o) of 2-vectors, in numpy's arithmetic
        u, v = a - o, b - o
        return u[0] * v[1] - u[1] * v[0]

    def half(iterable):
        out = []
        for p in iterable:
            while len(out) >= 2 and turn(out[-2], out[-1], p) <= 0:
                out.pop()
            out.append(p)
        return out
    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1], np.float32)


def _fill_convex(img, pts2d, color):
    """Fill the convex hull of projected points [M, 2] (x, y) in place."""
    if len(pts2d) < 3:
        return
    h, w = img.shape[:2]
    x0 = max(int(np.floor(pts2d[:, 0].min())), 0)
    x1 = min(int(np.ceil(pts2d[:, 0].max())) + 1, w)
    y0 = max(int(np.floor(pts2d[:, 1].min())), 0)
    y1 = min(int(np.ceil(pts2d[:, 1].max())) + 1, h)
    if x1 <= x0 or y1 <= y0:
        return
    hull = _convex_hull(pts2d)
    if len(hull) < 3:
        return
    ys, xs = np.mgrid[y0:y1, x0:x1]
    inside = np.ones(ys.shape, bool)
    for i in range(len(hull)):
        a, bpt = hull[i], hull[(i + 1) % len(hull)]
        # hull is CCW in (x, y) math orientation: inside = left of edges
        inside &= ((bpt[0] - a[0]) * (ys - a[1])
                   - (bpt[1] - a[1]) * (xs - a[0])) >= 0
    img[y0:y1, x0:x1][inside] = color


def _render_cuboids(img, corners_img, depths, labels):
    """Paint projectively-consistent filled cuboids (far-to-near).

    corners_img: list of [8, 2] image-plane corner arrays (order: first 4
    = +length/front face, last 4 = -length/rear). Base color by class,
    brightness falls off with depth (a second depth cue besides apparent
    size), front face brighter / rear darker so heading is observable —
    the signal a mono/MV detector needs to regress depth, dims and ry
    (random-noise images give an overfit run nothing to learn)."""
    order = np.argsort(-np.asarray(depths))
    for i in order:
        c8 = corners_img[i]
        if c8 is None:
            continue
        shade = float(np.clip(1.15 - depths[i] / 70.0, 0.35, 1.0))
        base = _CLASS_PALETTE[int(labels[i]) % len(_CLASS_PALETTE)] * shade
        _fill_convex(img, c8, base)
        _fill_convex(img, c8[:4], np.clip(base * 1.45, 0, 255))   # front
        _fill_convex(img, c8[4:], base * 0.55)                    # rear


def _camera_box_corners(box):
    """KITTI camera-frame box (x, y_bottom, z, h, w, l, ry) -> [8, 3]
    corners, first 4 on the +l/2 (front) face."""
    x, yb, z, h, w, l, ry = [float(v) for v in box[:7]]
    xc = np.array([l, l, l, l, -l, -l, -l, -l], np.float32) / 2
    yc = np.array([0, 0, -h, -h, 0, 0, -h, -h], np.float32) * 1.0
    zc = np.array([w, -w, w, -w, w, -w, w, -w], np.float32) / 2
    cr, sr = np.cos(ry), np.sin(ry)
    cx = cr * xc + sr * zc + x
    cz = -sr * xc + cr * zc + z
    cy = yc + yb
    return np.stack([cx, cy, cz], axis=-1)


def _lidar_box_corners(box):
    """LiDAR-frame box (x, y, z_center, w, l, h, ry) -> [8, 3] corners,
    first 4 on the +l/2 (front) face."""
    x, y, z, w, l, h = [float(v) for v in box[:6]]
    ry = float(box[6])
    xc = np.array([l, l, l, l, -l, -l, -l, -l], np.float32) / 2
    yc = np.array([w, -w, w, -w, w, -w, w, -w], np.float32) / 2
    zc = np.array([h, h, -h, -h, h, h, -h, -h], np.float32) / 2
    cr, sr = np.cos(ry), np.sin(ry)
    gx = cr * xc - sr * yc + x
    gy = sr * xc + cr * yc + y
    return np.stack([gx, gy, zc + z], axis=-1)


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
class SyntheticMVDataset(BaseDataset):
    """Synthetic multi-view camera detection dataset.

    Emits the NuscenesMVDataset batch contract (img [B,N,H,W,3] in [0,1],
    lidar2imgs/img2lidars [B,N,4,4], 9-dim gt boxes with velocities) so
    PETR/BEVFormer-family models can run hermetic train/eval/export loops
    without nuScenes on disk."""

    def __init__(self,
                 num_samples: int = 16,
                 num_cams: int = 2,
                 image_hw=(64, 96),
                 max_boxes: int = 4,
                 point_cloud_range=(-10., -10., -3., 10., 10., 3.),
                 mode: str = "train",
                 seed: int = 0):
        self.num_samples = num_samples
        self.num_cams = num_cams
        self.image_hw = tuple(image_hw)
        self.max_boxes = max_boxes
        self.max_gt_boxes = max_boxes
        self.pc_range = np.asarray(point_cloud_range, np.float32)
        self.mode = mode
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def _mats(self):
        """Per-camera lidar<->image homogeneous transforms. Toy perspective
        frustum (image coords normalized [0,1], PETR's [u*d, v*d, d, 1]
        convention): depth along each camera's forward axis; cameras are
        yawed evenly around z so together they cover the full scene
        (one shared orientation left boxes behind every camera)."""
        proj = np.array([[0, 1 / 8, 0, 0.5],
                         [0, 0, 1 / 4, 0.5],
                         [1, 0, 0, 0],
                         [0, 0, 0, 1]], np.float32)
        l2i = np.zeros((self.num_cams, 4, 4), np.float32)
        i2l = np.zeros((self.num_cams, 4, 4), np.float32)
        for c in range(self.num_cams):
            th = 2 * np.pi * c / self.num_cams
            rot = np.eye(4, dtype=np.float32)
            rot[0, 0] = np.cos(th)
            rot[0, 1] = np.sin(th)
            rot[1, 0] = -np.sin(th)
            rot[1, 1] = np.cos(th)
            l2i[c] = proj @ rot
            i2l[c] = np.linalg.inv(l2i[c])
        return l2i, i2l

    def _gen(self, index: int):
        cached = getattr(self, "_cache", None)
        if cached is not None and index in cached:
            return cached[index]
        rng = np.random.default_rng(self.seed * 99991 + index)
        h, w = self.image_hw
        n = int(rng.integers(1, self.max_boxes + 1))
        # separation-sampled centers (see SyntheticMonoDataset._gen)
        centers = []
        for _ in range(64):
            if len(centers) == n:
                break
            cx = float(rng.uniform(-8, 8))
            cy = float(rng.uniform(-8, 8))
            if all((cx - a) ** 2 + (cy - b) ** 2 >= 5.5 ** 2
                   for a, b in centers):
                centers.append((cx, cy))
        n = len(centers)
        boxes = np.zeros((n, 9), np.float32)
        boxes[:, 0] = [c[0] for c in centers]
        boxes[:, 1] = [c[1] for c in centers]
        boxes[:, 2] = -1.5
        boxes[:, 3:6] = [1.9, 4.6, 1.7]
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
        labels = rng.integers(0, 3, n).astype(np.int32)

        # structured images: per-camera gradient background + the boxes
        # rendered through each camera's lidar->image transform, so the
        # views are projectively consistent with the 3D annotations
        l2i, _ = self._mats()
        imgs = np.empty((self.num_cams, h, w, 3), np.float32)
        for ci in range(self.num_cams):
            grad = np.linspace(115, 55, h, dtype=np.float32)[:, None]
            img_f = np.broadcast_to(grad[..., None], (h, w, 3)).copy()
            img_f[:h // 3] += np.array([25, 35, 65], np.float32)
            corners, depths = [], []
            for b in boxes:
                c3 = _lidar_box_corners(b[:7])
                hom = np.concatenate(
                    [c3, np.ones((8, 1), np.float32)], axis=1) @ l2i[ci].T
                if np.any(hom[:, 2] <= 1e-3):
                    corners.append(None)
                    depths.append(1e9)
                    continue
                uv = hom[:, :2] / hom[:, 2:3]       # normalized [0,1]
                corners.append(
                    (uv * np.array([w, h], np.float32)).astype(np.float32))
                depths.append(float(hom[:, 2].mean()))
            _render_cuboids(img_f, corners, depths, labels)
            imgs[ci] = np.clip(img_f, 0, 255)
        out = (imgs, boxes, labels)
        if cached is None:
            self._cache = {}
        self._cache[index] = out
        return out

    def __getitem__(self, index: int) -> Sample:
        imgs, boxes, labels = self._gen(index)
        l2i, i2l = self._mats()
        sample = Sample(path="synthetic-mv://{}".format(index),
                        modality="multiview")
        sample.img = imgs
        sample.bboxes_3d = BBoxes3D(
            boxes, coordmode=CoordMode.NuScenesLidar, origin=[.5, .5, .5])
        sample.labels = labels
        sample.meta.id = index
        sample.meta.lidar2imgs = l2i
        sample.meta.img2lidars = i2l
        return sample

    def collate_fn(self, samples: List[Sample]):
        b = len(samples)
        g = self.max_gt_boxes
        gt_boxes = np.zeros((b, g, 9), np.float32)
        gt_labels = np.full((b, g), -1, np.int32)
        for i, s in enumerate(samples):
            n = min(len(s.bboxes_3d), g)
            gt_boxes[i, :n] = np.asarray(s.bboxes_3d)[:n]
            gt_labels[i, :n] = np.asarray(s.labels)[:n]
        batch = {
            "img": np.stack([s.img for s in samples]) / 255.0,
            "lidar2imgs": np.stack([s.meta.lidar2imgs for s in samples]),
            "img2lidars": np.stack([s.meta.img2lidars for s in samples]),
            "gt_boxes": gt_boxes,
            "gt_labels": gt_labels,
        }
        metas = [{"path": s.path, "id": s.meta.get("id")} for s in samples]
        return batch, metas

    @property
    def metric(self) -> "SyntheticMVMetric":
        return SyntheticMVMetric(self)


@manager.DATASETS.add_component
class SyntheticMonoDataset(BaseDataset):
    """Synthetic monocular camera detection dataset.

    Emits KittiMonoDataset's contract — uint8 image, camera intrinsics,
    CAMERA-frame boxes (x, y_bottom, z, h, w, l, ry) — so SMOKE-style mono
    models run hermetic train/eval/export/TIPC loops with a config-driven
    transform pipeline (Gt2SmokeTarget) and no KITTI on disk."""

    max_gt_boxes = 8

    def __init__(self,
                 num_samples: int = 16,
                 image_hw=(96, 128),
                 max_boxes: int = 3,
                 mode: str = "train",
                 seed: int = 0,
                 transforms=None):
        if isinstance(transforms, list):
            from ..transforms import Compose
            transforms = Compose(transforms)
        self.transforms = transforms
        self.num_samples = num_samples
        self.image_hw = tuple(image_hw)
        self.max_boxes = max_boxes
        self.mode = mode
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def _intrinsic(self):
        h, w = self.image_hw
        # focal scales with the image (fixed 60 px was sized for the 96x128
        # test fixture; at 384x1280 it projected cars to ~5 px — no signal)
        f = 0.55 * w
        return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]],
                        np.float32)

    def _gen(self, index: int):
        cached = getattr(self, "_cache", None)
        if cached is not None and index in cached:
            return cached[index]
        rng = np.random.default_rng(self.seed * 77773 + index)
        h, w = self.image_hw
        n = int(rng.integers(1, self.max_boxes + 1))
        # rejection-sample box centers with >= 5.5 m separation: physically
        # overlapping cars occlude each other in the render and collide on
        # the stride-4 heatmap, capping the overfit AP
        centers = []
        for _ in range(64):
            if len(centers) == n:
                break
            cx = float(rng.uniform(-5, 5))
            cz = float(rng.uniform(8, 30))
            if all((cx - a) ** 2 + (cz - b) ** 2 >= 5.5 ** 2
                   for a, b in centers):
                centers.append((cx, cz))
        n = len(centers)
        boxes = np.zeros((n, 7), np.float32)
        boxes[:, 0] = [c[0] for c in centers]    # x (camera right)
        boxes[:, 1] = 1.5                        # y bottom (down)
        boxes[:, 2] = [c[1] for c in centers]    # z (depth)
        boxes[:, 3:6] = [1.5, 1.6, 3.9]          # (h, w, l)
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
        labels = np.zeros(n, np.int32)

        # structured image: deterministic sky/ground gradient with a
        # horizon at the principal point, plus rendered cuboids
        K = self._intrinsic()
        grad = np.linspace(120, 60, h, dtype=np.float32)[:, None]
        img_f = np.broadcast_to(grad[..., None], (h, w, 3)).copy()
        img_f[:int(K[1, 2])] += np.array([30, 40, 70], np.float32)
        corners, depths = [], []
        for b in boxes:
            c3 = _camera_box_corners(b)
            if np.any(c3[:, 2] <= 0.5):
                corners.append(None)
            else:
                uvw = c3 @ K.T
                corners.append((uvw[:, :2] / uvw[:, 2:3]).astype(np.float32))
            depths.append(b[2])
        _render_cuboids(img_f, corners, depths, labels)
        img = np.clip(img_f, 0, 255).astype(np.uint8)
        out = (img, boxes, labels)
        if cached is None:
            self._cache = {}
        self._cache[index] = out
        return out

    def __getitem__(self, index: int) -> Sample:
        return self.get(index)

    def get(self, index: int, rng: np.random.RandomState = None) -> Sample:
        img, boxes, labels = self._gen(index)
        sample = Sample(path="synthetic-mono://{}".format(index),
                        modality="image")
        sample.data = img
        sample.meta.id = index
        sample.meta.camera_intrinsic = self._intrinsic()
        sample.bboxes_3d = boxes
        sample.labels = labels
        sample.rng = sample_rng(self.seed, 0, index) if rng is None else rng
        if self.transforms is not None:
            sample = self.transforms(sample)
        return sample

    def collate_fn(self, samples: List[Sample]):
        batch = {
            "data": np.stack([np.asarray(s.data, np.float32)
                              for s in samples]),
        }
        if getattr(samples[0], "target", None) is not None:
            tkeys = samples[0].target.keys()
            batch["target"] = {
                k: np.stack([s.target[k] for s in samples]) for k in tkeys
            }
        metas = [{"path": s.path, "id": s.meta.get("id")} for s in samples]
        return batch, metas

    @property
    def metric(self) -> "SyntheticMonoMetric":
        return SyntheticMonoMetric(self)


@manager.DATASETS.add_component
class SyntheticDepthDataset(BaseDataset):
    """Synthetic depth-supervised mono dataset (CADDN's hermetic contract).

    Emits KittiDepthDataset's batch keys (kitti_depth_det.py:131-150):
    float image `data`, pixel-scale `img2lidars`, a downsampled
    lidar-projected `depth_map`, and LIDAR-frame gt boxes — so the CADDN
    TIPC chain (reference test_tipc/configs/caddn/) runs train→eval→
    export→infer without KITTI on disk. The toy frustum is linear and
    invertible: lidar x = depth, y/z affine in pixel coords."""

    max_gt_boxes = 8

    def __init__(self,
                 num_samples: int = 16,
                 image_hw=(64, 96),
                 depth_downsample_factor: int = 16,
                 max_boxes: int = 3,
                 mode: str = "train",
                 seed: int = 0,
                 transforms=None):
        self.num_samples = num_samples
        self.image_hw = tuple(image_hw)
        self.depth_downsample_factor = int(depth_downsample_factor)
        self.max_boxes = max_boxes
        self.mode = mode
        self.seed = seed
        self.transforms = None

    def __len__(self):
        return self.num_samples

    def _img2lidar(self):
        h, w = self.image_hw
        m = np.zeros((4, 4), np.float32)
        m[0, 2] = 1.0                   # lidar x = depth
        m[1, 0] = -0.1                  # lidar y from u
        m[1, 3] = 0.1 * w / 2
        m[2, 1] = -0.05                 # lidar z from v
        m[2, 3] = 0.05 * h / 2 - 1.6    # centered, below sensor
        m[3, 3] = 1.0
        return m

    def _gen(self, index: int):
        rng = np.random.default_rng(self.seed * 55511 + index)
        h, w = self.image_hw
        img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
        n = int(rng.integers(1, self.max_boxes + 1))
        boxes = np.zeros((n, 7), np.float32)
        m = self._img2lidar()
        # sample in pixel/depth space so every box sits inside the frustum
        u = rng.uniform(0.2 * w, 0.8 * w, n)
        v = rng.uniform(0.3 * h, 0.7 * h, n)
        d = rng.uniform(4.0, 14.0, n)
        uv1 = np.stack([u, v, d, np.ones(n)], axis=-1)
        xyz = (uv1 @ m.T)[:, :3]
        boxes[:, :3] = xyz
        boxes[:, 3:6] = [1.9, 4.0, 1.6]
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
        labels = np.zeros(n, np.int32)

        ds = self.depth_downsample_factor
        depth = np.zeros((h // ds, w // ds), np.float32)
        ui = np.clip((u / ds).astype(np.int64), 0, w // ds - 1)
        vi = np.clip((v / ds).astype(np.int64), 0, h // ds - 1)
        depth[vi, ui] = d
        return img, depth, boxes, labels

    def __getitem__(self, index: int) -> Sample:
        img, depth, boxes, labels = self._gen(index)
        sample = Sample(path="synthetic-depth://{}".format(index),
                        modality="image")
        sample.data = img
        sample.meta.id = index
        sample.meta.img2lidar = self._img2lidar()
        sample.meta.depth_map = depth
        sample.bboxes_3d = BBoxes3D(
            boxes, coordmode=CoordMode.KittiLidar, origin=[.5, .5, .5])
        sample.labels = labels
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
    def metric(self) -> "SyntheticDepthMetric":
        return SyntheticDepthMetric(self)


class SyntheticDepthMetric(MetricABC):
    """Lidar-plane (x, y) center-distance recall/precision at 2m."""

    def __init__(self, dataset: "SyntheticDepthDataset",
                 dist_thresh: float = 2.0):
        self.dataset = dataset
        self.dist_thresh = dist_thresh
        self._tp = 0
        self._n_gt = 0
        self._n_pred = 0

    def update(self, predictions: List[Sample], ground_truths=None):
        for pred in predictions:
            idx = pred.meta.get("id")
            _, _, gt_boxes, _ = self.dataset._gen(idx)
            self._n_gt += len(gt_boxes)
            if pred.bboxes_3d is None or len(pred.bboxes_3d) == 0:
                continue
            pb = np.asarray(pred.bboxes_3d)
            self._n_pred += len(pb)
            d = np.linalg.norm(
                pb[:, None, :2] - gt_boxes[None, :, :2], axis=-1)
            matched = np.zeros(len(gt_boxes), bool)
            for row in np.argsort(d.min(axis=1)):
                j = int(np.argmin(np.where(matched, np.inf, d[row])))
                if not matched[j] and d[row, j] < self.dist_thresh:
                    matched[j] = True
            self._tp += int(matched.sum())

    def compute(self, verbose: bool = False) -> dict:
        return {"recall@2m": self._tp / max(self._n_gt, 1),
                "precision@2m": self._tp / max(self._n_pred, 1)}


class SyntheticMonoMetric(MetricABC):
    """Camera-plane (x, z) center-distance recall/precision at 2m."""

    def __init__(self, dataset: SyntheticMonoDataset,
                 dist_thresh: float = 2.0):
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
            d = np.linalg.norm(
                pb[:, [0, 2]][:, None] - gt_boxes[:, [0, 2]][None], axis=-1)
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


class SyntheticMVMetric(MetricABC):
    """Center-distance recall/precision at 2m for the MV fixture."""

    def __init__(self, dataset: SyntheticMVDataset, dist_thresh: float = 2.0):
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
