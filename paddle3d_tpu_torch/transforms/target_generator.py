"""Host-side targets for camera models, numpy port of
paddle3d_tpu/transforms/target_generator.py (gaussian_radius_np,
draw_umich_gaussian, _project_box3d, Gt2SmokeTarget), without Pillow: the
flip and the BILINEAR resize are utils/image.py's, byte for byte Pillow's.

Mono targets stay on the host, entangled with host image augmentation (a
flip changes K).
"""
from typing import Tuple

import numpy as np

from ..apis import manager
from ..sample import Sample
from ..utils.image import BILINEAR, flip_left_right, resize
from .base import TransformABC, rng_of

__all__ = ["Gt2SmokeTarget", "draw_umich_gaussian", "gaussian_radius_np"]


def gaussian_radius_np(height, width, min_overlap=0.7):
    a1 = 1.
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(max(b1**2 - 4 * a1 * c1, 0.))) / 2
    a2 = 4.
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(max(b2**2 - 4 * a2 * c2, 0.))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(max(b3**2 - 4 * a3 * c3, 0.))) / 2
    return min(r1, r2, r3)


def draw_umich_gaussian(heatmap: np.ndarray, center, radius: int):
    """Max-compose a gaussian blob onto heatmap [H, W] in place."""
    diameter = 2 * radius + 1
    sigma = diameter / 6.
    xs = np.arange(diameter) - radius
    g = np.exp(-(xs[None, :]**2 + xs[:, None]**2) / (2 * sigma**2))
    x, y = int(center[0]), int(center[1])
    h, w = heatmap.shape
    l, r = min(x, radius), min(w - x, radius + 1)
    t, b = min(y, radius), min(h - y, radius + 1)
    if l + r <= 0 or t + b <= 0:
        return heatmap
    patch = heatmap[y - t:y + b, x - l:x + r]
    gpatch = g[radius - t:radius + b, radius - l:radius + r]
    np.maximum(patch, gpatch, out=patch)
    return heatmap


def _project_box3d(K, roty, dims_lhw, locs):
    """-> (projected 3D-center point [2], box2d [4]) in image pixels;
    camera frame, locs = bottom-center, dims = (l, h, w)."""
    l, h, w = dims_lhw
    x = np.array([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2])
    y = np.array([0., 0., 0., 0., -h, -h, -h, -h])
    z = np.array([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2])
    c, s = np.cos(roty), np.sin(roty)
    rx = c * x + s * z
    rz = -s * x + c * z
    corners = np.stack([rx, y, rz]) + np.asarray(locs).reshape(3, 1)
    center3d = np.asarray(locs) + np.array([0., -h / 2, 0.])
    pts = np.concatenate([corners, center3d.reshape(3, 1)], axis=1)
    if np.any(pts[2] <= 0.1):
        return np.zeros(2), np.zeros(4)
    uv = (K @ pts)
    uv = uv[:2] / uv[2]
    box2d = np.array([uv[0, :8].min(), uv[1, :8].min(),
                      uv[0, :8].max(), uv[1, :8].max()])
    return uv[:, 8], box2d


@manager.TRANSFORMS.add_component
class Gt2SmokeTarget(TransformABC):
    """Optional horizontal flip, the BILINEAR resize to input_size, gt
    centres projected onto the output map, the heatmap and the per-object
    regression targets at fixed max_objs shapes (reference:
    target_generator.py:180). In train mode the flip's draw comes from the
    sample's generator (`transforms.base.rng_of`), one `random()` a sample
    as the JAX transform draws from `np.random`; K and the scales stay those
    of the image as it arrived, as there."""

    def __init__(self,
                 mode: str,
                 num_classes: int,
                 flip_prob: float = 0.5,
                 max_objs: int = 50,
                 input_size: Tuple[int, int] = (1280, 384),
                 output_stride: Tuple[int, int] = (4, 4)):
        self.is_train = mode == "train"
        self.num_classes = num_classes
        self.flip_prob = flip_prob
        self.max_objs = max_objs
        self.input_w, self.input_h = input_size
        self.out_w = self.input_w // output_stride[0]
        self.out_h = self.input_h // output_stride[1]

    def __call__(self, sample: Sample) -> Sample:
        img = np.asarray(sample.data, np.uint8)    # as Pillow takes it
        K = np.array(sample.meta.camera_intrinsic, np.float32).reshape(3, 3)
        h0, w0 = img.shape[:2]

        flipped = False
        if self.is_train and rng_of(sample).random_sample() < self.flip_prob:
            flipped = True
            img = flip_left_right(img)
            K = K.copy()
            K[0, 2] = w0 - K[0, 2] - 1

        img = resize(img, (self.input_w, self.input_h), BILINEAR)

        sx = self.out_w / w0
        sy = self.out_h / h0
        trans_mat = np.array(
            [[sx, 0, 0], [0, sy, 0], [0, 0, 1]], np.float32)
        sample.data = np.asarray(img, np.float32)

        target = {
            "K": K,
            "K_inv": np.linalg.inv(K).astype(np.float32),
            "trans_mat": trans_mat,
            "image_size": np.array([h0, w0], np.float32),
            "down_ratio": np.array(
                [w0 / self.out_w, h0 / self.out_h], np.float32),
        }
        if not self.is_train:
            sample.target = target
            return sample

        m = self.max_objs
        heat_map = np.zeros((self.out_h, self.out_w, self.num_classes),
                            np.float32)
        cls_ids = np.zeros(m, np.int32)
        proj_points = np.zeros((m, 2), np.int32)
        dimensions = np.zeros((m, 3), np.float32)  # (h, w, l)
        locations = np.zeros((m, 3), np.float32)
        rotys = np.zeros(m, np.float32)
        reg_mask = np.zeros(m, np.uint8)
        flip_mask = np.zeros(m, np.uint8)
        bbox_size = np.zeros((m, 2), np.float32)

        boxes = (np.asarray(sample.bboxes_3d)
                 if sample.bboxes_3d is not None else np.zeros((0, 7)))
        labels = (np.asarray(sample.labels)
                  if sample.labels is not None else np.zeros((0,), np.int64))
        for i, (box3d, label) in enumerate(zip(boxes, labels)):
            if i == self.max_objs:
                break
            locs = box3d[0:3].copy()
            roty = float(box3d[6])
            if flipped:
                locs[0] *= -1
                roty *= -1
            h, w, l = box3d[3:6]
            point, box2d = _project_box3d(K, roty, (l, h, w), locs)
            if np.all(box2d == 0):
                continue
            point = point * [sx, sy]
            box2d = box2d * [sx, sy, sx, sy]
            box2d[[0, 2]] = box2d[[0, 2]].clip(0, self.out_w - 1)
            box2d[[1, 3]] = box2d[[1, 3]].clip(0, self.out_h - 1)
            bh, bw = box2d[3] - box2d[1], box2d[2] - box2d[0]
            center = np.array([(box2d[0] + box2d[2]) / 2,
                               (box2d[1] + box2d[3]) / 2], np.float32)
            if not (0 < center[0] < self.out_w and 0 < center[1] <
                    self.out_h):
                continue
            point_int = center.astype(np.int32)
            radius = max(0, int(gaussian_radius_np(bh, bw)))
            draw_umich_gaussian(heat_map[:, :, int(label)], point_int, radius)
            cls_ids[i] = int(label)
            proj_points[i] = point_int
            dimensions[i] = (h, w, l)
            locations[i] = locs
            rotys[i] = roty
            reg_mask[i] = 1
            flip_mask[i] = 1 if flipped else 0
            bbox_size[i] = (bw, bh)

        target.update(
            hm=heat_map, cls_ids=cls_ids, proj_p=proj_points,
            dimensions=dimensions, locations=locations, rotys=rotys,
            reg_mask=reg_mask, flip_mask=flip_mask, bbox_size=bbox_size)
        sample.target = target
        return sample
