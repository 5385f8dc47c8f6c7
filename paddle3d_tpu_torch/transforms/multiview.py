"""Multi-view image transforms, a copy of paddle3d_tpu/transforms/multiview.py
(reference: paddle3d/transforms/transform.py:745 ResizeCropFlipImage, :858
MSResizeCropFlipImage, :1015 GlobalRotScaleTransImage, :1118
NormalizeMultiviewImage, :1207 PadMultiViewImage, :1293
PhotoMetricDistortionMultiViewImage, :1407 RandomScaleImageMultiViewImage,
and the GridMask augmentation of petr3d.py:38).

Each random value is drawn from the sample's generator (`rng_of(sample)`,
set by the dataset from the loader's seed, epoch and index) by the calls
the JAX transform makes on numpy's global state, in its order, so that the
JAX transform after `np.random.seed(s)` and this one under
`RandomState(s)` give equal arrays. Resizes go through utils/image.resize
(BILINEAR, byte-equal to Pillow's) and a crop past the image fills zeros,
as `Image.crop` does. MSResizeCropFlipImage picks its range a call
without writing it on the transform (the JAX one sets self.resize_range,
which loader threads would share).
"""
from typing import Sequence

import numpy as np

from ..apis import manager
from ..sample import Sample
from ..utils.image import BILINEAR, flip_left_right, resize
from .base import TransformABC, rng_of

__all__ = ["NormalizeMultiviewImage", "PadMultiViewImage",
           "ResizeCropFlipImage", "GridMask", "GlobalRotScaleTransImage",
           "PhotoMetricDistortionMultiViewImage",
           "RandomScaleImageMultiViewImage", "MSResizeCropFlipImage"]


def _crop(img: np.ndarray, x0: int, y0: int, w: int, h: int) -> np.ndarray:
    """`Image.crop((x0, y0, x0 + w, y0 + h))` of an [H, W, C] array: the
    part outside the image is zero."""
    out = np.zeros((h, w) + img.shape[2:], img.dtype)
    ys, xs = max(y0, 0), max(x0, 0)
    ye, xe = min(y0 + h, img.shape[0]), min(x0 + w, img.shape[1])
    if ye > ys and xe > xs:
        out[ys - y0:ye - y0, xs - x0:xe - x0] = img[ys:ye, xs:xe]
    return out


@manager.TRANSFORMS.add_component
class NormalizeMultiviewImage(TransformABC):
    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, sample: Sample) -> Sample:
        sample.img = (np.asarray(sample.img, np.float32) - self.mean) / \
            self.std
        return sample


@manager.TRANSFORMS.add_component
class PadMultiViewImage(TransformABC):
    def __init__(self, size_divisor: int = 32):
        self.size_divisor = size_divisor

    def __call__(self, sample: Sample) -> Sample:
        imgs = np.asarray(sample.img)
        n, h, w, c = imgs.shape
        d = self.size_divisor
        ph, pw = (-h) % d, (-w) % d
        if ph or pw:
            sample.img = np.pad(imgs, ((0, 0), (0, ph), (0, pw), (0, 0)))
        return sample


@manager.TRANSFORMS.add_component
class ResizeCropFlipImage(TransformABC):
    """A resize / crop / flip drawn a sample, its pixel-space matrix
    folded into the camera matrices (reference: transform.py:745)."""

    def __init__(self, resize_range=(0.94, 1.25), final_size=(320, 800),
                 rand_flip: bool = True, training: bool = True):
        self.resize_range = resize_range
        self.final_h, self.final_w = final_size
        self.rand_flip = rand_flip
        self.training = training

    def __call__(self, sample: Sample) -> Sample:
        return self._apply(sample, self.resize_range)

    def _apply(self, sample: Sample, resize_range) -> Sample:
        imgs = np.asarray(sample.img)
        n, h, w, c = imgs.shape
        rng = rng_of(sample) if self.training else None
        scale = rng.uniform(*resize_range) if self.training else 1.0
        new_h, new_w = int(h * scale), int(w * scale)
        crop_y = max(0, new_h - self.final_h)
        crop_x = max(0, (new_w - self.final_w) // 2)
        flip = (self.rand_flip and self.training and
                rng.random_sample() < 0.5)

        outs, mats = [], []
        for i in range(n):
            im = resize(imgs[i].astype(np.uint8), (new_w, new_h), BILINEAR)
            im = _crop(im, crop_x, crop_y, self.final_w, self.final_h)
            if flip:
                im = flip_left_right(im)
            outs.append(im.astype(np.float32))
            m = np.eye(4, dtype=np.float32)
            m[0, 0] = m[1, 1] = scale
            m[0, 3] = -crop_x
            m[1, 3] = -crop_y
            if flip:
                f = np.eye(4, dtype=np.float32)
                f[0, 0] = -1
                f[0, 3] = self.final_w - 1
                m = f @ m
            mats.append(m)
        sample.img = np.stack(outs)
        post = np.stack(mats)
        if sample.meta.get("lidar2imgs") is not None:
            sample.meta.lidar2imgs = post @ sample.meta.lidar2imgs
            sample.meta.img2lidars = np.linalg.inv(sample.meta.lidar2imgs)
        return sample


@manager.TRANSFORMS.add_component
class GridMask(TransformABC):
    """Structured grid dropout over the images (reference: petr3d.py:38)."""

    def __init__(self, ratio: float = 0.5, prob: float = 0.7,
                 max_d: int = 100):
        self.ratio = ratio
        self.prob = prob
        self.max_d = max_d

    def __call__(self, sample: Sample) -> Sample:
        rng = rng_of(sample)
        if rng.random_sample() > self.prob:
            return sample
        imgs = np.asarray(sample.img, np.float32)
        n, h, w, c = imgs.shape
        d = rng.randint(2, min(self.max_d, min(h, w)))
        keep = int(d * self.ratio + 0.5)
        off_y, off_x = rng.randint(0, d, 2)
        ys = ((np.arange(h) + off_y) % d) < keep
        xs = ((np.arange(w) + off_x) % d) < keep
        mask = (~(ys[:, None] & xs[None, :])).astype(np.float32)
        sample.img = imgs * mask[None, :, :, None]
        return sample


@manager.TRANSFORMS.add_component
class GlobalRotScaleTransImage(TransformABC):
    """A BEV rotation, scale and translation drawn a sample: the gt boxes
    move in lidar space and the inverse folds into every camera's
    lidar2img (reference: transform.py:1015). A sample without boxes
    only has its matrices moved (the JAX transform raises on it)."""

    def __init__(self, rot_range=(-0.3925, 0.3925),
                 scale_ratio_range=(0.95, 1.05),
                 translation_std=(0., 0., 0.), training: bool = True):
        self.rot_range = rot_range
        self.scale_ratio_range = scale_ratio_range
        self.translation_std = np.asarray(translation_std, np.float32)
        self.training = training

    def __call__(self, sample: Sample) -> Sample:
        if not self.training:
            return sample
        rng = rng_of(sample)
        angle = rng.uniform(*self.rot_range)
        scale = rng.uniform(*self.scale_ratio_range)
        trans = rng.normal(scale=self.translation_std, size=3) \
            if self.translation_std.any() else np.zeros(3)

        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32)
        tf = np.eye(4, dtype=np.float32)
        tf[:3, :3] = rot * scale
        tf[:3, 3] = trans

        if sample.bboxes_3d is not None and len(sample.bboxes_3d):
            boxes = np.asarray(sample.bboxes_3d).copy()
            boxes[:, :3] = boxes[:, :3] @ (rot * scale).T + trans
            boxes[:, 3:6] *= scale
            boxes[:, 6] += angle
            if boxes.shape[1] > 7:  # velocities
                boxes[:, 7:9] = boxes[:, 7:9] @ (rot[:2, :2] * scale).T
            if hasattr(sample.bboxes_3d, "coordmode"):
                np.asarray(sample.bboxes_3d)[...] = boxes
            else:
                sample.bboxes_3d = boxes

        inv = np.linalg.inv(tf)
        if sample.meta.get("lidar2imgs") is not None:
            sample.meta.lidar2imgs = sample.meta.lidar2imgs @ inv
            sample.meta.img2lidars = np.linalg.inv(sample.meta.lidar2imgs)
        return sample


@manager.TRANSFORMS.add_component
class PhotoMetricDistortionMultiViewImage(TransformABC):
    """Brightness / contrast / saturation / hue jitter drawn a view
    (reference: transform.py:1293)."""

    def __init__(self, brightness_delta: float = 32.,
                 contrast_range=(0.5, 1.5), saturation_range=(0.5, 1.5),
                 hue_delta: float = 18.):
        self.brightness_delta = brightness_delta
        self.contrast_lower, self.contrast_upper = contrast_range
        self.saturation_lower, self.saturation_upper = saturation_range
        self.hue_delta = hue_delta

    def _distort(self, img, rng):
        img = img.astype(np.float32)
        if rng.randint(2):
            img = img + rng.uniform(-self.brightness_delta,
                                    self.brightness_delta)
        contrast_first = rng.randint(2)
        if contrast_first and rng.randint(2):
            img = img * rng.uniform(self.contrast_lower, self.contrast_upper)
        if rng.randint(2):  # saturation
            gray = img.mean(axis=-1, keepdims=True)
            alpha = rng.uniform(self.saturation_lower, self.saturation_upper)
            img = gray + (img - gray) * alpha
        if rng.randint(2):  # the JAX transform's hue: a shift off the mean
            shift = rng.uniform(-self.hue_delta, self.hue_delta) / 255.
            img = img + shift * (img - img.mean(axis=-1, keepdims=True))
        if not contrast_first and rng.randint(2):
            img = img * rng.uniform(self.contrast_lower, self.contrast_upper)
        return np.clip(img, 0, 255)

    def __call__(self, sample: Sample) -> Sample:
        rng = rng_of(sample)
        imgs = np.asarray(sample.img)
        sample.img = np.stack([self._distort(im, rng) for im in imgs])
        return sample


@manager.TRANSFORMS.add_component
class RandomScaleImageMultiViewImage(TransformABC):
    """Every view scaled by one factor drawn from `scales`, the change
    folded into the camera matrices (reference: transform.py:1407)."""

    def __init__(self, scales=(0.5,)):
        self.scales = list(scales)

    def __call__(self, sample: Sample) -> Sample:
        imgs = np.asarray(sample.img)
        scale = float(rng_of(sample).choice(self.scales))
        n, h, w, _ = imgs.shape
        nh, nw = int(h * scale), int(w * scale)
        sample.img = np.stack([
            resize(im.astype(np.uint8), (nw, nh), BILINEAR).astype(
                np.float32) for im in imgs])
        m = np.eye(4, dtype=np.float32)
        m[0, 0] = m[1, 1] = scale
        if sample.meta.get("lidar2imgs") is not None:
            sample.meta.lidar2imgs = m[None] @ sample.meta.lidar2imgs
            sample.meta.img2lidars = np.linalg.inv(sample.meta.lidar2imgs)
        return sample


@manager.TRANSFORMS.add_component
class MSResizeCropFlipImage(ResizeCropFlipImage):
    """ResizeCropFlipImage with its factor's range drawn a call from
    several (reference: transform.py:858)."""

    def __init__(self, resize_ranges=((0.76, 0.96), (0.94, 1.25)),
                 final_size=(320, 800), rand_flip: bool = True,
                 training: bool = True):
        super().__init__(resize_ranges[0], final_size, rand_flip, training)
        self.resize_ranges = [tuple(r) for r in resize_ranges]

    def __call__(self, sample: Sample) -> Sample:
        pick = rng_of(sample).randint(len(self.resize_ranges))
        return self._apply(sample, self.resize_ranges[pick])
