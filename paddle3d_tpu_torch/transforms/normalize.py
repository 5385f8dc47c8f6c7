"""Normalization transforms, the port's copy of
paddle3d_tpu/transforms/normalize.py (Normalize, NormalizeRangeImage).

NormalizeRangeImage normalises the last axis of the HWC range image that
LoadSemanticKITTIRange makes, and zeroes the pixels outside `proj_mask`.
The JAX transform reshapes mean and std to [C, 1, 1] and multiplies by the
[H, W] mask, a CHW layout: on that pipeline's HWC image it does not
broadcast (ROADMAP.md, section 3). The port does not copy that.
"""
from typing import Sequence

import numpy as np

from ..apis import manager
from ..sample import Sample
from .base import TransformABC

__all__ = ["Normalize", "NormalizeRangeImage"]


@manager.TRANSFORMS.add_component
class Normalize(TransformABC):
    """(img - mean) / std over the last axis of an HWC image, which is
    divided by 255 first when its values exceed 1."""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        if (self.std == 0).any():
            raise ValueError("std must be non-zero")

    def __call__(self, sample: Sample) -> Sample:
        img = np.asarray(sample.data, np.float32)
        if img.max() > 1.0 + 1e-6:
            img = img / 255.0
        sample.data = (img - self.mean) / self.std
        return sample


@manager.TRANSFORMS.add_component
class NormalizeRangeImage(TransformABC):
    """(data - mean) / std over the channels of an [H, W, C] range image,
    then times `proj_mask[..., None]` where the sample has a mask."""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, np.float32).reshape(-1)
        self.std = np.asarray(std, np.float32).reshape(-1)

    def __call__(self, sample: Sample) -> Sample:
        data = np.asarray(sample.data, np.float32)
        if data.ndim != 3 or data.shape[-1] != self.mean.shape[0]:
            raise ValueError(
                "NormalizeRangeImage takes an [H, W, {}] image, got "
                "{}".format(self.mean.shape[0], data.shape))
        sample.data = (data - self.mean) / self.std
        if getattr(sample, "proj_mask", None) is not None:
            sample.data = sample.data * sample.proj_mask[..., None]
        return sample
