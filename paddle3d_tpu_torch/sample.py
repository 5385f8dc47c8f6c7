"""Sample record passed through transforms and models, a copy of
paddle3d_tpu/sample.py (Sample, SampleMeta): the port cannot import the
JAX package, whose __init__ imports jax. Host-side only: fields are numpy
arrays and Python scalars.
"""
from typing import Optional

__all__ = ["Sample", "SampleMeta"]

_MODALITIES = ("image", "lidar", "radar", "multimodal", "multiview")


class _EasyDict(dict):
    """A dict with attribute access."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key)

    def __setattr__(self, key, value):
        self[key] = value

    def __delattr__(self, key):
        try:
            del self[key]
        except KeyError:
            raise AttributeError(key)

    def copy(self):
        new = self.__class__.__new__(self.__class__)
        dict.update(new, self)
        return new


class SampleMeta(_EasyDict):
    """Per-sample metadata; any key is allowed."""

    KNOWN_KEYS = [
        "camera_intrinsic", "image_reverse", "image_difference", "id",
        "time_lag", "ray_translation", "ray_rotation", "img2lidar"
    ]

    def __init__(self, **kwargs):
        super().__init__()
        for k, v in kwargs.items():
            self[k] = v


class Sample(_EasyDict):
    """One example: path, modality (image / lidar / radar / multimodal /
    multiview), data, bboxes_2d / bboxes_3d, labels, sweeps, attrs,
    calibs and meta (a SampleMeta)."""

    def __init__(self, path: Optional[str], modality: str):
        super().__init__()
        if modality not in _MODALITIES:
            raise ValueError("modality must be one of {}, got {}".format(
                _MODALITIES, modality))
        self.meta = SampleMeta(id=None)
        self.path = path
        self.data = None
        self.modality = modality.lower()
        self.bboxes_2d = None
        self.bboxes_3d = None
        self.labels = None
        self.sweeps = []
        self.attrs = None
        self.calibs = None
