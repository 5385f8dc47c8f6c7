"""Base numpy-subclass structure, a copy of
paddle3d_tpu/geometries/structure.py."""
import numpy as np


class _Structure(np.ndarray):
    """A numpy ndarray subclass that carries extra attributes through slicing.

    Subclasses declare attributes in __array_finalize__ via `_copy_attrs`.
    """

    _copy_attrs = ()

    def __new__(cls, data, dtype="float32", **kwargs):
        if data is None:
            raise ValueError("data cannot be None")
        arr = np.asarray(data, dtype=dtype).view(cls)
        for key, value in kwargs.items():
            setattr(arr, key, value)
        return arr

    def __array_finalize__(self, obj):
        if obj is None:
            return
        for attr in self._copy_attrs:
            setattr(self, attr, getattr(obj, attr, None))
