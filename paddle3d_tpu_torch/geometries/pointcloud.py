"""PointCloud structure, a copy of paddle3d_tpu/geometries/pointcloud.py.

One change: `shuffle` draws from the generator it is given (the JAX form
falls back to an unseeded `default_rng()`)."""
import numpy as np

from .structure import _Structure


class PointCloud(_Structure):
    """[N, C] points; first three columns are x, y, z."""

    def __init__(self, data: np.ndarray):
        if self.ndim != 2:
            raise ValueError(
                "Illegal PointCloud data with ndim {}".format(self.ndim))
        if self.shape[1] < 3:
            raise ValueError(
                "Illegal PointCloud data with shape {}".format(self.shape))

    def scale(self, factor: float):
        self[..., :3] = self[..., :3] * factor

    def translate(self, translation: np.ndarray):
        self[..., :3] = self[..., :3] + translation

    def rotate_around_z(self, angle: float):
        # CCW, matching BBoxes3D.rotate_around_z
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], dtype=self.dtype)
        self[..., :3] = self[..., :3] @ rot

    def flip_around_x_axis(self):
        self[..., 1] = -self[..., 1]

    def flip_around_y_axis(self):
        self[..., 0] = -self[..., 0]

    def shuffle(self, rng):
        """Permute the rows by `rng.permutation` (a RandomState or a
        Generator)."""
        perm = rng.permutation(self.shape[0])
        self[...] = self[perm]
