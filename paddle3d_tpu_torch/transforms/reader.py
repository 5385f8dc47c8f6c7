"""File readers, a copy of paddle3d_tpu/transforms/reader.py: LoadImage
(PNG or JPEG by the file's signature, as `Image.open` picks, through the
port's own decoders, utils/png.py and utils/jpeg.py, in place of Pillow),
LoadPointCloud (sweeps included), RemoveCameraInvisiblePointsKITTI{,V2}
and LoadMapsFromFiles (the nuScenes BEV segmentation masks). The sweep
order is drawn from the sample's generator (`transforms/base.py`).
"""
from typing import List, Union

import numpy as np

from ..apis import manager
from ..geometries import PointCloud
from ..sample import Sample
from ..utils.image import read_image
from .base import TransformABC, rng_of

__all__ = ["LoadImage", "LoadPointCloud", "RemoveCameraInvisiblePointsKITTI",
           "RemoveCameraInvisiblePointsKITTIV2", "LoadMapsFromFiles"]


@manager.TRANSFORMS.add_component
class LoadImage(TransformABC):
    """Read sample.path into an HWC uint8 array (reference: reader.py:43).
    The reference YAMLs name a decode library: `pillow` decodes RGB, `cv2`
    BGR; each maps onto its channel order. to_chw and to_rgb are taken and
    not used, as in the JAX transform."""

    _READER_MODES = ("rgb", "bgr", "pillow", "cv2")

    def __init__(self, to_chw: bool = False, to_rgb: bool = True,
                 reader: str = "rgb"):
        if reader not in self._READER_MODES:
            raise ValueError("unsupported reader {}".format(reader))
        reader = {"pillow": "rgb", "cv2": "bgr"}.get(reader, reader)
        self.reader = reader
        self.to_rgb = to_rgb
        self.to_chw = to_chw

    def __call__(self, sample: Sample) -> Sample:
        img = read_image(sample.path)
        if self.reader == "bgr":
            img = img[..., ::-1]
        sample.data = img.copy()
        sample.meta.image_reader = self.reader
        sample.meta.image_format = "rgb" if self.reader == "rgb" else "bgr"
        sample.meta.channel_order = "hwc"
        return sample


@manager.TRANSFORMS.add_component
class LoadPointCloud(TransformABC):
    """Read a .bin point cloud, optionally aggregating sweeps
    (reference: reader.py:91)."""

    def __init__(self,
                 dim: int,
                 use_dim: Union[int, List[int]] = None,
                 use_time_lag: bool = False,
                 sweep_remove_radius: float = 1.0):
        self.dim = dim
        self.use_dim = list(range(use_dim)) if isinstance(use_dim,
                                                          int) else use_dim
        self.use_time_lag = use_time_lag
        self.sweep_remove_radius = sweep_remove_radius

    def _read(self, path: str) -> np.ndarray:
        """A .bin of float32 rows of `dim` columns, or a .npy of [N, dim]
        (the converted Waymo layout; the JAX reader takes .bin only)."""
        if path.endswith(".npy"):
            data = np.load(path).astype(np.float32)
            if data.ndim != 2 or data.shape[1] != self.dim:
                raise ValueError("{} holds {} points, not [N, {}]".format(
                    path, data.shape, self.dim))
            return data
        return np.fromfile(path, np.float32).reshape(-1, self.dim)

    def __call__(self, sample: Sample) -> Sample:
        if sample.modality not in ("lidar", "multimodal"):
            raise ValueError(
                "LoadPointCloud requires lidar/multimodal modality")
        if sample.data is not None:
            raise ValueError("sample.data already set")

        data = self._read(sample.path)
        if self.use_dim is not None:
            data = data[:, self.use_dim]
        if self.use_time_lag:
            data = np.hstack(
                [data, np.zeros((data.shape[0], 1), data.dtype)])

        if len(sample.sweeps) > 0:
            parts = [data]
            order = rng_of(sample).choice(
                len(sample.sweeps), len(sample.sweeps), replace=False)
            for i in order:
                sweep = sample.sweeps[i]
                sd = self._read(sweep.path)
                if self.use_dim is not None:
                    sd = sd[:, self.use_dim]
                # drop ego-close returns
                close = (np.abs(sd[:, 0]) < self.sweep_remove_radius) & \
                        (np.abs(sd[:, 1]) < self.sweep_remove_radius)
                sd = sd[~close]
                ref_from_curr = sweep.meta.get("ref_from_curr")
                if ref_from_curr is not None:
                    homo = np.hstack(
                        [sd[:, :3], np.ones((sd.shape[0], 1), sd.dtype)])
                    sd[:, :3] = (ref_from_curr @ homo.T).T[:, :3]
                if self.use_time_lag:
                    sd = np.hstack([
                        sd,
                        np.full((sd.shape[0], 1), sweep.meta.time_lag,
                                sd.dtype)
                    ])
                parts.append(sd)
            data = np.concatenate(parts, axis=0)

        sample.data = PointCloud(data)
        return sample


@manager.TRANSFORMS.add_component
class RemoveCameraInvisiblePointsKITTI(TransformABC):
    """Keep only points inside the front-camera frustum
    (reference: reader.py:172): project the points to the image plane and
    keep those in front of the camera and inside the image."""

    def __call__(self, sample: Sample) -> Sample:
        calibs = sample.calibs
        P2, R0, V2C = calibs[2], calibs[4], calibs[5]
        img_shape = sample.meta.get("image_shape")  # (h, w)
        if img_shape is None:
            return sample
        h, w = img_shape
        pts = np.asarray(sample.data)
        # lidar -> rect camera
        homo = np.hstack([pts[:, :3], np.ones((pts.shape[0], 1), np.float32)])
        cam = (R0 @ V2C @ homo.T).T  # [N, 3]
        # rect -> image
        cam_h = np.hstack([cam, np.ones((cam.shape[0], 1), np.float32)])
        img_pts = (P2 @ cam_h.T).T
        depth = img_pts[:, 2]
        u = img_pts[:, 0] / np.maximum(depth, 1e-6)
        v = img_pts[:, 1] / np.maximum(depth, 1e-6)
        keep = (depth > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        sample.data = PointCloud(pts[keep])
        return sample


@manager.TRANSFORMS.add_component
class RemoveCameraInvisiblePointsKITTIV2(RemoveCameraInvisiblePointsKITTI):
    """V2 (reference: reader.py:204): the same frustum test, with the
    nominal KITTI image size when the sample carries no image_shape."""

    def __call__(self, sample: Sample) -> Sample:
        if sample.meta.get("image_shape") is None:
            sample.meta.image_shape = (375, 1242)
        return super().__call__(sample)


@manager.TRANSFORMS.add_component
class LoadMapsFromFiles(TransformABC):
    """The precomputed BEV map masks of a key frame (reference:
    reader.py:154): sample.meta.map_filename (set by NuscenesMVSegDataset)
    is an npz whose `key` holds [H, W, C] binary masks (drivable / lane /
    vehicle); they ride as sample.gt_semantic_map, float32 in {0, 1}."""

    def __init__(self, key: str = "arr_0"):
        self.key = key

    def __call__(self, sample: Sample) -> Sample:
        with np.load(sample.meta.map_filename) as maps:
            sample.gt_semantic_map = maps[self.key].astype(np.float32)
        return sample
