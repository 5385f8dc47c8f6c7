"""SemanticKITTI range-image projection, the port's copy of
paddle3d_tpu/transforms/range_image.py (LoadSemanticKITTIRange).

A velodyne scan goes through a spherical projection to an [H, W] range
image of (range, x, y, z, remission) channels, HWC, written far first so
that the nearest return wins each pixel. `project_range` is that
projection on a points array: the serving path's input stage, and what the
transform (which reads `sample.path`) calls. Host code in numpy, as in the
JAX package: the same arithmetic, and ties at equal depth in
`np.argsort`'s order.
"""
import numpy as np

from ..apis import manager
from ..sample import Sample
from .base import TransformABC

__all__ = ["LoadSemanticKITTIRange", "project_range"]


def project_range(points: np.ndarray, remission: np.ndarray,
                  proj_H: int = 64, proj_W: int = 2048, fov_up: float = 3.0,
                  fov_down: float = -25.0, labels: np.ndarray = None):
    """points [N, 3] f32 and remission [N] -> dict of `data` [H, W, 5] f32
    (-1 where no point lands), `proj_mask` [H, W] bool, `proj_x` / `proj_y`
    [N] int32 (each point's pixel) and, given per-point labels,
    `proj_labels` [H, W] int32 (0 where no point lands)."""
    fov_up = fov_up * np.pi / 180
    fov_down = fov_down * np.pi / 180
    fov = abs(fov_up) + abs(fov_down)
    depth = np.linalg.norm(points, axis=1)
    yaw = -np.arctan2(points[:, 1], points[:, 0])
    pitch = np.arcsin(points[:, 2] / np.maximum(depth, 1e-6))

    px = 0.5 * (yaw / np.pi + 1.0) * proj_W
    py = (1.0 - (pitch + abs(fov_down)) / fov) * proj_H
    px = np.clip(np.floor(px), 0, proj_W - 1).astype(np.int32)
    py = np.clip(np.floor(py), 0, proj_H - 1).astype(np.int32)

    order = np.argsort(depth)[::-1]  # far first; near overwrites
    img = np.full((proj_H, proj_W, 5), -1, np.float32)
    img[py[order], px[order], 0] = depth[order]
    img[py[order], px[order], 1:4] = points[order]
    img[py[order], px[order], 4] = remission[order]
    out = {"data": img, "proj_mask": img[..., 0] > 0,
           "proj_x": px.copy(), "proj_y": py.copy()}
    if labels is not None:
        lab_img = np.zeros((proj_H, proj_W), np.int32)
        lab_img[py[order], px[order]] = labels[order]
        out["proj_labels"] = lab_img
    return out


@manager.TRANSFORMS.add_component
class LoadSemanticKITTIRange(TransformABC):
    """Read `sample.path` (a .bin of [N, 4] f32: x, y, z, remission) and
    set `data`, `proj_mask`, `proj_x`, `proj_y` and, where the sample
    carries per-point `labels` and project_label is set, `proj_labels`."""

    def __init__(self, project_label: bool = True, proj_H: int = 64,
                 proj_W: int = 2048, fov_up: float = 3.0,
                 fov_down: float = -25.0):
        self.proj_H = proj_H
        self.proj_W = proj_W
        self.fov_up = fov_up
        self.fov_down = fov_down
        self.project_label = project_label

    def __call__(self, sample: Sample) -> Sample:
        raw = np.fromfile(sample.path, np.float32).reshape(-1, 4)
        labels = getattr(sample, "labels", None)
        out = project_range(
            raw[:, :3], raw[:, 3], self.proj_H, self.proj_W, self.fov_up,
            self.fov_down, labels if self.project_label else None)
        for key, value in out.items():
            sample[key] = value
        return sample
