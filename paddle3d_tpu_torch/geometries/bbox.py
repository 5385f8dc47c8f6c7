"""Host-side (numpy) box geometry the ported slice needs.

Port of the part of paddle3d_tpu/geometries/bbox.py that the anchor
generator reads.
"""
import numpy as np

__all__ = ["limit_period", "rbbox2d_to_near_bbox"]


def limit_period(val, offset: float = 0.5, period: float = np.pi):
    """Wrap angle into [-offset*period, (1-offset)*period)."""
    return val - np.floor(val / period + offset) * period


def rbbox2d_to_near_bbox(rbboxes: np.ndarray) -> np.ndarray:
    """[N,5] (cx,cy,dx,dy,yaw) -> [N,4] nearest axis-aligned (x1,y1,x2,y2):
    swap dx/dy when yaw is closer to 90°."""
    rots = np.abs(limit_period(rbboxes[:, -1], 0.5, np.pi))
    cond = (rots > np.pi / 4)[..., None]
    swapped = np.where(cond, rbboxes[:, [0, 1, 3, 2]], rbboxes[:, :4])
    centers, dims = swapped[:, :2], swapped[:, 2:4]
    return np.concatenate([centers - dims / 2, centers + dims / 2], axis=-1)
