"""Minimal 3D pose math, a copy of paddle3d_tpu/utils/transform3d.py
(reference: paddle3d/utils/transform3d.py; replaces the pyquaternion
dependency)."""
import numpy as np

__all__ = ["quat_to_matrix", "quat_multiply", "quat_inverse", "quat_yaw",
           "make_transform", "invert_transform"]


def quat_to_matrix(q) -> np.ndarray:
    """[w, x, y, z] -> [3, 3] rotation matrix."""
    w, x, y, z = np.asarray(q, np.float64)
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1 - (xx + yy)],
    ], np.float64)


def quat_multiply(a, b) -> np.ndarray:
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def quat_inverse(q) -> np.ndarray:
    w, x, y, z = q
    n = w * w + x * x + y * y + z * z
    return np.array([w, -x, -y, -z]) / max(n, 1e-12)


def quat_yaw(q) -> float:
    """Heading angle of the x-axis after rotation (nuScenes convention)."""
    m = quat_to_matrix(q)
    return float(np.arctan2(m[1, 0], m[0, 0]))


def make_transform(translation, rotation_quat) -> np.ndarray:
    t = np.eye(4)
    t[:3, :3] = quat_to_matrix(rotation_quat)
    t[:3, 3] = translation
    return t


def invert_transform(t: np.ndarray) -> np.ndarray:
    inv = np.eye(4)
    r = t[:3, :3].T
    inv[:3, :3] = r
    inv[:3, 3] = -r @ t[:3, 3]
    return inv
