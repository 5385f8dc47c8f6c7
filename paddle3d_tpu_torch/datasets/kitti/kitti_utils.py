"""KITTI calibration / label parsing and coordinate transforms, a numpy
copy of paddle3d_tpu/datasets/kitti/kitti_utils.py (reference:
paddle3d/datasets/kitti/kitti_utils.py — same file format), with
`format_label_line`, the inverse of `parse_label_file`.

KITTI conventions:
  * labels live in the rectified camera frame: location = bottom-center
    (x right, y down, z forward), dimensions (h, w, l), rotation_y about
    the camera y axis;
  * lidar frame: x forward, y left, z up; our lidar boxes are
    (x, y, z_bottom, w, l, h, yaw) with yaw about +z.
Conversion used here: xyz_cam = R0 @ Tr_velo_to_cam @ xyz_lidar,
yaw_lidar = -ry - pi/2.
"""
import os
from typing import Dict, List

import numpy as np

KITTI_CLASSES = ("Car", "Cyclist", "Pedestrian", "Van", "Person_sitting",
                 "Truck", "Tram", "Misc", "DontCare")


class Calibration:
    """Parsed calib file: P0..P3 [3,4], R0_rect [3,3], Tr_velo_to_cam [3,4]."""

    def __init__(self, mats: Dict[str, np.ndarray]):
        self.P2 = mats["P2"].reshape(3, 4)
        self.P3 = mats.get("P3", self.P2).reshape(3, 4)
        self.R0 = mats["R0_rect"].reshape(3, 3)
        self.V2C = mats["Tr_velo_to_cam"].reshape(3, 4)

    @classmethod
    def from_file(cls, path: str) -> "Calibration":
        mats = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or ":" not in line:
                    continue
                key, vals = line.split(":", 1)
                mats[key.strip()] = np.array(
                    [float(v) for v in vals.split()], np.float32)
        return cls(mats)

    # 4x4 homogeneous versions
    @property
    def R0_4x4(self) -> np.ndarray:
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = self.R0
        return m

    @property
    def V2C_4x4(self) -> np.ndarray:
        m = np.eye(4, dtype=np.float32)
        m[:3, :4] = self.V2C
        return m

    def lidar_to_rect(self, pts: np.ndarray) -> np.ndarray:
        homo = np.hstack([pts[:, :3], np.ones((pts.shape[0], 1), np.float32)])
        return (self.R0_4x4 @ self.V2C_4x4 @ homo.T).T[:, :3]

    def rect_to_lidar(self, pts: np.ndarray) -> np.ndarray:
        homo = np.hstack([pts[:, :3], np.ones((pts.shape[0], 1), np.float32)])
        inv = np.linalg.inv(self.R0_4x4 @ self.V2C_4x4)
        return (inv @ homo.T).T[:, :3]

    def rect_to_img(self, pts_rect: np.ndarray):
        homo = np.hstack(
            [pts_rect, np.ones((pts_rect.shape[0], 1), np.float32)])
        proj = (self.P2 @ homo.T).T
        depth = proj[:, 2]
        uv = proj[:, :2] / np.maximum(depth[:, None], 1e-6)
        return uv, depth

    def as_matrices(self) -> List[np.ndarray]:
        """[P0..P3, R0, V2C] list used by Sample.calibs (P0/P1 ~ P2)."""
        return [self.P2, self.P2, self.P2, self.P3, self.R0, self.V2C]


def parse_label_file(path: str) -> Dict[str, np.ndarray]:
    """Parse a label_2 txt into columnar arrays."""
    names, trunc, occ, alpha, bbox, dims, loc, ry = \
        [], [], [], [], [], [], [], []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) < 15:
                    continue
                names.append(parts[0])
                trunc.append(float(parts[1]))
                occ.append(float(parts[2]))
                alpha.append(float(parts[3]))
                bbox.append([float(v) for v in parts[4:8]])
                dims.append([float(v) for v in parts[8:11]])  # h, w, l
                loc.append([float(v) for v in parts[11:14]])
                ry.append(float(parts[14]))
    return {
        "name": np.array(names),
        "truncated": np.array(trunc, np.float32),
        "occluded": np.array(occ, np.float32),
        "alpha": np.array(alpha, np.float32),
        "bbox": np.array(bbox, np.float32).reshape(-1, 4),
        "dimensions": np.array(dims, np.float32).reshape(-1, 3),
        "location": np.array(loc, np.float32).reshape(-1, 3),
        "rotation_y": np.array(ry, np.float32),
    }


def format_label_line(name: str, truncated: float, occluded: int,
                      alpha: float, bbox, dimensions, location,
                      rotation_y: float) -> str:
    """One label_2 line as `parse_label_file` reads it: name, truncation,
    occlusion, alpha, the 2-D box (x1, y1, x2, y2), dimensions (h, w, l),
    the bottom-centre location (x, y, z) and rotation_y."""
    vals = (alpha, *bbox, *dimensions, *location, rotation_y)
    return " ".join([name, "{:.2f}".format(truncated), str(int(occluded))] +
                    ["{:.6f}".format(float(v)) for v in vals])


def camera_anno_to_lidar_boxes(anno: Dict[str, np.ndarray],
                               calib: Calibration) -> np.ndarray:
    """Label rows -> [N, 7] lidar boxes (x, y, z_bottom, w, l, h, yaw)."""
    n = len(anno["name"])
    if n == 0:
        return np.zeros((0, 7), np.float32)
    loc = anno["location"]  # camera bottom-center
    h = anno["dimensions"][:, 0:1]
    w = anno["dimensions"][:, 1:2]
    l = anno["dimensions"][:, 2:3]
    xyz_lidar = calib.rect_to_lidar(loc)
    yaw = -anno["rotation_y"][:, None] - np.pi / 2
    return np.concatenate([xyz_lidar, w, l, h, yaw],
                          axis=1).astype(np.float32)


def lidar_boxes_to_camera_anno(boxes: np.ndarray,
                               calib: Calibration) -> Dict[str, np.ndarray]:
    """[N,7] lidar boxes -> camera-frame columns (location/dimensions/ry) +
    projected 2D bbox."""
    n = boxes.shape[0]
    if n == 0:
        return {
            "location": np.zeros((0, 3), np.float32),
            "dimensions": np.zeros((0, 3), np.float32),
            "rotation_y": np.zeros((0,), np.float32),
            "bbox": np.zeros((0, 4), np.float32),
        }
    loc_cam = calib.lidar_to_rect(boxes[:, :3])
    w, l, h = boxes[:, 3], boxes[:, 4], boxes[:, 5]
    ry = -boxes[:, 6] - np.pi / 2
    # project 3d corners for the 2D bbox
    from ...geometries import BBoxes3D
    bb = BBoxes3D(boxes, origin=[.5, .5, 0.])
    corners = bb.corners_3d.reshape(-1, 3)  # [N*8, 3] lidar
    rect = calib.lidar_to_rect(corners)
    uv, depth = calib.rect_to_img(rect)
    uv = uv.reshape(n, 8, 2)
    bbox2d = np.concatenate(
        [uv.min(axis=1), uv.max(axis=1)], axis=1).astype(np.float32)
    return {
        "location": loc_cam.astype(np.float32),
        "dimensions": np.stack([h, w, l], axis=1).astype(np.float32),
        "rotation_y": ry.astype(np.float32),
        "bbox": bbox2d,
    }


def compute_difficulty(bbox: np.ndarray, occluded: np.ndarray,
                       truncated: np.ndarray) -> np.ndarray:
    """Official difficulty buckets: 0 easy / 1 moderate / 2 hard / -1 none."""
    height = bbox[:, 3] - bbox[:, 1]
    easy = (height >= 40) & (occluded <= 0) & (truncated <= 0.15)
    moderate = (height >= 25) & (occluded <= 1) & (truncated <= 0.3)
    hard = (height >= 25) & (occluded <= 2) & (truncated <= 0.5)
    diff = np.full(len(height), -1, np.int32)
    diff[hard] = 2
    diff[moderate] = 1
    diff[easy] = 0
    return diff
