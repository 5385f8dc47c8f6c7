"""Bounding-box structures and host-side geometry, a numpy copy of
paddle3d_tpu/geometries/bbox.py (the port cannot import the JAX package,
whose __init__ imports jax): CoordMode, BBoxes2D, BBoxes3D, the rotations,
the convex-polygon and points-in-box tests, the rotated IoU the KITTI
evaluator uses, the collision test, SECOND's box coding and the KITTI
camera / lidar box conversions. They run on the host inside the data
loader's workers; the device counterparts live in ops/box_ops.py.
`BBoxes3D.masked_select` passes its attributes by keyword: the JAX one
raises (ROADMAP.md, section 3).
"""
from enum import Enum
from typing import List

import numpy as np

from .structure import _Structure

__all__ = [
    "CoordMode", "BBoxes2D", "BBoxes3D", "rotation_3d_in_axis",
    "points_in_convex_polygon_2d", "points_in_convex_polygon_3d",
    "box_collision_test", "circle_nms", "second_box_encode",
    "second_box_decode", "rbbox2d_to_near_bbox", "minmax_range_3d_to_corner_2d",
    "boxes3d_lidar_to_kitti_camera", "boxes3d_kitti_camera_to_lidar",
    "points_in_rbbox_bev", "rotated_iou_2d", "limit_period",
]


def limit_period(val, offset: float = 0.5, period: float = np.pi):
    """Wrap angle into [-offset*period, (1-offset)*period)."""
    return val - np.floor(val / period + offset) * period


class CoordMode(Enum):
    # x right / y down / z front (camera)
    KittiCamera = 0
    # x front / y left / z up
    KittiLidar = 1
    # x right / y front / z up
    NuScenesLidar = 2


class BBoxes2D(_Structure):
    """[N, 4] 2D boxes (x1 y1 x2 y2 or cx cy w h per-dataset convention)."""

    def __init__(self, data: np.ndarray):
        if self.ndim != 2 or self.shape[1] != 4:
            raise ValueError("Illegal 2D box data with shape {}".format(
                self.shape))

    def scale(self, factor: float):
        self[...] = self[...] * factor

    def translate(self, translation: np.ndarray):
        self[:, 0::2] += translation[0]
        self[:, 1::2] += translation[1]

    def horizontal_flip(self, image_width: float):
        # pixel-index flip: x -> W - 1 - x
        self[:, 0] = image_width - self[:, 0] - 1

    def horizontal_flip_coords(self, image_width: float):
        # float-coordinate flip: (x1, x2) -> (W - x2, W - x1)
        self[:, 0], self[:, 2] = image_width - self[:, 2], image_width - self[:, 0]

    def vertical_flip(self, image_height: float):
        self[:, 1] = image_height - self[:, 1] - 1

    def resize(self, h: int, w: int, newh: int, neww: int):
        self[:, 0::2] *= neww / w
        self[:, 1::2] *= newh / h


class BBoxes3D(_Structure):
    """[N, 7+] 3D boxes: (cx, cy, cz, dx, dy, dz, ..., yaw).

    Attributes mirror the reference: coordmode, velocities, origin
    (fractional anchor of the center within the box), rot_axis.
    """

    _copy_attrs = ("coordmode", "velocities", "origin", "rot_axis")

    def __init__(self,
                 data: np.ndarray,
                 coordmode: CoordMode = 0,
                 velocities: List[float] = None,
                 origin: List[float] = (0.5, 0.5, 0.5),
                 rot_axis: int = 2):
        self.coordmode = coordmode
        self.velocities = velocities
        self.origin = list(origin)
        self.rot_axis = rot_axis

    @property
    def corners_3d(self) -> np.ndarray:
        """[N, 8, 3]; corner order x0y0z0, x0y0z1, x0y1z1, x0y1z0,
        x1y0z0, x1y0z1, x1y1z1, x1y1z0 (matches the reference)."""
        arr = np.asarray(self)
        dims = arr[:, 3:6]
        # unit corner template in the fixed reference order
        ux = np.array([0., 0., 0., 0., 1., 1., 1., 1.], arr.dtype)
        uy = np.array([0., 0., 1., 1., 0., 0., 1., 1.], arr.dtype)
        uz = np.array([0., 1., 1., 0., 0., 1., 1., 0.], arr.dtype)
        unit = np.stack([ux, uy, uz], axis=-1)  # [8,3]
        origin = np.asarray(self.origin, arr.dtype)
        corners = (unit[None] - origin[None, None]) * dims[:, None, :]
        corners = rotation_3d_in_axis(corners, arr[:, -1], axis=self.rot_axis)
        return corners + arr[:, None, 0:3]

    @property
    def corners_2d(self) -> np.ndarray:
        """[N, 4, 2] BEV corners; order x0y0, x0y1, x1y1, x1y0."""
        arr = np.asarray(self)
        dims = arr[:, 3:5]
        ux = np.array([0., 0., 1., 1.], arr.dtype)
        uy = np.array([0., 1., 1., 0.], arr.dtype)
        unit = np.stack([ux, uy], axis=-1)  # [4,2]
        origin = np.asarray(self.origin[:2], arr.dtype)
        corners = (unit[None] - origin[None, None]) * dims[:, None, :]
        angle = arr[:, -1]
        c, s = np.cos(angle), np.sin(angle)
        rot = np.stack([np.stack([c, s], -1), np.stack([-s, c], -1)], -2)
        # row-vector convention: p' = p @ [[c, s], [-s, c]]
        corners = np.einsum("nij,njk->nik", corners, rot)
        return corners + arr[:, None, 0:2]

    def scale(self, factor: float):
        self[..., :-1] = self[..., :-1] * factor
        if self.velocities is not None:
            self.velocities[...] = self.velocities[...] * factor

    def translate(self, translation: np.ndarray):
        self[..., :3] = self[..., :3] + translation

    def rotate_around_z(self, angle: float):
        # CCW row-vector rotation: x' = c x - s y, y' = s x + c y —
        # consistent with corners_2d/3d so rotating a box by θ rotates its
        # footprint by θ.
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], dtype=self.dtype)
        self[..., :3] = self[..., :3] @ rot
        if self.velocities is not None:
            self.velocities[..., :2] = self.velocities[..., :2] @ rot[:2, :2]
        self[..., -1] += angle

    def horizontal_flip(self):
        self[:, 0] = -self[:, 0]
        if self.velocities is not None:
            self.velocities[:, 0] = -self.velocities[:, 0]
        self[:, -1] = -self[:, -1] + 2 * np.pi

    def vertical_flip(self):
        self[:, 1] = -self[:, 1]
        if self.velocities is not None:
            self.velocities[:, 1] = -self.velocities[:, 1]
        self[:, -1] = -self[:, -1] + np.pi

    limit_period = staticmethod(limit_period)

    def get_mask_of_bboxes_outside_range(
            self, point_cloud_range: np.ndarray) -> np.ndarray:
        bev = self.corners_2d  # [N,4,2]
        polygon = minmax_range_3d_to_corner_2d(np.asarray(point_cloud_range))
        mask = points_in_convex_polygon_2d(bev.reshape(-1, 2), polygon)
        return np.any(mask.reshape(-1, 4), axis=1)

    def get_mask_of_points_outside_range(self, points: np.ndarray) -> np.ndarray:
        surfaces = corner_to_surface_3d(self.corners_3d)
        return points_in_convex_polygon_3d(points[:, :3], surfaces).any(axis=1)

    def masked_select(self, mask) -> "BBoxes3D":
        """The boxes (and velocities) where mask holds. The JAX method
        passes its attributes by position, which `_Structure.__new__` does
        not take, and raises TypeError (ROADMAP.md, section 3)."""
        vel = self.velocities[mask] if self.velocities is not None else None
        return BBoxes3D(
            np.asarray(self)[mask], coordmode=self.coordmode, velocities=vel,
            origin=self.origin, rot_axis=self.rot_axis)


def rotation_3d_in_axis(points: np.ndarray, angles: np.ndarray,
                        axis: int = 2) -> np.ndarray:
    """Rotate [N, P, 3] points by per-row angles about a coordinate axis."""
    c, s = np.cos(angles), np.sin(angles)
    one, zero = np.ones_like(c), np.zeros_like(c)
    if axis == 2 or axis == -1:
        rot = np.stack([c, s, zero, -s, c, zero, zero, zero, one], -1)
    elif axis == 1:
        rot = np.stack([c, zero, -s, zero, one, zero, s, zero, c], -1)
    elif axis == 0:
        rot = np.stack([one, zero, zero, zero, c, s, zero, -s, c], -1)
    else:
        raise ValueError("axis must be in 0..2, got {}".format(axis))
    rot = rot.reshape(-1, 3, 3)
    return np.einsum("npj,njk->npk", points, rot)


def minmax_range_3d_to_corner_2d(point_cloud_range: np.ndarray) -> np.ndarray:
    """[xmin,ymin,zmin,xmax,ymax,zmax] -> one [1,4,2] BEV polygon (ccw)."""
    xmin, ymin, xmax, ymax = (point_cloud_range[0], point_cloud_range[1],
                              point_cloud_range[3], point_cloud_range[4])
    return np.array([[[xmin, ymin], [xmin, ymax], [xmax, ymax], [xmax, ymin]]],
                    dtype=np.float32)


def points_in_convex_polygon_2d(points: np.ndarray,
                                polygons: np.ndarray) -> np.ndarray:
    """[N,2] points x [M,V,2] convex polygons -> [N,M] containment mask.

    A point is inside iff the cross products against every edge share a sign.
    """
    # edge vectors: vertex -> next vertex
    nxt = np.roll(polygons, -1, axis=1)
    edges = nxt - polygons  # [M,V,2]
    # vector from vertex to point: [N,M,V,2]
    to_pt = points[:, None, None, :] - polygons[None]
    cross = edges[None, ..., 0] * to_pt[..., 1] - edges[None, ..., 1] * to_pt[..., 0]
    return np.all(cross >= 0, axis=-1) | np.all(cross <= 0, axis=-1)


def corner_to_surface_3d(corners: np.ndarray) -> np.ndarray:
    """[N,8,3] box corners -> [N,6,4,3] surfaces with outward normals.

    Corner order matches BBoxes3D.corners_3d.
    """
    idx = np.array([
        [0, 1, 2, 3],  # x0 face
        [7, 6, 5, 4],  # x1 face
        [0, 4, 5, 1],  # y0 face
        [3, 2, 6, 7],  # y1 face
        [0, 3, 7, 4],  # z0 face
        [1, 5, 6, 2],  # z1 face
    ])
    return corners[:, idx]  # [N,6,4,3]


def points_in_convex_polygon_3d(points: np.ndarray,
                                polygon_surfaces: np.ndarray) -> np.ndarray:
    """[N,3] points x [M,S,4,3] box surfaces -> [N,M] containment mask."""
    # surface normal from the first 3 vertices (pointing outward by
    # construction of corner_to_surface_3d)
    v0 = polygon_surfaces[:, :, 0]
    d1 = polygon_surfaces[:, :, 1] - v0
    d2 = polygon_surfaces[:, :, 2] - v0
    normals = np.cross(d1, d2)  # [M,S,3]
    # signed distance of each point to each surface plane
    rel = points[:, None, None, :] - v0[None]  # [N,M,S,3]
    sign = np.einsum("nmsk,msk->nms", rel, normals)
    return np.all(sign <= 0, axis=-1) | np.all(sign >= 0, axis=-1)


def points_in_rbbox_bev(points: np.ndarray, boxes: np.ndarray,
                        origin=(0.5, 0.5, 0.5)) -> np.ndarray:
    """[N,>=3] points x [M,7] boxes -> [N,M] mask (full 3D rotated-box test)."""
    bb = BBoxes3D(boxes.astype(np.float32), origin=list(origin))
    surfaces = corner_to_surface_3d(bb.corners_3d)
    in_poly = points_in_convex_polygon_3d(points[:, :3], surfaces)
    return in_poly


def _boxes_to_corners_bev_np(boxes: np.ndarray) -> np.ndarray:
    """[N,5] (cx,cy,dx,dy,yaw) -> [N,4,2] CCW corners (matches the device
    ops.box_ops.boxes_to_corners_bev)."""
    cx, cy, dx, dy, yaw = boxes.T
    ux = np.array([-0.5, 0.5, 0.5, -0.5], boxes.dtype)
    uy = np.array([-0.5, -0.5, 0.5, 0.5], boxes.dtype)
    x = ux[None] * dx[:, None]
    y = uy[None] * dy[:, None]
    c, s = np.cos(yaw), np.sin(yaw)
    rx = c[:, None] * x - s[:, None] * y + cx[:, None]
    ry = s[:, None] * x + c[:, None] * y + cy[:, None]
    return np.stack([rx, ry], axis=-1)


def rotated_iou_2d(boxes_a: np.ndarray, boxes_b: np.ndarray,
                   criterion: int = -1) -> np.ndarray:
    """[N,5] x [M,5] rotated boxes -> [N,M] exact IoU (numpy, vectorized
    Sutherland–Hodgman over all pairs — host analogue of the device
    ops.iou3d_nms.boxes_iou_bev; used by the KITTI evaluator).

    criterion: -1 IoU, 0 inter/area_a, 1 inter/area_b (KITTI devkit's
    DontCare overlap modes).
    """
    n, m = boxes_a.shape[0], boxes_b.shape[0]
    if n == 0 or m == 0:
        return np.zeros((n, m), np.float32)
    V = 8
    ca = _boxes_to_corners_bev_np(boxes_a.astype(np.float64))
    cb = _boxes_to_corners_bev_np(boxes_b.astype(np.float64))

    verts = np.zeros((n, m, V, 2))
    verts[:, :, :4] = ca[:, None]
    count = np.full((n, m), 4, np.int64)

    for e in range(4):
        a = cb[:, e]                      # [M,2]
        b = cb[:, (e + 1) % 4]            # [M,2]
        edge = (b - a)[None, :, None, :]  # [1,M,1,2]
        av = a[None, :, None, :]
        side = (edge[..., 0] * (verts[..., 1] - av[..., 1]) -
                edge[..., 1] * (verts[..., 0] - av[..., 0]))  # [N,M,V]
        idx = np.arange(V)
        nxt = np.where(idx[None, None] + 1 < count[..., None], idx + 1, 0)
        take = np.take_along_axis
        e_side = take(side, nxt, axis=2)
        e_vert = np.stack([
            take(verts[..., 0], nxt, axis=2),
            take(verts[..., 1], nxt, axis=2)
        ], axis=-1)
        s_in = side >= 0
        e_in = e_side >= 0
        denom = side - e_side
        t = side / np.where(denom == 0, 1e-12, denom)
        inter = verts + t[..., None] * (e_vert - verts)

        valid = idx[None, None] < count[..., None]
        emit0 = s_in & valid
        emit1 = (s_in != e_in) & valid
        n_emit = emit0.astype(np.int64) + emit1.astype(np.int64)
        offs = np.cumsum(n_emit, axis=2) - n_emit

        out = np.zeros_like(verts)
        flat = out.reshape(n * m, V, 2)
        pair = np.arange(n * m)[:, None]
        p0 = np.where(emit0, offs, V).reshape(n * m, V)
        p1 = np.where(emit1, offs + emit0, V).reshape(n * m, V)
        # scatter with a trash row at index V
        buf = np.zeros((n * m, V + 1, 2))
        buf[pair, p0] = verts.reshape(n * m, V, 2)
        buf2 = np.zeros((n * m, V + 1, 2))
        buf2[pair, p1] = inter.reshape(n * m, V, 2)
        mask0 = np.zeros((n * m, V + 1, 1), bool)
        mask0[pair, p0] = emit0.reshape(n * m, V, 1)
        flat_out = np.where(mask0, buf, buf2)[:, :V]
        verts = flat_out.reshape(n, m, V, 2)
        count = n_emit.sum(axis=2)

    idx = np.arange(V)
    nxt = np.where(idx[None, None] + 1 < count[..., None], idx + 1, 0)
    take = np.take_along_axis
    x, y = verts[..., 0], verts[..., 1]
    xn = take(x, nxt, axis=2)
    yn = take(y, nxt, axis=2)
    terms = np.where(idx[None, None] < count[..., None], x * yn - xn * y, 0.)
    inter_area = 0.5 * np.abs(terms.sum(axis=2))
    inter_area = np.where(count >= 3, inter_area, 0.)

    area_a = (boxes_a[:, 2] * boxes_a[:, 3])[:, None]
    area_b = (boxes_b[:, 2] * boxes_b[:, 3])[None, :]
    if criterion == 0:
        denom = area_a * np.ones_like(area_b)
    elif criterion == 1:
        denom = np.ones_like(area_a) * area_b
    else:
        denom = area_a + area_b - inter_area
    return (inter_area / np.maximum(denom, 1e-9)).astype(np.float32)


def box_collision_test(boxes: np.ndarray, qboxes: np.ndarray) -> np.ndarray:
    """[N,5] x [M,5] BEV rotated boxes (cx,cy,dx,dy,yaw) -> [N,M] overlap mask.

    Vectorized separating-axis test on the 4 edge normals of each box pair
    (exact for convex quads), replacing the reference's numba line-segment
    scan (reference: geometries/bbox.py:356).
    """
    def _corners(b):
        return BBoxes3D(
            np.concatenate([
                b[:, 0:2],
                np.zeros((b.shape[0], 1), b.dtype), b[:, 2:4],
                np.ones((b.shape[0], 1), b.dtype), b[:, 4:5]
            ], axis=1)).corners_2d

    c1 = _corners(boxes.astype(np.float32))  # [N,4,2]
    c2 = _corners(qboxes.astype(np.float32))  # [M,4,2]

    def _axes(c):
        e = np.roll(c, -1, axis=1) - c  # [K,4,2]
        n = np.stack([-e[..., 1], e[..., 0]], axis=-1)
        return n  # [K,4,2]

    axes = np.concatenate([
        np.broadcast_to(_axes(c1)[:, None], (c1.shape[0], c2.shape[0], 4, 2)),
        np.broadcast_to(_axes(c2)[None], (c1.shape[0], c2.shape[0], 4, 2)),
    ], axis=2)  # [N,M,8,2]
    p1 = np.einsum("nvk,nmak->nmav", c1, axes)  # [N,M,8,4]
    p2 = np.einsum("mvk,nmak->nmav", c2, axes)
    sep = (p1.max(-1) < p2.min(-1)) | (p2.max(-1) < p1.min(-1))  # [N,M,8]
    return ~np.any(sep, axis=-1)


def circle_nms(boxes: np.ndarray, min_radius: float,
               post_max_size: int = 83) -> np.ndarray:
    """Greedy center-distance NMS (reference: geometries/bbox.py:450).

    boxes: [N,3] = (x, y, score), pre-sorted by score descending.
    Returns kept indices.
    """
    n = boxes.shape[0]
    keep = []
    suppressed = np.zeros(n, dtype=bool)
    r2 = min_radius * min_radius
    for i in range(n):
        if suppressed[i]:
            continue
        keep.append(i)
        if len(keep) >= post_max_size:
            break
        d2 = ((boxes[i + 1:, 0] - boxes[i, 0])**2 +
              (boxes[i + 1:, 1] - boxes[i, 1])**2)
        suppressed[i + 1:] |= d2 <= r2
    return np.array(keep, dtype=np.int64)


def second_box_encode(boxes: np.ndarray, anchors: np.ndarray,
                      encode_angle_to_vector: bool = False,
                      smooth_dim: bool = False) -> np.ndarray:
    """SECOND-style residual encoding (reference: geometries/bbox.py:616).

    boxes/anchors: [N,7] (x,y,z,w,l,h,r); z is box-bottom convention with a
    diagonal-normalized xy residual and height-normalized z residual.
    """
    xa, ya, za, wa, la, ha, ra = np.split(anchors, 7, axis=-1)
    xg, yg, zg, wg, lg, hg, rg = np.split(boxes, 7, axis=-1)
    diag = np.sqrt(la**2 + wa**2)
    xt = (xg - xa) / diag
    yt = (yg - ya) / diag
    zt = (zg - za) / ha
    if smooth_dim:
        wt, lt, ht = wg / wa - 1, lg / la - 1, hg / ha - 1
    else:
        wt, lt, ht = np.log(wg / wa), np.log(lg / la), np.log(hg / ha)
    if encode_angle_to_vector:
        return np.concatenate(
            [xt, yt, zt, wt, lt, ht,
             np.cos(rg) - np.cos(ra),
             np.sin(rg) - np.sin(ra)], axis=-1)
    return np.concatenate([xt, yt, zt, wt, lt, ht, rg - ra], axis=-1)


def second_box_decode(encodings: np.ndarray, anchors: np.ndarray,
                      encode_angle_to_vector: bool = False,
                      smooth_dim: bool = False) -> np.ndarray:
    """Inverse of second_box_encode (reference: geometries/bbox.py:640)."""
    xa, ya, za, wa, la, ha, ra = np.split(anchors, 7, axis=-1)
    if encode_angle_to_vector:
        xt, yt, zt, wt, lt, ht, rtc, rts = np.split(encodings, 8, axis=-1)
    else:
        xt, yt, zt, wt, lt, ht, rt = np.split(encodings, 7, axis=-1)
    diag = np.sqrt(la**2 + wa**2)
    xg = xt * diag + xa
    yg = yt * diag + ya
    zg = zt * ha + za
    if smooth_dim:
        wg, lg, hg = (wt + 1) * wa, (lt + 1) * la, (ht + 1) * ha
    else:
        wg, lg, hg = np.exp(wt) * wa, np.exp(lt) * la, np.exp(ht) * ha
    if encode_angle_to_vector:
        rg = np.arctan2(rts + np.sin(ra), rtc + np.cos(ra))
    else:
        rg = rt + ra
    return np.concatenate([xg, yg, zg, wg, lg, hg, rg], axis=-1)


def rbbox2d_to_near_bbox(rbboxes: np.ndarray) -> np.ndarray:
    """[N,5] (cx,cy,dx,dy,yaw) -> [N,4] nearest axis-aligned (x1,y1,x2,y2)
    (reference: geometries/bbox.py:599): swap dx/dy when yaw is closer to 90°.
    """
    rots = np.abs(limit_period(rbboxes[:, -1], 0.5, np.pi))
    cond = (rots > np.pi / 4)[..., None]
    swapped = np.where(cond, rbboxes[:, [0, 1, 3, 2]], rbboxes[:, :4])
    centers, dims = swapped[:, :2], swapped[:, 2:4]
    return np.concatenate([centers - dims / 2, centers + dims / 2], axis=-1)


def boxes3d_lidar_to_kitti_camera(boxes_lidar: np.ndarray,
                                  calib_v2c: np.ndarray,
                                  calib_r0: np.ndarray) -> np.ndarray:
    """KITTI lidar box (x,y,z,w,l,h,r; z bottom) -> camera box (x,y,z,l,h,w,ry)
    (reference: geometries/bbox.py:816)."""
    xyz = boxes_lidar[:, 0:3].copy()
    w, l, h = boxes_lidar[:, 3:4], boxes_lidar[:, 4:5], boxes_lidar[:, 5:6]
    r = boxes_lidar[:, 6:7]
    pts = np.concatenate([xyz, np.ones((xyz.shape[0], 1), xyz.dtype)], axis=1)
    xyz_cam = (calib_r0 @ calib_v2c @ pts.T).T[:, :3]
    r_cam = -r - np.pi / 2
    return np.concatenate([xyz_cam, l, h, w, r_cam], axis=-1)


def boxes3d_kitti_camera_to_lidar(boxes_cam: np.ndarray,
                                  calib_v2c: np.ndarray,
                                  calib_r0: np.ndarray) -> np.ndarray:
    """Inverse of boxes3d_lidar_to_kitti_camera (reference: bbox.py:792)."""
    xyz = boxes_cam[:, 0:3]
    l, h, w = boxes_cam[:, 3:4], boxes_cam[:, 4:5], boxes_cam[:, 5:6]
    r = boxes_cam[:, 6:7]
    pts = np.concatenate([xyz, np.ones((xyz.shape[0], 1), xyz.dtype)], axis=1)
    inv = np.linalg.inv(calib_r0 @ calib_v2c)
    xyz_lidar = (inv @ pts.T).T[:, :3]
    r_lidar = -r - np.pi / 2
    return np.concatenate([xyz_lidar, w, l, h, r_lidar], axis=-1)
