"""SSD-style anchor generation for PointPillars, torch port of
paddle3d_tpu/models/detection/pointpillars/anchors.py.

The anchor grid, its per-anchor match thresholds and its lattice
factorisation are built once in numpy at model-build time; the live-anchor mask from the dense occupancy map is a
batched torch function.
"""
import math
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ....geometries.bbox import rbbox2d_to_near_bbox

__all__ = ["AnchorGenerator"]


class AnchorGeneratorStride:
    """One class's anchor lattice."""

    def __init__(self,
                 sizes=(1.6, 3.9, 1.56),
                 anchor_strides=(0.4, 0.4, 1.0),
                 anchor_offsets=(0.2, -39.8, -1.78),
                 rotations=(0, math.pi / 2),
                 matched_threshold=-1,
                 unmatched_threshold=-1):
        self.sizes = np.asarray(sizes, np.float32).reshape(-1, 3)
        self.strides = list(map(float, anchor_strides))
        self.offsets = list(map(float, anchor_offsets))
        self.rotations = np.asarray(rotations, np.float32)
        self.match_threshold = float(matched_threshold)
        self.unmatch_threshold = float(unmatched_threshold)

    def generate(self, ny: int, nx: int) -> np.ndarray:
        """-> [ny, nx, n_size * n_rot, 7] anchors (x,y,z,w,l,h,rot)."""
        xs = (np.arange(nx, dtype=np.float32) * self.strides[0] +
              self.offsets[0])
        ys = (np.arange(ny, dtype=np.float32) * self.strides[1] +
              self.offsets[1])
        zs = np.float32(self.offsets[2])
        yy, xx = np.meshgrid(ys, xs, indexing="ij")  # [ny, nx]
        n_size = self.sizes.shape[0]
        n_rot = self.rotations.shape[0]
        out = np.zeros((ny, nx, n_size, n_rot, 7), np.float32)
        out[..., 0] = xx[:, :, None, None]
        out[..., 1] = yy[:, :, None, None]
        out[..., 2] = zs
        out[..., 3:6] = self.sizes[None, None, :, None, :]
        out[..., 6] = self.rotations[None, None, None, :]
        return out.reshape(ny, nx, n_size * n_rot, 7)


class AnchorGenerator:
    """Full multi-class anchor set + live occupancy mask."""

    def __init__(self,
                 output_stride_factor: int,
                 point_cloud_range: Sequence[float],
                 voxel_size: Sequence[float],
                 anchor_configs: List[dict],
                 anchor_area_threshold: float = 1):
        self.pc_range = np.asarray(point_cloud_range, np.float32)
        self.voxel_size = np.asarray(voxel_size, np.float32)
        self.grid_size = np.round(
            (self.pc_range[3:6] - self.pc_range[:3]) /
            self.voxel_size).astype(np.int64)
        self.anchor_area_threshold = float(anchor_area_threshold)

        gens = [AnchorGeneratorStride(**cfg) for cfg in anchor_configs]
        fm_ny = int(self.grid_size[1]) // output_stride_factor
        fm_nx = int(self.grid_size[0]) // output_stride_factor
        # per-location anchor order: (class, size, rot) — must match the
        # head's channel layout [K * code] at each spatial position
        per_class = [g.generate(fm_ny, fm_nx) for g in gens]
        anchors = np.concatenate(per_class, axis=2)  # [ny, nx, K, 7]
        self.num_anchors_per_loc = anchors.shape[2]
        self.anchors = anchors.reshape(-1, 7)
        # per-anchor target-assignment thresholds [A], in the same order
        self.matched_thresholds, self.unmatched_thresholds = (
            np.concatenate([np.full(a.shape[:3], getattr(g, attr), np.float32)
                            for g, a in zip(gens, per_class)],
                           axis=2).reshape(-1)
            for attr in ("match_threshold", "unmatch_threshold"))

        # Regular-lattice factorisation of the integral-image corner
        # lookups: anchor centres sit on a stride-s cell grid, so each
        # (anchor kind, corner) is the same translate of that grid and is
        # read with a strided slice of a replicate-padded integral image.
        # The ε snap keeps anchor edges that land exactly on a cell
        # boundary on one side despite ±1-ulp float jitter.
        bv = rbbox2d_to_near_bbox(self.anchors[:, [0, 1, 3, 4, 6]])
        k = self.num_anchors_per_loc
        eps = 1e-3
        uncl = np.zeros_like(bv, dtype=np.float64)
        for j in range(4):  # (x1, y1, x2, y2): axis j % 2
            uncl[:, j] = np.floor((bv[:, j].astype(np.float64) -
                                   self.pc_range[j % 2]) /
                                  self.voxel_size[j % 2] + eps)
        uncl = uncl.astype(np.int64).reshape(fm_ny, fm_nx, k, 4)
        sx = int(round(self.grid_size[0] / fm_nx))
        sy = int(round(self.grid_size[1] / fm_ny))
        base_x = np.arange(fm_nx, dtype=np.int64)[None, :, None] * sx
        base_y = np.arange(fm_ny, dtype=np.int64)[:, None, None] * sy
        offs = np.stack([uncl[..., 0] - base_x, uncl[..., 1] - base_y,
                         uncl[..., 2] - base_x, uncl[..., 3] - base_y],
                        axis=-1)  # [ny, nx, K, 4]
        if not np.all(offs == offs[:1, :1]):
            raise NotImplementedError(
                "anchor configs off a regular lattice take the JAX "
                "package's gather path, which is not ported (no config in "
                "configs/pointpillars needs it)")
        self._lattice = dict(
            offsets=offs[0, 0].astype(int),  # [K, 4] constant offsets
            sx=sx, sy=sy, fm_ny=fm_ny, fm_nx=fm_nx,
            pad=int(max(1, np.abs(offs).max() + 1)))

    def anchors_mask_dense(self, occupancy: torch.Tensor) -> torch.Tensor:
        """Live-anchor mask [B, A] from a dense [B, ny, nx] occupancy count
        map: anchors whose circumscribed BEV rect covers more than
        `anchor_area_threshold` occupied pillars."""
        dense = occupancy.to(torch.float32)
        integral = torch.cumsum(torch.cumsum(dense, dim=1), dim=2)
        lat = self._lattice
        p, sx, sy = lat["pad"], lat["sx"], lat["sy"]
        fm_ny, fm_nx = lat["fm_ny"], lat["fm_nx"]
        padded = F.pad(integral[:, None], (p, p, p, p), mode="replicate")[:, 0]

        def corner(ox, oy):
            return padded[:, p + oy:p + oy + (fm_ny - 1) * sy + 1:sy,
                          p + ox:p + ox + (fm_nx - 1) * sx + 1:sx]

        areas = []
        for k in range(self.num_anchors_per_loc):
            x1, y1, x2, y2 = (int(v) for v in lat["offsets"][k])
            areas.append(corner(x2, y2) - corner(x1, y2) - corner(x2, y1) +
                         corner(x1, y1))
        area = torch.stack(areas, dim=-1)  # [B, ny, nx, K]
        return (area > self.anchor_area_threshold).reshape(
            occupancy.shape[0], -1)
