"""Lift-Splat-Shoot view transformer, torch port of
paddle3d_tpu/models/transformers/bevdet_transformer.py (LSSViewTransformer;
the BEVDepth variants below it wait for RTEBev, ROADMAP.md, queue 1, item
9).

A 1 x 1 depth net gives each feature-map pixel of each camera a softmax
over D depth bins and C context channels; every (camera, bin, pixel) cell
of the frustum is lifted through the camera matrices into the ego frame,
and the BEV cell its point falls in sums depth weight x context feature
(ops/scatter.bev_pool_sorted: the scalar payloads sorted, the rows rebuilt
by a gather, reduced on the card by K7 for a dense scan or K2 for a sparse
one, with K5 as its VJP). Features arrive NCHW per camera, [B, N, C, h, w];
the pooled table leaves NHWC [B, gy, gx, C], as in the JAX package; the
depth probabilities leave [B, N, D, h, w].

The frustum's voxel indices are floors of computed values: get_lidar_coor
computes the points in the arithmetic XLA compiles the JAX function to
under jit on the CPU (ops/xla_arith: the linspace, the 3 x 3 inverses,
the einsums' sums and fused multiply-adds, the reciprocal of the voxel
size), elementwise, so that the card gives the CPU's bits and a point on a
voxel face lands in the JAX package's cell.
"""
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from ...apis import manager
from ...ops import xla_arith
from ...ops.scatter import bev_pool_sorted
from ..layers.layer_libs import (default_generator, uniform_bias_init,
                                 uniform_init)

__all__ = ["LSSViewTransformer"]


@manager.TRANSFORMERS.add_component
class LSSViewTransformer(nn.Module):
    def __init__(self,
                 grid_config: Dict,
                 input_size: Sequence[int],
                 downsample: int = 16,
                 in_channels: int = 512,
                 out_channels: int = 64,
                 generator: torch.Generator = None):
        super().__init__()
        self.grid_config = grid_config
        self.downsample = downsample
        self.out_channels = out_channels
        xs, ys, zs = grid_config["x"], grid_config["y"], grid_config["z"]
        self.grid_lower = (float(xs[0]), float(ys[0]), float(zs[0]))
        self.grid_interval = (float(xs[2]), float(ys[2]), float(zs[2]))
        self.grid_size = tuple(
            int(round((c[1] - c[0]) / c[2])) for c in (xs, ys, zs))
        h_in, w_in = input_size
        self.input_size = (int(h_in), int(w_in))
        self.h_feat, self.w_feat = h_in // downsample, w_in // downsample
        d0, d1, dd = grid_config["depth"]
        self.depth_cfg = (float(d0), float(d1), float(dd))
        self.D = len(np.arange(d0, d1, dd))

        self.depth_net = nn.utils.skip_init(
            nn.Conv2d, in_channels, self.D + out_channels, 1)
        generator = default_generator(generator)
        uniform_init(self.depth_net.weight, generator)
        uniform_bias_init(self.depth_net.bias, in_channels, generator)

    def get_lidar_coor(self, rots, trans, cam2imgs, post_rots, post_trans,
                       bda):
        """The frustum in the ego (lidar) frame: rots [B, N, 3, 3] and
        trans [B, N, 3] camera -> ego, cam2imgs [B, N, 3, 3] intrinsics,
        post_rots [B, N, 3, 3] and post_trans [B, N, 3] the image
        augmentation, bda [B, 3, 3] the BEV augmentation -> [B, N, D, h,
        w, 3], the point of depth bin d at feature pixel (i, j)."""
        dtype, dev = rots.dtype, rots.device
        h_in, w_in = self.input_size
        d0, d1, dd = self.depth_cfg
        h, w, n_d = self.h_feat, self.w_feat, self.D
        depths = torch.arange(d0, d1, dd, dtype=torch.float32).to(dtype)
        shape = (n_d, h, w)
        frustum = [
            xla_arith.jax_linspace(w_in - 1, w, dtype)[None, None, :]
            .expand(shape),
            xla_arith.jax_linspace(h_in - 1, h, dtype)[None, :, None]
            .expand(shape),
            depths[:, None, None].expand(shape)]

        def per_cam(t):             # [B, N, ...] -> [B, N, 1, 1, 1, ...]
            return t[:, :, None, None, None]

        pts = [frustum[a].to(dev) - per_cam(post_trans[..., a])
               for a in range(3)]
        pts = xla_arith.matvec3(per_cam(xla_arith.inv3(post_rots)), pts,
                                False)
        # (u, v, d) -> (u d, v d, d)
        pts = [pts[0] * pts[2], pts[1] * pts[2], pts[2]]
        combine = xla_arith.matmul3(rots, xla_arith.inv3(cam2imgs))
        pts = xla_arith.matvec3(per_cam(combine), pts, False)
        pts = [pts[a] + per_cam(trans[..., a]) for a in range(3)]
        pts = xla_arith.matvec3(bda[:, None, None, None, None], pts,
                                rots.shape[0] > 1)
        return torch.stack(pts, dim=-1)

    def frustum_ranks(self, rots, trans, cam2imgs, post_rots, post_trans,
                      bda):
        """-> (rank [B, N, D, h, w] int32, y * gx + x of the BEV cell of
        each frustum point, z collapsed; valid [B, N, D, h, w] bool, inside
        the voxel grid)."""
        coor = self.get_lidar_coor(rots, trans, cam2imgs, post_rots,
                                   post_trans, bda)
        vox = []
        for a in range(3):
            cell = torch.floor((coor[..., a] - self.grid_lower[a]) *
                               xla_arith.reciprocal(self.grid_interval[a],
                                                    coor))
            # far points saturate past the grid rather than wrap
            vox.append(cell.clamp(-1, self.grid_size[a]).to(torch.int32))
        valid = torch.ones_like(vox[0], dtype=torch.bool)
        for a in range(3):
            valid &= (vox[a] >= 0) & (vox[a] < self.grid_size[a])
        return vox[1] * self.grid_size[0] + vox[0], valid

    def depth_and_context(self, x):
        """x [B, N, Cin, h, w] -> (depth probabilities [B, N, D, h, w],
        context [B, N, C, h, w])."""
        b, n = x.shape[:2]
        out = self.depth_net(x.reshape((b * n,) + tuple(x.shape[2:])))
        out = out.reshape((b, n) + tuple(out.shape[1:]))
        return torch.softmax(out[:, :, :self.D], dim=2), out[:, :, self.D:]

    def forward(self, x, rots, trans, cam2imgs, post_rots, post_trans,
                bda):
        """x [B, N, Cin, h, w] -> (bev [B, gy, gx, C] NHWC, depth [B, N,
        D, h, w])."""
        depth, feat = self.depth_and_context(x)
        return self.lift_splat(depth, feat, rots, trans, cam2imgs,
                               post_rots, post_trans, bda), depth

    def pool_inputs(self, depth, feat, rots, trans, cam2imgs, post_rots,
                    post_trans, bda):
        """depth [B, N, D, h, w], feat [B, N, C, h, w] and the matrices ->
        bev_pool_sorted's arguments but the cell count: the NHWC table
        [B, N*h*w, C], the pixel [B, N*D*h*w] int32, the depth weight,
        the rank and valid of every frustum row, in (camera, bin, y, x)
        order."""
        b, n, c, h, w = feat.shape
        rank, valid = self.frustum_ranks(rots, trans, cam2imgs, post_rots,
                                         post_trans, bda)
        feat_tab = feat.permute(0, 1, 3, 4, 2).reshape(b, n * h * w, c)
        pix = torch.arange(n * h * w, dtype=torch.int32,
                           device=feat.device).reshape(1, n, 1, h, w)
        pix = pix.expand(b, n, self.D, h, w).reshape(b, -1)
        return (feat_tab, pix, depth.reshape(b, -1), rank.reshape(b, -1),
                valid.reshape(b, -1))

    def lift_splat(self, depth, feat, rots, trans, cam2imgs, post_rots,
                   post_trans, bda):
        """depth [B, N, D, h, w] probabilities, feat [B, N, C, h, w] ->
        the pooled BEV [B, gy, gx, C] (NHWC)."""
        gx, gy, _ = self.grid_size
        bev = bev_pool_sorted(*self.pool_inputs(
            depth, feat, rots, trans, cam2imgs, post_rots, post_trans, bda),
            gy * gx)
        return bev.reshape(feat.shape[0], gy, gx, self.out_channels)
