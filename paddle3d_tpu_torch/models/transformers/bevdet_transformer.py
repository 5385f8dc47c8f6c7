"""Lift-Splat-Shoot view transformers, torch port of
paddle3d_tpu/models/transformers/bevdet_transformer.py (LSSViewTransformer,
and the BEVDepth variants: DepthNet, MSDepthNet,
LSSViewTransformerBEVDepth, MSLSSViewTransformerBEVDepth).

A 1 x 1 depth net gives each feature-map pixel of each camera a softmax
over D depth bins and C context channels; every (camera, bin, pixel) cell
of the frustum is lifted through the camera matrices into the ego frame,
and the BEV cell its point falls in sums depth weight x context feature
(ops/scatter.bev_pool_sorted: the scalar payloads sorted, the rows rebuilt
by a gather, reduced on the card by K7 for a dense scan or K2 for a sparse
one, with K5 as its VJP). Features arrive NCHW per camera, [B, N, C, h, w];
the pooled table leaves NHWC [B, gy, gx, C], as in the JAX package; the
depth probabilities leave [B, N, D, h, w].

The BEVDepth variants replace the 1 x 1 depth net by one conditioned on
the camera: 27 camera terms (intrinsics, image and BEV augmentation,
camera -> ego) through a BatchNorm and two MLPs gate the context and the
depth features channel by channel (squeeze-excitation), and the depth
branch runs residual blocks (and a simplified SPPF); the multi-scale one
(RTEBev's) takes the depth from the two coarser FPN levels, upsampled
twice, and the context from the finest. Both supervise the depth with a
BCE against the LiDAR depth's per-patch minimum, binned and one-hot.

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
import torch.nn.functional as F
from torch import nn

from ...apis import manager
from ...ops import xla_arith
from ...ops.scatter import bev_pool_sorted
from ..layers.layer_libs import (BatchNorm2d, default_generator,
                                 lecun_normal_, uniform_bias_init,
                                 uniform_init)
from .transformer_layers import linear

__all__ = ["LSSViewTransformer", "DepthNet", "MSDepthNet",
           "LSSViewTransformerBEVDepth", "MSLSSViewTransformerBEVDepth"]


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


# --------------------------------------------------------------------------
# BEVDepth: the camera-conditioned depth nets and the depth supervision.
# nnx.Conv and nnx.Linear defaults: lecun-normal kernels, zero biases;
# nnx.BatchNorm: eps 1e-5, flax momentum 0.99 (torch 0.01).


def _conv(cin, cout, k, bias, generator):
    """nnx.Conv(cin, cout, (k, k)), SAME at stride 1: k // 2 a side."""
    conv = nn.utils.skip_init(nn.Conv2d, cin, cout, k, padding=k // 2,
                              bias=bias)
    lecun_normal_(conv.weight, generator)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


def _bn(c):
    return BatchNorm2d(c, eps=1e-5, momentum=0.01)


class CameraBatchNorm(nn.BatchNorm1d):
    """nnx.BatchNorm over the [B*N, 27] camera terms, in flax's arithmetic:
    the batch variance as max(0, E[x^2] - E[x]^2) (use_fast_variance), the
    running stats updated with it (flax momentum 0.99), and x - mean times
    rsqrt(var + eps) * scale, plus bias, in either mode. Most columns are
    the same for every camera, so their batch variance is cancellation
    noise and the normalised column is that noise; this form gives the
    JAX package's noise where torch's two-pass variance gives another."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.01)

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=0)
            var = ((x * x).mean(dim=0) - mean * mean).clamp(min=0.)
            with torch.no_grad():
                keep = 1.0 - self.momentum
                self.running_mean.copy_(keep * self.running_mean +
                                        self.momentum * mean)
                self.running_var.copy_(keep * self.running_var +
                                       self.momentum * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + \
            self.bias


class _Mlp(nn.Module):
    def __init__(self, in_f, hid, out, generator):
        super().__init__()
        self.fc1 = linear(in_f, hid, generator)
        self.fc2 = linear(hid, out, generator)

    def forward(self, x):
        return self.fc2(torch.relu(self.fc1(x)))


class _SELayer(nn.Module):
    """A channel gate from an external term (its 1 x 1 convs, on a
    vector, are linears)."""

    def __init__(self, channels, generator):
        super().__init__()
        self.conv_reduce = linear(channels, channels, generator)
        self.conv_expand = linear(channels, channels, generator)

    def forward(self, x, x_se):
        """x [BN, C, h, w]; x_se [BN, C]."""
        g = self.conv_expand(torch.relu(self.conv_reduce(x_se)))
        return x * torch.sigmoid(g)[:, :, None, None]


class _BasicBlock(nn.Module):
    """Two 3 x 3 conv-BN (the first with a ReLU) and the identity skip."""

    def __init__(self, channels, generator):
        super().__init__()
        self.conv1 = _conv(channels, channels, 3, False, generator)
        self.bn1 = _bn(channels)
        self.conv2 = _conv(channels, channels, 3, False, generator)
        self.bn2 = _bn(channels)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(x + self.bn2(self.conv2(y)))


class _SimSPPF(nn.Module):
    """Simplified SPPF: 1 x 1 reduce, three stacked 5 x 5 / 1 max pools
    (-inf padding), the four maps concatenated, 1 x 1 expand."""

    def __init__(self, in_channels, out_channels, generator, kernel_size=5):
        super().__init__()
        c_ = in_channels // 2
        self.k = kernel_size
        self.cv1 = _conv(in_channels, c_, 1, False, generator)
        self.bn1 = _bn(c_)
        self.cv2 = _conv(c_ * 4, out_channels, 1, False, generator)
        self.bn2 = _bn(out_channels)

    def forward(self, x):
        x = torch.relu(self.bn1(self.cv1(x)))
        ys = [x]
        for _ in range(3):
            ys.append(F.max_pool2d(ys[-1], self.k, 1, self.k // 2))
        return torch.relu(self.bn2(self.cv2(torch.cat(ys, dim=1))))


class _DepthNetBase(nn.Module):
    """The parts both depth nets share: the reduce conv, the context conv,
    the camera BatchNorm and the two MLP-gated SE layers."""

    def __init__(self, in_channels, mid_channels, context_channels,
                 generator):
        super().__init__()
        self.reduce_conv = _conv(in_channels, mid_channels, 3, False,
                                 generator)
        self.reduce_bn = _bn(mid_channels)
        self.context_conv = _conv(mid_channels, context_channels, 1, True,
                                  generator)
        self.bn = CameraBatchNorm(27)
        self.depth_mlp = _Mlp(27, mid_channels, mid_channels, generator)
        self.depth_se = _SELayer(mid_channels, generator)
        self.context_mlp = _Mlp(27, mid_channels, mid_channels, generator)
        self.context_se = _SELayer(mid_channels, generator)


class DepthNet(_DepthNetBase):
    """BEVDepth's depth / context net: x [BN, Cin, h, w], mlp_input [BN,
    27] -> (depth logits [BN, D, h, w], context [BN, C, h, w])."""

    def __init__(self, in_channels, mid_channels, context_channels,
                 depth_channels, use_aspp=False, use_sppf=False,
                 use_dcn=False, generator: torch.Generator = None):
        generator = default_generator(generator)
        super().__init__(in_channels, mid_channels, context_channels,
                         generator)
        blocks = [_BasicBlock(mid_channels, generator) for _ in range(3)]
        if use_aspp or use_sppf:
            blocks.append(_SimSPPF(mid_channels, mid_channels, generator))
        self.depth_blocks = nn.ModuleList(blocks)
        self.depth_out = _conv(mid_channels, depth_channels, 1, True,
                               generator)

    def forward(self, x, mlp_input):
        mlp_input = self.bn(mlp_input)
        x = torch.relu(self.reduce_bn(self.reduce_conv(x)))
        context = self.context_conv(self.context_se(
            x, self.context_mlp(mlp_input)))
        depth = self.depth_se(x, self.depth_mlp(mlp_input))
        for blk in self.depth_blocks:
            depth = blk(depth)
        return self.depth_out(depth), context


def _up2(x):
    """2x bilinear upsampling (jax.image.resize's half-pixel centres)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


class MSDepthNet(_DepthNetBase):
    """The multi-scale depth net: the depth from the two coarser FPN
    levels (the coarsest SE-gated, a block and SPPF, upsampled and added
    to the middle one, two blocks, the bin conv, upsampled again), the
    context from the finest. x_high / x_mid / x_low [BN, C, h, w] at
    strides s, 2s, 4s -> (depth logits [BN, D, h, w], context [BN, Cout,
    h, w]) at stride s."""

    def __init__(self, in_channels, mid_channels, context_channels,
                 depth_channels, use_aspp=False, use_sppf=True,
                 use_dcn=False, generator: torch.Generator = None):
        generator = default_generator(generator)
        super().__init__(in_channels, mid_channels, context_channels,
                         generator)
        low = [_BasicBlock(mid_channels, generator)]
        if use_sppf:
            low.append(_SimSPPF(mid_channels, mid_channels, generator))
        self.depth_conv_low = nn.ModuleList(low)
        self.depth_conv_mid = nn.ModuleList(
            [_BasicBlock(mid_channels, generator) for _ in range(2)])
        self.depth_out = _conv(mid_channels, depth_channels, 1, True,
                               generator)

    def forward(self, x_high, x_mid, x_low, mlp_input):
        mlp_input = self.bn(mlp_input)
        x_high = torch.relu(self.reduce_bn(self.reduce_conv(x_high)))
        depth = self.depth_se(x_low, self.depth_mlp(mlp_input))
        for blk in self.depth_conv_low:
            depth = blk(depth)
        depth = x_mid + _up2(depth)
        for blk in self.depth_conv_mid:
            depth = blk(depth)
        depth = _up2(self.depth_out(depth))
        context = self.context_se(x_high, self.context_mlp(mlp_input))
        return depth, self.context_conv(context)


class _BEVDepthMixin:
    """The camera terms and the depth supervision of the BEVDepth view
    transformers."""

    def get_mlp_input(self, rots, trans, cam2imgs, post_rots, post_trans,
                      bda):
        """-> [B*N, 27]: fx, fy, cx, cy, the image augmentation's 2 x 3,
        the BEV augmentation's 2 x 2 and z scale, camera -> ego [3, 4]."""
        b, n = rots.shape[:2]
        bda_t = bda[:, None].expand(b, n, 3, 3)
        cols = torch.stack([
            cam2imgs[:, :, 0, 0], cam2imgs[:, :, 1, 1],
            cam2imgs[:, :, 0, 2], cam2imgs[:, :, 1, 2],
            post_rots[:, :, 0, 0], post_rots[:, :, 0, 1],
            post_trans[:, :, 0],
            post_rots[:, :, 1, 0], post_rots[:, :, 1, 1],
            post_trans[:, :, 1],
            bda_t[:, :, 0, 0], bda_t[:, :, 0, 1],
            bda_t[:, :, 1, 0], bda_t[:, :, 1, 1], bda_t[:, :, 2, 2]],
            dim=-1)
        sensor2ego = torch.cat([rots, trans[..., None]], dim=-1).reshape(
            b, n, 12)
        return torch.cat([cols, sensor2ego], dim=-1).reshape(b * n, 27)

    def get_downsampled_gt_depth(self, gt_depths):
        """gt_depths [B, N, H, W] metric depth at the input resolution (0:
        no return) -> [B*N*h*w, D] one-hot bins at the feature stride, in
        (camera, y, x) order: each patch's nearest return, binned by
        floor((g - (d0 - dd)) / dd); bin 0 and bins past D are no label
        (all zeros)."""
        b, n, hh, ww = gt_depths.shape
        s = self.downsample
        g = gt_depths.reshape(b * n, hh // s, s, ww // s, s)
        g = torch.where(g == 0.0, 1e5, g).amin(dim=(2, 4))
        d0, _, dd = self.depth_cfg
        g = (g - (d0 - dd)) * xla_arith.reciprocal(dd, g)
        g = torch.where((g < self.D + 1) & (g >= 0.0), g, 0.0)
        onehot = F.one_hot(g.to(torch.int64).reshape(-1), self.D + 1)
        return onehot[:, 1:].to(gt_depths.dtype)

    def get_depth_loss(self, gt_depths, depth_preds):
        """gt_depths [B, N, H, W]; depth_preds [B, N, D, h, w]
        probabilities -> loss_depth_weight x the BCE summed over the
        labelled pixels' bins over their count."""
        labels = self.get_downsampled_gt_depth(gt_depths)
        preds = depth_preds.permute(0, 1, 3, 4, 2).reshape(-1, self.D)
        fg = labels.amax(dim=1) > 0.0
        p = preds.clamp(1e-6, 1 - 1e-6)
        bce = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))
        bce = torch.where(fg[:, None], bce, 0.0)
        return self.loss_depth_weight * bce.sum() / fg.sum().clamp(min=1)

    def forward(self, x, rots, trans, cam2imgs, post_rots, post_trans,
                bda, mlp_input=None):
        """x: the view transformer's input (see depth_and_context) and the
        camera matrices -> (bev [B, gy, gx, C] NHWC, depth [B, N, D, h,
        w])."""
        if mlp_input is None:
            mlp_input = self.get_mlp_input(rots, trans, cam2imgs, post_rots,
                                           post_trans, bda)
        depth, feat = self.depth_and_context(x, mlp_input)
        return self.lift_splat(depth, feat, rots, trans, cam2imgs,
                               post_rots, post_trans, bda), depth


def _probs_and_context(dep, feat, b, n):
    dep = torch.softmax(dep, dim=1)
    return (dep.reshape((b, n) + tuple(dep.shape[1:])),
            feat.reshape((b, n) + tuple(feat.shape[1:])))


@manager.TRANSFORMERS.add_component
class LSSViewTransformerBEVDepth(_BEVDepthMixin, LSSViewTransformer):
    """LSS with the camera-conditioned DepthNet and depth supervision."""

    def __init__(self, *args, loss_depth_weight=3.0, depthnet_cfg=None,
                 generator: torch.Generator = None, **kwargs):
        generator = default_generator(generator)
        super().__init__(*args, generator=generator, **kwargs)
        in_channels = kwargs.get("in_channels", 512)
        self.loss_depth_weight = float(loss_depth_weight)
        self.depth_net = DepthNet(in_channels, in_channels,
                                  self.out_channels, self.D,
                                  **dict(depthnet_cfg or {}),
                                  generator=generator)

    def depth_and_context(self, x, mlp_input):
        """x [B, N, Cin, h, w] (or a list of levels: the first), mlp_input
        [B*N, 27] -> (depth probabilities [B, N, D, h, w], context [B, N,
        C, h, w])."""
        if isinstance(x, (list, tuple)):
            x = x[0]
        b, n = x.shape[:2]
        dep, feat = self.depth_net(x.reshape((b * n,) + tuple(x.shape[2:])),
                                   mlp_input.to(x.dtype))
        return _probs_and_context(dep, feat, b, n)


@manager.TRANSFORMERS.add_component
class MSLSSViewTransformerBEVDepth(_BEVDepthMixin, LSSViewTransformer):
    """The multi-scale-depth LSS, RTEBev's view transformer: it takes the
    three FPN levels."""

    def __init__(self, *args, loss_depth_weight=1.0, depthnet_cfg=None,
                 generator: torch.Generator = None, **kwargs):
        generator = default_generator(generator)
        super().__init__(*args, generator=generator, **kwargs)
        in_channels = kwargs.get("in_channels", 256)
        self.loss_depth_weight = float(loss_depth_weight)
        self.depth_net = MSDepthNet(in_channels, in_channels,
                                    self.out_channels, self.D,
                                    **dict(depthnet_cfg or {}),
                                    generator=generator)

    def depth_and_context(self, feats, mlp_input):
        """feats: three levels [B, N, C, h_i, w_i] at strides s, 2s, 4s,
        mlp_input [B*N, 27] -> (depth probabilities [B, N, D, h, w],
        context [B, N, C, h, w]) at stride s."""
        b, n = feats[0].shape[:2]
        flat = [f.reshape((b * n,) + tuple(f.shape[2:])) for f in feats]
        dep, feat = self.depth_net(*flat, mlp_input.to(feats[0].dtype))
        return _probs_and_context(dep, feat, b, n)
