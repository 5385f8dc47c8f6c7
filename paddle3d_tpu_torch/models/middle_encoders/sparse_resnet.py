"""Sparse 3-D middle encoders, torch port of
paddle3d_tpu/models/middle_encoders/sparse_resnet.py (SparseResNet3D,
SparseNet3D, stage_voxel_centers).

Fixed-capacity sparse tensors with per-stage capacities (from the voxel
rows of the entry point's cap: train or test); in eval every conv runs the
sparse conv kernel (ops/sparse_conv.py) with its BatchNorm and relu fused,
in train mode the gather route under autograd with batch-statistics BN
(layers/sparse_layers.py); the final stage goes to a dense [B, H, W, D * C]
BEV map (NHWC, z folded into channels D-major) through the differentiable
sorted segment sum (ops/sorted_scatter.py: K2 or K7 forward by the density
rule, the table gather K5 backward).
"""
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ...apis import manager
from ...ops import sorted_scatter
from ..layers.layer_libs import default_generator
from ..layers.sparse_layers import (MaskedBatchNorm, SparseBasicBlock,
                                    SparseConv3D, SparseTensor)

__all__ = ["SparseResNet3D", "SparseNet3D", "stage_voxel_centers"]


def _grid_from_range(point_cloud_range, voxel_size):
    pc = np.asarray(point_cloud_range, np.float32)
    vs = np.asarray(voxel_size, np.float32)
    g = np.round((pc[3:] - pc[:3]) / vs).astype(np.int64)
    # (D, H, W) = (z, y, x); +1 z padding like the reference grid (41 vs 40)
    return (int(g[2]) + 1, int(g[1]), int(g[0]))


class _ConvBNReLU(nn.Module):
    def __init__(self, cin, cout, kernel_size=3, stride=1, out_capacity=None,
                 generator=None):
        super().__init__()
        self.conv = SparseConv3D(cin, cout, kernel_size, stride,
                                 out_capacity=out_capacity, use_bias=False,
                                 generator=generator)
        self.bn = MaskedBatchNorm(cout)

    def forward(self, st: SparseTensor) -> SparseTensor:
        if self.training:
            out = self.conv(st)
            return out.replace_features(
                torch.relu(self.bn(out.features, out.mask)))
        s, b = self.bn.fold_affine()
        return self.conv(st, scale=s, shift=b, relu=True)


def stage_voxel_centers(st: SparseTensor, stride: int, voxel_size,
                        point_cloud_range) -> torch.Tensor:
    """World-frame centres of a stage's voxels: [B, V, 3] xyz (the stage
    lives on the base grid downsampled by `stride`)."""
    dev = st.coords.device
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev) * stride
    lo = torch.tensor(point_cloud_range[:3], dtype=torch.float32, device=dev)
    xyz = st.coords.to(torch.float32).flip(-1)
    return lo + (xyz + 0.5) * vs


def _dense_bev(st: SparseTensor) -> torch.Tensor:
    """[B, V, C] sparse -> [B, H, W, C * D] dense BEV (channel d * C + c).

    The coords stay z-major sorted through every stage, so the linear keys
    are monotone over the valid rows and the sorted segment sum places
    them; padding rows get the key D*H*W and keys >= D*H*W (voxels a
    z-stride pushed out of the grid) are dropped, as on both JAX routes."""
    d, h, w = st.grid
    b, _, c = st.features.shape
    lin = (st.coords[..., 0] * (h * w) + st.coords[..., 1] * w +
           st.coords[..., 2])
    lin = torch.where(st.mask, lin, d * h * w).to(torch.int32)
    feats = torch.where(st.mask[..., None], st.features, 0.)
    canvas = sorted_scatter.sorted_segment_sum(lin, feats, d * h * w)
    return canvas.reshape(b, d, h, w, c).permute(0, 2, 3, 1, 4).reshape(
        b, h, w, d * c)


def _caps(stage_capacities, v):
    if stage_capacities is not None:
        return list(stage_capacities)
    return [v, max(v // 2, 1), max(v // 4, 1), max(v // 8, 1)]


@manager.MIDDLE_ENCODERS.add_component
class SparseResNet3D(nn.Module):
    """Submanifold stem, two residual blocks, three strided stages with
    residual blocks, a z-only stride-2 extra conv, dense BEV out."""

    #: BEV-plane downsampling against the voxel grid (three xy-stride-2
    #: stages; the extra conv is z-only)
    bev_stride = 8

    def __init__(self, in_channels: int = 128, voxel_size=(0.2, 0.2, 4),
                 point_cloud_range=(0, -40, -3, 70.4, 40, 1),
                 stage_capacities: Sequence[int] = None,
                 generator: torch.Generator = None):
        super().__init__()
        g = default_generator(generator)
        self.grid = _grid_from_range(point_cloud_range, voxel_size)
        self.stage_capacities = stage_capacities
        self.conv_input = _ConvBNReLU(in_channels, 16, generator=g)
        self.conv1 = nn.ModuleList(
            [SparseBasicBlock(16, generator=g) for _ in range(2)])
        self.down2 = _ConvBNReLU(16, 32, stride=2, generator=g)
        self.conv2 = nn.ModuleList(
            [SparseBasicBlock(32, generator=g) for _ in range(2)])
        self.down3 = _ConvBNReLU(32, 64, stride=2, generator=g)
        self.conv3 = nn.ModuleList(
            [SparseBasicBlock(64, generator=g) for _ in range(2)])
        self.down4 = _ConvBNReLU(64, 128, stride=2, generator=g)
        self.conv4 = nn.ModuleList(
            [SparseBasicBlock(128, generator=g) for _ in range(2)])
        # z-collapse: stride 2 in z only, the BEV plane keeps stage 4's
        self.extra = _ConvBNReLU(128, 128, kernel_size=3, stride=(2, 1, 1),
                                 generator=g)

    def forward(self, voxel_features, coords, voxel_mask,
                return_stages: bool = False):
        caps = _caps(self.stage_capacities, voxel_features.shape[1])
        st = SparseTensor(voxel_features, coords, voxel_mask, self.grid)
        st = self.conv_input(st)
        stages = []
        for i, (down, blocks) in enumerate((
                (None, self.conv1), (self.down2, self.conv2),
                (self.down3, self.conv3), (self.down4, self.conv4))):
            if down is not None:
                down.conv.out_capacity = caps[i]
                st = down(st)
            for blk in blocks:
                st = blk(st)
            stages.append((st, 2 ** i))
        self.extra.conv.out_capacity = caps[3]
        bev = _dense_bev(self.extra(st))
        if return_stages:
            # multi-level sparse taps (the reference's x_conv1..x_conv4)
            return bev, stages
        return bev


@manager.MIDDLE_ENCODERS.add_component
class SparseNet3D(nn.Module):
    """SECOND-style sparse middle extractor: stem and three strided stages,
    one conv each after them, dense BEV out."""

    #: three xy-stride-2 downsamples against the voxel grid
    bev_stride = 8

    def __init__(self, in_channels: int = 4, voxel_size=(0.05, 0.05, 0.1),
                 point_cloud_range=(0, -40, -3, 70.4, 40, 1),
                 stage_channels: Sequence[int] = (16, 32, 64, 64),
                 stage_capacities: Sequence[int] = None,
                 generator: torch.Generator = None):
        super().__init__()
        g = default_generator(generator)
        self.grid = _grid_from_range(point_cloud_range, voxel_size)
        self.stage_capacities = stage_capacities
        c = list(stage_channels)
        self.stem = _ConvBNReLU(in_channels, c[0], generator=g)
        self.block1 = _ConvBNReLU(c[0], c[0], generator=g)
        self.down1 = _ConvBNReLU(c[0], c[1], stride=2, generator=g)
        self.block2 = _ConvBNReLU(c[1], c[1], generator=g)
        self.down2 = _ConvBNReLU(c[1], c[2], stride=2, generator=g)
        self.block3 = _ConvBNReLU(c[2], c[2], generator=g)
        self.down3 = _ConvBNReLU(c[2], c[3], stride=2, generator=g)
        self.block4 = _ConvBNReLU(c[3], c[3], generator=g)

    def forward(self, voxel_features, coords, voxel_mask,
                return_stages: bool = False):
        caps = _caps(self.stage_capacities, voxel_features.shape[1])
        st = SparseTensor(voxel_features, coords, voxel_mask, self.grid)
        st = self.block1(self.stem(st))
        stages = [(st, 1)]
        for i, (down, block) in enumerate((
                (self.down1, self.block2), (self.down2, self.block3),
                (self.down3, self.block4)), start=1):
            down.conv.out_capacity = caps[i]
            st = block(down(st))
            stages.append((st, 2 ** i))
        bev = _dense_bev(st)
        if return_stages:
            return bev, stages
        return bev
