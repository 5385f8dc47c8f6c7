"""PointNet++ set-abstraction modules over the masked batch layout, torch
port of paddle3d_tpu/models/common/pointnet2_modules.py (PointMLP,
SAModuleMSG, VoteLayer).

All point sets are fixed-capacity [B, N, ...] with validity masks; sampling
is farthest-point (ops/fps.py) or confidence top-k ("ctr_aware"), grouping
is the ball query (ops/ball_query.py). Both launch their hand-written kernel
on a CUDA tensor; the gathers and the shared MLPs are plain torch, as they
are plain XLA in the JAX package. Module and parameter paths mirror the nnx
tree (`scale_mlps.0.layers.1.linear`, `confidence.layers.1`), so that
utils/convert.py carries the weights across by name.
"""
from typing import List, Sequence

import torch
from torch import nn

from ...ops import ball_query as _ball_query
from ...ops import fps as _fps
from ...ops.pointnet2 import (gather_operation, grouping_operation,
                              topk_stable)
from ..layers.layer_libs import LinearBN1DReLU, default_generator, uniform_

__all__ = ["SAModuleMSG", "VoteLayer", "PointMLP", "Sequential", "linear",
           "group_max"]


def linear(in_features: int, out_features: int, generator: torch.Generator,
           bias_value: float = 0.0) -> nn.Linear:
    """nn.Linear with a bias: weight uniform(±1/sqrt(fan_in)) from the
    generator, bias constant."""
    lin = nn.utils.skip_init(nn.Linear, in_features, out_features)
    uniform_(lin.weight, in_features, generator)
    with torch.no_grad():
        lin.bias.fill_(bias_value)
    return lin


class Sequential(nn.Module):
    """Modules applied in turn, held under `layers` as nnx.Sequential holds
    them (so the parameter paths agree)."""

    def __init__(self, *layers: nn.Module):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class PointMLP(nn.Module):
    """Shared MLP over the last axis with BN+ReLU per layer."""

    def __init__(self, channels: Sequence[int], *,
                 generator: torch.Generator = None):
        super().__init__()
        g = default_generator(generator)
        self.layers = nn.ModuleList([
            LinearBN1DReLU(channels[i], channels[i + 1], generator=g)
            for i in range(len(channels) - 1)
        ])
        self.out_channels = channels[-1]

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


def group_max(mlp: nn.Module, radius: float, nsample: int, xyz, feats, mask,
              centers) -> torch.Tensor:
    """One grouping scale: ball-query the support set (xyz [B, N, 3], feats
    [B, N, C], mask [B, N]) around centers [B, M, 3], run the shared MLP
    over [offset to the centre, features] of each group and take the max
    over the group's real members -> [B, M, C'], zero where the ball is
    empty."""
    gidx, count = _ball_query.ball_query_batched(radius, nsample, xyz,
                                                 centers, mask)
    grouped = torch.cat([
        grouping_operation(xyz, gidx) - centers[:, :, None, :],
        grouping_operation(feats, gidx)], dim=-1)        # [B, M, K, 3 + C]
    out = mlp(grouped)                                   # [B, M, K, C']
    kmask = (torch.arange(nsample, device=out.device) <
             count.clamp(min=1)[..., None])
    out = torch.where(kmask[..., None], out, -1e9).max(dim=2).values
    return torch.where((count > 0)[..., None], out, 0.)


class SAModuleMSG(nn.Module):
    """Multi-scale-grouping set abstraction with selectable sampling.

    sample_type: 'd-fps' (farthest point) or 'ctr_aware' (top-k by class
    confidence, which needs the scores of an earlier layer: without them
    the layer samples by farthest point).
    """

    def __init__(self,
                 npoint: int,
                 radii: Sequence[float],
                 nsamples: Sequence[int],
                 mlps: List[List[int]],
                 in_channels: int,
                 sample_type: str = "d-fps",
                 aggregation_mlp: Sequence[int] = None,
                 confidence_mlp: Sequence[int] = None,
                 num_classes: int = 0,
                 *, generator: torch.Generator = None):
        super().__init__()
        g = default_generator(generator)
        self.npoint = npoint
        self.radii = list(radii)
        self.nsamples = list(nsamples)
        self.sample_type = sample_type
        self.scale_mlps = nn.ModuleList([
            PointMLP([in_channels + 3] + list(m), generator=g) for m in mlps
        ])
        out_ch = sum(m[-1] for m in mlps)
        self.aggregation = (PointMLP([out_ch] + list(aggregation_mlp),
                                     generator=g)
                            if aggregation_mlp else None)
        self.out_channels = (aggregation_mlp[-1] if aggregation_mlp
                             else out_ch)
        # last layer without BN/ReLU: a plain linear on top
        self.confidence = (Sequential(
            PointMLP([self.out_channels] + list(confidence_mlp), generator=g),
            linear(confidence_mlp[-1], num_classes, g))
            if confidence_mlp else None)

    def _sample(self, xyz, mask, scores):
        """-> indices [B, npoint]."""
        if self.sample_type == "ctr_aware" and scores is not None:
            conf = scores.max(dim=-1).values
            conf = torch.where(mask, conf, -torch.inf)
            return topk_stable(conf, self.npoint)[1].to(torch.int32)
        return _fps.farthest_point_sample_batched(xyz, mask, self.npoint)

    def forward(self, xyz, feats, mask, scores=None):
        """xyz [B,N,3], feats [B,N,C], mask [B,N] ->
        (new_xyz [B,M,3], new_feats [B,M,C'], new_mask [B,M],
        confidence [B,M,num_classes] or None)."""
        idx = self._sample(xyz, mask, scores)  # [B, M]
        new_xyz = gather_operation(xyz, idx)
        new_mask = gather_operation(mask, idx)
        outs = [group_max(mlp, radius, nsample, xyz, feats, mask, new_xyz)
                for radius, nsample, mlp in zip(self.radii, self.nsamples,
                                                self.scale_mlps)]
        new_feats = torch.cat(outs, dim=-1)
        if self.aggregation is not None:
            new_feats = self.aggregation(new_feats)
        new_feats = new_feats * new_mask[..., None].to(new_feats.dtype)
        conf = (self.confidence(new_feats)
                if self.confidence is not None else None)
        return new_xyz, new_feats, new_mask, conf


class VoteLayer(nn.Module):
    """Centroid vote: predict per-point offsets, clamped to a max range."""

    def __init__(self, mlps: Sequence[int], in_channels: int,
                 max_translate_range: Sequence[float], *,
                 generator: torch.Generator = None):
        super().__init__()
        g = default_generator(generator)
        self.mlp = PointMLP([in_channels] + list(mlps), generator=g)
        self.ctr_reg = linear(mlps[-1], 3, g)
        self.register_buffer(
            "max_range", torch.tensor(list(map(float, max_translate_range)),
                                      dtype=torch.float32), persistent=False)

    def forward(self, xyz, feats, mask):
        f = self.mlp(feats)
        offset = self.ctr_reg(f)
        offset = torch.minimum(torch.maximum(offset, -self.max_range),
                               self.max_range)
        return xyz + offset, f, offset
