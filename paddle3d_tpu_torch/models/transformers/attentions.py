"""BEVFormer's deformable attentions, torch port of
paddle3d_tpu/models/transformers/attentions.py (MSDeformableAttention,
TemporalSelfAttention, SpatialCrossAttention), on ops/ms_deform_attn.

MSDeformableAttention.sample runs one set of query projections (the
sampling offsets and the softmaxed attention weights) against G value
sources at once, each with its own reference points: the temporal
self-attention's two sources (the current BEV and the previous one) and
the spatial cross-attention's six cameras are one batched sampling each,
where the JAX package calls the attention once a source (a vmap over the
cameras). The sampling offsets' weight and bias start at zero, as the JAX
package's do.
"""
from typing import Sequence, Tuple

import torch
from torch import nn

from ...apis import manager
from ...ops.ms_deform_attn import ms_deform_attn
from ..layers.layer_libs import default_generator
from .transformer_layers import linear

__all__ = ["MSDeformableAttention", "TemporalSelfAttention",
           "SpatialCrossAttention"]


@manager.ATTENTIONS.add_component
class MSDeformableAttention(nn.Module):
    """Single-source multi-scale deformable attention."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 1, num_points: int = 4,
                 generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.num_levels = num_levels
        self.num_points = num_points
        self.head_dim = embed_dims // num_heads
        self.sampling_offsets = linear(
            embed_dims, num_heads * num_levels * num_points * 2, generator)
        nn.init.zeros_(self.sampling_offsets.weight)
        self.attention_weights = linear(
            embed_dims, num_heads * num_levels * num_points, generator)
        self.value_proj = linear(embed_dims, embed_dims, generator)
        self.output_proj = linear(embed_dims, embed_dims, generator)

    def sample(self, query, value, reference_points,
               spatial_shapes: Sequence[Tuple[int, int]]):
        """query [B, Q, C]; value [B, G, S, C], G sources; reference_points
        [B, G, Q, 2] in [0, 1] -> [B, G, Q, C], each source's attention
        output (its output projection applied)."""
        b, q, c = query.shape
        g = value.shape[1]
        m, lv, p = self.num_heads, self.num_levels, self.num_points
        v = self.value_proj(value).reshape(b * g, -1, m, self.head_dim)
        offsets = self.sampling_offsets(query).reshape(b, 1, q, m, lv, p, 2)
        weights = torch.softmax(
            self.attention_weights(query).reshape(b, q, m, lv * p), dim=-1)
        weights = weights.reshape(b, 1, q, m, lv, p).expand(
            -1, g, -1, -1, -1, -1).reshape(b * g, q, m, lv, p)
        # each level's offsets in units of its cells
        norm = torch.tensor([[w_, h_] for (h_, w_) in spatial_shapes],
                            dtype=offsets.dtype, device=offsets.device)
        loc = (reference_points[:, :, :, None, None, None, :] +
               offsets / norm[:, None, :])
        out = ms_deform_attn(v, tuple(spatial_shapes),
                             loc.reshape(b * g, q, m, lv, p, 2), weights)
        return self.output_proj(out).reshape(b, g, q, c)

    def forward(self, query, value, reference_points,
                spatial_shapes: Sequence[Tuple[int, int]], **kwargs):
        """query [B, Q, C]; value [B, S, C]; reference_points [B, Q, 2] in
        [0, 1] -> [B, Q, C]."""
        return self.sample(query, value[:, None], reference_points[:, None],
                           spatial_shapes)[:, 0]


@manager.ATTENTIONS.add_component
class TemporalSelfAttention(MSDeformableAttention):
    """BEV self-attention over [cur_bev, prev_bev]: the deformable samples
    of both, averaged."""

    def forward(self, query, value=None, reference_points=None,
                spatial_shapes=None, prev_bev=None, shift=None, **kwargs):
        """query [B, Q, C] (the current BEV); prev_bev [B, Q, C] (the query
        itself when absent); shift [B, 2] (normalised grid units) moves the
        previous BEV's sampling grid only: the ego's translation."""
        if prev_bev is None:
            prev_bev = query
        ref_prev = reference_points
        if shift is not None:
            ref_prev = reference_points + shift[:, None, :].to(
                reference_points.dtype)
        out = self.sample(query, torch.stack([query, prev_bev], dim=1),
                          torch.stack([reference_points, ref_prev], dim=1),
                          spatial_shapes)
        return (out[:, 0] + out[:, 1]) / 2


@manager.ATTENTIONS.add_component
class SpatialCrossAttention(nn.Module):
    """BEV -> multi-camera deformable cross-attention: each BEV query
    samples a camera's tokens at the mean projection of its pillar's
    num_z points (0.5 for a point the camera does not see), and averages
    the cameras that see at least one of them."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_points: int = 4, num_z: int = 4,
                 pc_range: Sequence[float] = (-51.2, -51.2, -5., 51.2, 51.2,
                                              3.),
                 generator: torch.Generator = None):
        super().__init__()
        generator = default_generator(generator)
        self.embed_dims = embed_dims
        self.num_z = num_z
        self.pc_range = list(map(float, pc_range))
        self.deform = MSDeformableAttention(
            embed_dims, num_heads, num_levels=1, num_points=num_points,
            generator=generator)
        self.output_proj = linear(embed_dims, embed_dims, generator)

    def project(self, bev_ref_2d, lidar2imgs):
        """bev_ref_2d [Q, 2] normalised BEV (x, y); lidar2imgs [B, N, 4, 4]
        lidar -> [0, 1] image coordinates (times depth) -> (reference
        points [B, N, Q, 2], hit [B, N, Q] bool: the camera sees a point
        of the query's pillar)."""
        pc = self.pc_range
        q = bev_ref_2d.shape[0]
        dt, dev = lidar2imgs.dtype, lidar2imgs.device
        zs = torch.linspace(0.25, 0.75, self.num_z, dtype=dt, device=dev)
        ref = bev_ref_2d.to(dt)
        pts = torch.stack([
            (ref[:, 0] * (pc[3] - pc[0]) + pc[0])[:, None].expand(
                q, self.num_z),
            (ref[:, 1] * (pc[4] - pc[1]) + pc[1])[:, None].expand(
                q, self.num_z),
            (zs * (pc[5] - pc[2]) + pc[2])[None, :].expand(q, self.num_z),
            torch.ones((q, self.num_z), dtype=dt, device=dev)],
            dim=-1)                                          # [Q, Z, 4]
        proj = torch.einsum("bnij,qzj->bnqzi", lidar2imgs, pts)
        depth = proj[..., 2]
        uv = proj[..., :2] / depth[..., None].clamp(min=1e-5)
        visible = ((depth > 0.1) & (uv[..., 0] > 0) & (uv[..., 0] < 1) &
                   (uv[..., 1] > 0) & (uv[..., 1] < 1))
        ref = torch.where(visible[..., None], uv, 0.5).mean(dim=3)
        return ref, visible.any(dim=3)

    def forward(self, query, value, bev_ref_2d, lidar2imgs, spatial_shapes,
                **kwargs):
        """query [B, Q, C] BEV tokens; value [B, N, S, C] each camera's
        tokens; bev_ref_2d [Q, 2]; lidar2imgs [B, N, 4, 4] -> [B, Q, C]."""
        ref, hit = self.project(bev_ref_2d, lidar2imgs)
        out = self.deform.sample(query, value, ref, spatial_shapes)
        out = out * hit[..., None].to(out.dtype)
        denom = hit.sum(dim=1).clamp(min=1)[..., None]
        return self.output_proj(out.sum(dim=1) / denom)
