"""Multi-scale deformable attention as a batched torch op, port of
paddle3d_tpu/ops/ms_deform_attn.py (ms_deform_attn).

Each (query, head, level, point) samples its level's value map bilinearly
at a normalised location (align_corners=False pixel centres: x * W - 0.5),
the four taps gathered from the map and lerped as the JAX package's
_bilinear_sample does (a tap outside the map reads 0), and the P points of
a level are summed with their attention weights. The JAX package runs its
small levels as a dense tent-weight matrix [Q, M, H*W] times the map (a
TPU formulation: at BEVFormer-tiny's temporal self-attention 200 MB a
call); the port gathers the taps instead, [B, Q, M, P, 4] rows of D
floats a level. The taps are one index_select from the flattened maps, so
autograd's backward is index_add_ (in torch's deterministic mode it adds
in row order on the card). No hand-written kernel: the JAX function is
XLA code, not a Pallas kernel.
"""
from typing import Sequence, Tuple

import torch

__all__ = ["ms_deform_attn"]


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """value [B, S, M, D] (the levels' H*W cells flattened in order, S =
    sum of H*W); spatial_shapes ((H0, W0), ...); sampling_locations [B, Q,
    M, L, P, 2] (x, y) in [0, 1]; attention_weights [B, Q, M, L, P] ->
    [B, Q, M * D]."""
    b, s, m, d = value.shape
    q, p = sampling_locations.shape[1], sampling_locations.shape[4]
    dev = value.device
    out = None
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        # the level's maps, a row a (batch, head, cell)
        table = value[:, start:start + h * w].permute(0, 2, 1, 3).reshape(
            b * m * h * w, d)
        start += h * w
        loc = sampling_locations[:, :, :, lvl]              # [B, Q, M, P, 2]
        px = loc[..., 0] * w - 0.5
        py = loc[..., 1] * h - 0.5
        x0, y0 = torch.floor(px), torch.floor(py)
        tx, ty = (px - x0)[..., None], (py - y0)[..., None]
        x0i, y0i = x0.long(), y0.long()
        base = ((torch.arange(b, device=dev)[:, None] * m +
                 torch.arange(m, device=dev)) * (h * w))[:, None, :, None]

        def tap(xi, yi):
            inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            idx = base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
            v = table.index_select(0, idx.reshape(-1)).view(b, q, m, p, d)
            return torch.where(inb[..., None], v, 0.)

        v00, v01 = tap(x0i, y0i), tap(x0i + 1, y0i)
        v10, v11 = tap(x0i, y0i + 1), tap(x0i + 1, y0i + 1)
        top = v00 * (1 - tx) + v01 * tx
        bot = v10 * (1 - tx) + v11 * tx
        sampled = top * (1 - ty) + bot * ty                 # [B, Q, M, P, D]
        contrib = (sampled * attention_weights[:, :, :, lvl, :, None]).sum(
            dim=3)
        out = contrib if out is None else out + contrib
    return out.reshape(b, q, m * d)
