"""SMOKE box coder, torch port of
paddle3d_tpu/models/detection/smoke/smoke_coder.py (SMOKECoder).

The decode functions shared by the loss and the inference decode, in the
JAX package's arithmetic order. Camera frame: x right, y down, z forward;
location = box centre (bottom centre where noted); dims (h, w, l). A module
so that its dimension priors move with the model (a buffer outside the
state dict: load_jax_params fills parameters and running stats only).
"""
import math
from typing import Sequence

import torch
from torch import nn

__all__ = ["SMOKECoder"]


class SMOKECoder(nn.Module):
    def __init__(self, depth_ref: Sequence[float],
                 dim_ref: Sequence[Sequence[float]]):
        super().__init__()
        self.depth_ref = tuple(map(float, depth_ref))
        # the YAML carries dim_ref in the paper's (l, h, w) order; the
        # pipeline is (h, w, l) throughout, so reorder at the boundary
        ref = torch.tensor(dim_ref, dtype=torch.float32)       # [C, 3]
        self.register_buffer("dim_ref", ref[:, [1, 2, 0]].contiguous(),
                             persistent=False)

    def decode_depth(self, depths_offset: torch.Tensor) -> torch.Tensor:
        return depths_offset * self.depth_ref[1] + self.depth_ref[0]

    def decode_dimension(self, cls_id: torch.Tensor,
                         dims_offset: torch.Tensor) -> torch.Tensor:
        """dims = ref[cls] * exp(offset); offset already sigmoid - 0.5."""
        return self.dim_ref[cls_id.long()] * torch.exp(dims_offset)

    @staticmethod
    def decode_orientation(vector_ori: torch.Tensor,
                           locations: torch.Tensor):
        """[..., 2] (sin, cos) local orientation + [..., 3] locations ->
        (rotys, alphas)."""
        rays = torch.arctan(locations[..., 0] / (locations[..., 2] + 1e-7))
        alphas = torch.arctan(vector_ori[..., 0] / (vector_ori[..., 1] +
                                                    1e-7))
        cos_pos = (vector_ori[..., 1] >= 0).to(alphas.dtype)
        alphas = alphas - (cos_pos * 2 - 1) * math.pi / 2
        rotys = alphas + rays
        # the masks in the angles' type: a bool times 2 is an integer, which
        # times a float is torch's default float, f32 even in an f64 run
        rotys = rotys - (rotys > math.pi).to(rotys.dtype) * 2 * math.pi
        rotys = rotys + (rotys < -math.pi).to(rotys.dtype) * 2 * math.pi
        return rotys, alphas

    @staticmethod
    def encode_box3d(rotys: torch.Tensor, dims: torch.Tensor,
                     locs: torch.Tensor) -> torch.Tensor:
        """(roty [N], dims (h, w, l) [N, 3], locs bottom centre [N, 3]) ->
        [N, 3, 8] camera-frame corners."""
        h, w, l = dims[:, 0], dims[:, 1], dims[:, 2]
        x = torch.stack([l / 2, l / 2, -l / 2, -l / 2,
                         l / 2, l / 2, -l / 2, -l / 2], dim=1)
        y = torch.stack([torch.zeros_like(h)] * 4 + [-h] * 4, dim=1)
        z = torch.stack([w / 2, -w / 2, -w / 2, w / 2,
                         w / 2, -w / 2, -w / 2, w / 2], dim=1)
        c, s = torch.cos(rotys), torch.sin(rotys)
        rx = c[:, None] * x + s[:, None] * z
        rz = -s[:, None] * x + c[:, None] * z
        corners = torch.stack([rx, y, rz], dim=1)
        return corners + locs[:, :, None]
