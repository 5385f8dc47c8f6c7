"""On-device box utilities.

Port of the part of paddle3d_tpu/ops/box_ops.py the inference slice uses
(limit_period, second_box_decode).
"""
import math

import torch

__all__ = ["limit_period", "second_box_decode"]


def limit_period(val, offset: float = 0.5, period: float = math.pi):
    """Wrap angle into [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val / period + offset) * period


def second_box_decode(encodings: torch.Tensor,
                      anchors: torch.Tensor) -> torch.Tensor:
    """Inverse of the SECOND residual encoding: [..., 7] residuals and
    [..., 7] anchors (x, y, z, w, l, h, r) -> [..., 7] boxes."""
    xa, ya, za, wa, la, ha, ra = torch.split(anchors, 1, dim=-1)
    xt, yt, zt, wt, lt, ht, rt = torch.split(encodings, 1, dim=-1)
    diag = torch.sqrt(la**2 + wa**2)
    xg = xt * diag + xa
    yg = yt * diag + ya
    zg = zt * ha + za
    wg, lg, hg = torch.exp(wt) * wa, torch.exp(lt) * la, torch.exp(ht) * ha
    rg = rt + ra
    return torch.cat([xg, yg, zg, wg, lg, hg, rg], dim=-1)
