"""On-device box utilities.

Port of the part of paddle3d_tpu/ops/box_ops.py the ported models use
(limit_period, boxes_to_corners_bev, second_box_encode, second_box_decode).
"""
import math

import torch

__all__ = ["limit_period", "boxes_to_corners_bev", "second_box_encode",
           "second_box_decode"]


def limit_period(val, offset: float = 0.5, period: float = math.pi):
    """Wrap angle into [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val / period + offset) * period


def boxes_to_corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 5+] (cx, cy, dx, dy, ..., yaw) -> [..., 4, 2] CCW BEV corners,
    in the JAX package's corner order (-+ signs of the unit square
    (-.5, -.5), (.5, -.5), (.5, .5), (-.5, .5), then the rotation). 7-dof
    boxes (x, y, z, dx, dy, dz, yaw) use columns 3:5 as the footprint."""
    if boxes.shape[-1] >= 7:
        dx, dy = boxes[..., 3], boxes[..., 4]
    else:
        dx, dy = boxes[..., 2], boxes[..., 3]
    cx, cy, yaw = boxes[..., 0, None], boxes[..., 1, None], boxes[..., -1]
    ux = torch.tensor([-0.5, 0.5, 0.5, -0.5], dtype=boxes.dtype,
                      device=boxes.device)
    uy = torch.tensor([-0.5, -0.5, 0.5, 0.5], dtype=boxes.dtype,
                      device=boxes.device)
    x = ux * dx[..., None]
    y = uy * dy[..., None]
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    rx = c * x - s * y + cx
    ry = s * x + c * y + cy
    return torch.stack([rx, ry], dim=-1)


def second_box_encode(boxes: torch.Tensor,
                      anchors: torch.Tensor) -> torch.Tensor:
    """SECOND residual encoding: [..., 7+] boxes and [..., 7] anchors
    (x, y, z, w, l, h, r) -> [..., 7] residuals."""
    xa, ya, za, wa, la, ha, ra = torch.split(anchors, 1, dim=-1)
    xg, yg, zg, wg, lg, hg, rg = torch.split(boxes[..., :7], 1, dim=-1)
    diag = torch.sqrt(la**2 + wa**2)
    xt = (xg - xa) / diag
    yt = (yg - ya) / diag
    zt = (zg - za) / ha
    wt = torch.log(torch.clamp(wg, min=1e-6) / wa)
    lt = torch.log(torch.clamp(lg, min=1e-6) / la)
    ht = torch.log(torch.clamp(hg, min=1e-6) / ha)
    return torch.cat([xt, yt, zt, wt, lt, ht, rg - ra], dim=-1)


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
