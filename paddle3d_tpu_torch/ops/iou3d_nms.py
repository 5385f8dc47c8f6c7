"""Rotated BEV / 3-D IoU and greedy rotated-BEV NMS as fixed-shape tensor
programs.

Port of paddle3d_tpu/ops/iou3d_nms.py: `boxes_overlap_bev`, `boxes_iou_bev`
and `boxes_iou3d` on the slot-list clip (ops/iou_clip.py: the K11 kernel on a
CUDA tensor, its plain version on a CPU one; the JAX package gates its TPU
kernel behind an environment variable and N, M >= 64 only for TPU tiling,
which the port does not copy); and what `suppress` runs: the Green's-theorem
all-pairs intersection area, the fixpoint greedy survivors, the kept-buffer
blocked variant and the compaction of kept indices; and `nms_bev` on top of
it (score top-k, then suppress). Every function takes leading batch
dimensions, written out instead of vmapped. The NMS part is plain PyTorch:
the JAX package runs it as plain XLA, not as a TPU kernel.
"""
from typing import Tuple

import math

import torch

from . import iou_clip
from .box_ops import boxes_to_corners_bev
from .pointnet2 import topk_stable

__all__ = ["boxes_overlap_bev", "boxes_iou_bev", "boxes_iou3d", "suppress",
           "nms_bev"]


def boxes_overlap_bev(boxes_a: torch.Tensor,
                      boxes_b: torch.Tensor) -> torch.Tensor:
    """[..., N, 5|7] x [..., M, 5|7] rotated boxes (equal leading dims) ->
    [..., N, M] BEV intersection areas, by the slot-list clip of their CCW
    corners."""
    ca = boxes_to_corners_bev(boxes_a).to(torch.float32)
    cb = boxes_to_corners_bev(boxes_b).to(torch.float32)
    return iou_clip.pairwise_intersection_area(ca, cb)


def boxes_iou_bev(boxes_a: torch.Tensor,
                  boxes_b: torch.Tensor) -> torch.Tensor:
    """[..., N, 5|7] x [..., M, 5|7] -> [..., N, M] rotated BEV IoU."""
    inter = boxes_overlap_bev(boxes_a, boxes_b)
    cols = (3, 4) if boxes_a.shape[-1] >= 7 else (2, 3)
    area_a = boxes_a[..., cols[0]] * boxes_a[..., cols[1]]
    area_b = boxes_b[..., cols[0]] * boxes_b[..., cols[1]]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-6)


def boxes_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """[..., N, 7] x [..., M, 7] (x, y, z centre, dx, dy, dz, yaw) ->
    [..., N, M] 3-D IoU; the vertical extent is z -+ dz / 2."""
    inter_bev = boxes_overlap_bev(boxes_a, boxes_b)
    a_zmin = boxes_a[..., 2] - boxes_a[..., 5] / 2
    a_zmax = boxes_a[..., 2] + boxes_a[..., 5] / 2
    b_zmin = boxes_b[..., 2] - boxes_b[..., 5] / 2
    b_zmax = boxes_b[..., 2] + boxes_b[..., 5] / 2
    overlap_z = torch.clamp(
        torch.minimum(a_zmax[..., :, None], b_zmax[..., None, :]) -
        torch.maximum(a_zmin[..., :, None], b_zmin[..., None, :]), min=0.)
    inter = inter_bev * overlap_z
    vol_a = boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5]
    vol_b = boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5]
    union = vol_a[..., :, None] + vol_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-6)


def _green_edge_sum(acx, acy, aux, auy, aa, ab,
                    bcx, bcy, bux, buy, ba, bb):
    """Sum of Green's-theorem line integrals of A's edges clipped to B.

    For convex regions, area(A∩B) = ½ ∮_{∂(A∩B)} (x dy − y dx); a straight
    sub-segment from P0 to P1 contributes P0×P1 regardless of the others, so
    each of A's 4 edges is clamped to B's two slabs in B's frame. Inputs
    broadcast ([..., N, 1] A-params against [..., 1, M] B-params); A's
    corners are (±aa·u ±ab·v) around (acx, acy), traversed CCW.
    """
    big = 1e9
    eps = 1e-4   # |d_perp| below 0.1 mm over the edge counts as parallel
    signs = [(1., 1.), (-1., 1.), (-1., -1.), (1., -1.)]
    px = [acx + su * aa * aux + sv * ab * (-auy) for su, sv in signs]
    py = [acy + su * aa * auy + sv * ab * aux for su, sv in signs]

    def slab(s, d, half):
        degen = torch.abs(d) < eps
        inv = 1.0 / torch.where(degen, 1.0, d)
        t1 = (-half - s) * inv
        t2 = (half - s) * inv
        lo = torch.minimum(t1, t2)
        hi = torch.maximum(t1, t2)
        # an edge ON a face counts as inside (its segment is half-weighted)
        inside = torch.abs(s) <= half + 1e-4
        lo = torch.where(degen, torch.where(inside, -big, big), lo)
        hi = torch.where(degen, torch.where(inside, big, -big), hi)
        onface = degen & (torch.abs(torch.abs(s) - half) < 1e-4)
        return lo, hi, onface

    total = 0.
    for i in range(4):
        p0x, p0y = px[i], py[i]
        dx_w = px[(i + 1) % 4] - p0x
        dy_w = py[(i + 1) % 4] - p0y
        rx = p0x - bcx
        ry = p0y - bcy
        sx = rx * bux + ry * buy
        sy = -rx * buy + ry * bux
        dx = dx_w * bux + dy_w * buy
        dy = -dx_w * buy + dy_w * bux
        lox, hix, onfx = slab(sx, dx, ba)
        loy, hiy, onfy = slab(sy, dy, bb)
        # clamp into [0, 1] first: an empty interval becomes a zero-length
        # segment of real points, whose cross product is exactly 0
        t0 = torch.clamp(torch.maximum(lox, loy), 0., 1.)
        t1 = torch.clamp(torch.minimum(hix, hiy), 0., 1.)
        t1 = torch.maximum(t0, t1)
        q0x = p0x + t0 * dx_w
        q0y = p0y + t0 * dy_w
        q1x = p0x + t1 * dx_w
        q1y = p0y + t1 * dy_w
        # boundary-coincident segments belong to both boundaries: weight ½
        w = torch.where(onfx | onfy, 0.5, 1.0)
        total = total + w * (q0x * q1y - q1x * q0y)
    return total


def _pairwise_intersection_area_green(boxes_a: torch.Tensor,
                                      boxes_b: torch.Tensor) -> torch.Tensor:
    """[..., N, 5] x [..., M, 5] (cx, cy, dx, dy, yaw) -> [..., N, M]
    rotated-rectangle intersection areas."""
    acx = boxes_a[..., :, 0, None]
    acy = boxes_a[..., :, 1, None]
    aa = boxes_a[..., :, 2, None] * 0.5
    ab = boxes_a[..., :, 3, None] * 0.5
    aux = torch.cos(boxes_a[..., :, 4, None])
    auy = torch.sin(boxes_a[..., :, 4, None])
    bcx = boxes_b[..., None, :, 0]
    bcy = boxes_b[..., None, :, 1]
    ba = boxes_b[..., None, :, 2] * 0.5
    bb = boxes_b[..., None, :, 3] * 0.5
    bux = torch.cos(boxes_b[..., None, :, 4])
    buy = torch.sin(boxes_b[..., None, :, 4])

    # circumscribed-circle guard: provably disjoint pairs are exactly 0
    ra = torch.sqrt(aa * aa + ab * ab)
    rb = torch.sqrt(ba * ba + bb * bb)
    dist = torch.sqrt((acx - bcx) ** 2 + (acy - bcy) ** 2)
    possible = dist <= ra + rb

    area2 = (_green_edge_sum(acx, acy, aux, auy, aa, ab,
                             bcx, bcy, bux, buy, ba, bb) +
             _green_edge_sum(bcx, bcy, bux, buy, ba, bb,
                             acx, acy, aux, auy, aa, ab))
    return torch.where(possible, torch.clamp(0.5 * area2, min=0.), 0.)


def _fixpoint_alive(sup: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Exact greedy NMS survivors by fixpoint iteration.

    alive_i = valid_i & not exists j≺i: alive_j & sup[j, i] has a unique
    solution; iterating it in parallel converges in suppression-chain-depth
    steps. sup [..., K, K] must already hold only j≺i entries."""
    k = sup.shape[-1]
    supf = sup.to(torch.float32)
    alive = valid
    for _ in range(k):
        # counts of alive suppressors, exact in f32 (integers < 2^24)
        hits = (alive.to(torch.float32)[..., None, :] @ supf)[..., 0, :]
        new = valid & (hits == 0)
        if torch.equal(new, alive):
            break
        alive = new
    return alive & valid


def _compact_keep(keep_mask: torch.Tensor,
                  post_max_size: int) -> torch.Tensor:
    """Kept indices (array order) into post_max_size -1-padded slots."""
    k = keep_mask.shape[-1]
    order_pos = torch.cumsum(keep_mask.to(torch.int32), dim=-1) - 1
    slots = torch.where(keep_mask & (order_pos < post_max_size), order_pos,
                        post_max_size).long()
    keep_idx = torch.full(keep_mask.shape[:-1] + (post_max_size + 1,), -1,
                          dtype=torch.int32, device=keep_mask.device)
    src = torch.arange(k, dtype=torch.int32,
                       device=keep_mask.device).expand_as(slots)
    # every dropped row lands in the spill slot, which is cut away
    keep_idx.scatter_(-1, slots, src)
    return keep_idx[..., :post_max_size]


def _iou_exceeds(b5a, b5b, iou_threshold: float) -> torch.Tensor:
    """[..., N, 5] x [..., M, 5] -> bool [..., N, M]: IoU > threshold."""
    inter = _pairwise_intersection_area_green(b5a, b5b)
    area_a = b5a[..., 2] * b5a[..., 3]
    area_b = b5b[..., 2] * b5b[..., 3]
    union = torch.clamp(area_a[..., :, None] + area_b[..., None, :] - inter,
                        min=1e-6)
    return inter > iou_threshold * union


def _suppress_blocked(b5: torch.Tensor, valid: torch.Tensor,
                      iou_threshold: float, post_max_size: int,
                      block: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS with work bounded by the kept-set size, not K².

    A candidate is suppressed only by an earlier KEPT box and the output
    takes the first post_max_size kept boxes, so each score-ordered block
    needs IoU only against the kept buffer (capped at C ≥ post_max_size
    rows) and itself. b5 [B, K, 5], valid [B, K]. keep_mask is exact up to
    the post_max_size'th kept box."""
    bsz, k = valid.shape
    nb = -(-k // block)
    kp = nb * block
    cap = min(kp, -(-post_max_size // block) * block)
    b5p = torch.nn.functional.pad(b5, (0, 0, 0, kp - k))
    validp = torch.nn.functional.pad(valid, (0, kp - k))
    ridx = torch.arange(block, device=b5.device)
    earlier = ridx[:, None] < ridx[None, :]

    kept_boxes = b5.new_zeros(bsz, cap + 1, 5)     # last row: spill slot
    kept_valid = valid.new_zeros(bsz, cap + 1)
    count = torch.zeros(bsz, dtype=torch.int64, device=b5.device)
    alive_blocks = []
    for i in range(nb):
        bb = b5p[:, i * block:(i + 1) * block]
        bv = validp[:, i * block:(i + 1) * block]
        # (a) suppression by earlier kept boxes
        hit_prev = _iou_exceeds(bb, kept_boxes[:, :cap], iou_threshold)
        sup_prev = (hit_prev & kept_valid[:, None, :cap]).any(dim=-1)
        live_in = bv & ~sup_prev
        # (b) within-block greedy (precedence = row order)
        hit_own = _iou_exceeds(bb, bb, iou_threshold)
        sup = hit_own & earlier & live_in[:, :, None] & live_in[:, None, :]
        alive = _fixpoint_alive(sup, live_in)
        # append alive boxes to the kept buffer (drop past the cap)
        pos = count[:, None] + torch.cumsum(alive.long(), dim=-1) - 1
        slot = torch.where(alive & (pos < cap), pos, cap)
        kept_boxes = kept_boxes.scatter(1, slot[..., None].expand(-1, -1, 5),
                                        bb)
        kept_valid = kept_valid.scatter(1, slot, alive)
        kept_valid[:, cap] = False
        count = torch.clamp(count + alive.sum(dim=-1), max=cap)
        alive_blocks.append(alive)
    keep_mask = torch.cat(alive_blocks, dim=-1)[:, :k]
    return keep_mask, _compact_keep(keep_mask, post_max_size)


def suppress(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float,
             post_max_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy rotated-BEV NMS over score-descending candidate rows.

    boxes: [..., K, 5|7] rotated boxes in score-descending order; valid:
    [..., K]. Returns (keep_mask [..., K], keep_idx [..., post_max_size]
    -1-padded), both in score order. Large candidate sets take the
    kept-buffer blocked path; small ones the one-shot K² program (the
    same rule as the JAX package).
    """
    lead = valid.shape[:-1]
    k = boxes.shape[-2]
    if boxes.shape[-1] >= 7:
        b5 = boxes[..., [0, 1, 3, 4, 6]]
    else:
        b5 = boxes
    b5 = b5.to(torch.float32).reshape(-1, k, 5)
    valid = valid.reshape(-1, k)
    if k >= 512 and post_max_size <= 256:
        keep_mask, keep_idx = _suppress_blocked(b5, valid, iou_threshold,
                                                post_max_size)
    else:
        idx = torch.arange(k, device=b5.device)
        sup = (_iou_exceeds(b5, b5, iou_threshold)
               & (idx[:, None] < idx[None, :])
               & valid[:, :, None] & valid[:, None, :])
        keep_mask = _fixpoint_alive(sup, valid)
        keep_idx = _compact_keep(keep_mask, post_max_size)
    return (keep_mask.reshape(lead + (k,)),
            keep_idx.reshape(lead + (post_max_size,)))


def nms_bev(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
            pre_max_size: int = 1024, post_max_size: int = 256,
            score_threshold: float = -math.inf):
    """Rotated-BEV NMS over the pre_max_size best-scored boxes.

    boxes [..., N, 5|7] rotated boxes, scores [..., N] (invalid or padding
    rows carry -inf; non-finite scores and scores not above score_threshold
    count as such). -> (keep_idx [..., post_max_size] int32 indices into
    the inputs, -1 padded, in score order; count [...] kept boxes). Score
    ties keep index order."""
    scores = torch.where(torch.isfinite(scores), scores, -math.inf)
    scores = torch.where(scores > score_threshold, scores, -math.inf)
    k = min(pre_max_size, boxes.shape[-2])
    top_scores, top_idx = topk_stable(scores, k)
    top_boxes = torch.gather(
        boxes, -2, top_idx[..., None].expand(top_idx.shape +
                                             (boxes.shape[-1],)))
    valid = torch.isfinite(top_scores)
    _, keep_local = suppress(top_boxes, valid, iou_threshold, post_max_size)
    kept = keep_local >= 0
    keep_idx = torch.where(
        kept, torch.gather(top_idx, -1, torch.where(kept, keep_local,
                                                    0).long()),
        -1).to(torch.int32)
    return keep_idx, kept.sum(dim=-1).to(torch.int32)
