"""Query denoising (DN) training for DETR-style 3-D heads, torch port of
paddle3d_tpu/models/heads/denoising.py (DenoisingConfig, dn_attn_mask,
build_dn_queries, dn_loss).

Every sample contributes groups x G x (2 with negatives) DN queries, a
noisy copy of each gt slot (padded slots masked), after the num_query
matching queries. The attention mask is True where a query may attend:
matching queries see matching queries only, a DN query sees the matching
queries and its own group. The JAX package draws the noise from a
jax.random key; the port draws it from an explicit torch.Generator on the
host (then moves it to the boxes' device), and build_dn_queries also takes
the draws themselves, so that a test hands both sides the same numbers.
"""
from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["DenoisingConfig", "build_dn_queries", "dn_attn_mask", "dn_loss",
           "dn_draws"]


class DenoisingConfig(NamedTuple):
    groups: int = 3                 # the reference's `scalar` group count
    box_noise_scale: float = 0.4    # centre jitter (fraction of box dims)
    label_noise_ratio: float = 0.2  # P(flip a positive query's label)
    negative: bool = True           # a group's second half: negatives


def dn_attn_mask(num_query: int, groups: int, group_size: int,
                 device=None) -> torch.Tensor:
    """-> [Qt, Qt] bool, True = may attend."""
    qt = num_query + groups * group_size
    idx = torch.arange(qt, device=device)
    gid = torch.where(idx < num_query, -1,
                      torch.div(idx - num_query, max(group_size, 1),
                                rounding_mode="floor"))
    row, col = gid[:, None], gid[None, :]
    return torch.where(row < 0, col < 0, (col < 0) | (col == row))


def dn_draws(generator: torch.Generator, b: int, g: int, num_classes: int,
             cfg: DenoisingConfig) -> dict:
    """The noise build_dn_queries needs, drawn on the host from generator:
    u [B, reps, G, 3] uniform in [-1, 1), flip [B, reps, G] bool (a
    positive's label flips), labels [B, reps, G] its random label."""
    reps = cfg.groups * (2 if cfg.negative else 1)
    u = torch.rand((b, reps, g, 3), generator=generator) * 2 - 1
    flip = torch.rand((b, reps, g), generator=generator) < \
        cfg.label_noise_ratio
    labels = torch.randint(0, num_classes, (b, reps, g), generator=generator)
    return {"u": u, "flip": flip, "labels": labels}


def build_dn_queries(gt_boxes, gt_labels, num_classes: int, pc_range,
                     cfg: DenoisingConfig, generator=None, draws=None):
    """gt_boxes [B, G, >=7] (centre z), gt_labels [B, G] (-1 pad); the
    noise from `draws` (dn_draws' keys) or else drawn from `generator` ->
    dict with
      ref      [B, Qdn, 3]  noisy reference points in [0, 1]
      labels   [B, Qdn]     target labels (num_classes = background)
      pos      [B, Qdn]     positive-query mask (reconstruct the gt box)
      valid    [B, Qdn]     real (non-pad) query mask
      gt_idx   [B, Qdn]     source gt slot of each query
    and the ints group_size and groups; Qdn = groups * G * (2 if
    cfg.negative else 1)."""
    b, g = gt_labels.shape
    dev = gt_boxes.device
    reps = cfg.groups * (2 if cfg.negative else 1)
    if draws is None:
        draws = dn_draws(generator, b, g, num_classes, cfg)
    u = draws["u"].to(device=dev, dtype=gt_boxes.dtype)
    flip = draws["flip"].to(dev)
    rand_lab = draws["labels"].to(dev)
    # the JAX package's range is an f32 array whatever the step's dtype
    pc = torch.tensor(pc_range, dtype=torch.float32, device=dev)
    extent = pc[3:] - pc[:3]
    centers = gt_boxes[..., :3]
    dims = gt_boxes[..., 3:6]
    gt_valid = gt_labels >= 0

    # positives jitter within box_noise_scale x half a dim; negatives go
    # out to (1, 2] x half a dim
    is_neg = (torch.arange(reps, device=dev) % 2 == 1) if cfg.negative \
        else torch.zeros((reps,), dtype=torch.bool, device=dev)
    neg4 = is_neg[None, :, None, None]
    mag = torch.where(neg4, 1.0 + torch.abs(u), cfg.box_noise_scale * u)
    sign = torch.where(neg4, torch.sign(u) + (u == 0).to(u.dtype), 1.0)
    noisy = centers[:, None] + mag * sign * (dims[:, None] / 2.)
    ref = ((noisy - pc[:3]) / extent).clamp(1e-3, 1 - 1e-3)

    neg3 = is_neg[None, :, None]
    lab = gt_labels[:, None].expand(b, reps, g).long()
    lab = torch.where(flip & ~neg3, rand_lab, lab)
    lab = torch.where(neg3, num_classes, lab)
    lab = torch.where(gt_valid[:, None], lab, num_classes)
    pos = ~neg3 & gt_valid[:, None]
    valid = gt_valid[:, None].expand(b, reps, g)
    gt_idx = torch.arange(g, device=dev)[None, None].expand(b, reps, g)
    qdn = reps * g
    return {"ref": ref.reshape(b, qdn, 3),
            "labels": lab.reshape(b, qdn),
            "pos": pos.reshape(b, qdn),
            "valid": valid.reshape(b, qdn),
            "gt_idx": gt_idx.reshape(b, qdn),
            "group_size": g * (2 if cfg.negative else 1),
            "groups": cfg.groups}


def dn_loss(dn_cls, dn_bbox_enc, dn_meta, gt_enc, code_weights,
            num_classes: int):
    """Known-assignment DN losses: focal classification on every valid DN
    query (positives toward their possibly flipped label, negatives and
    pads toward background), L1 on the positives' boxes; both over the
    batch's positive count. dn_cls [L, B, Qdn, C], dn_bbox_enc [L, B, Qdn,
    code], gt_enc [B, G, code] -> (cls, reg) summed over the layers."""
    cw = torch.tensor(code_weights, dtype=dn_bbox_enc.dtype,
                      device=dn_bbox_enc.device)
    pos, valid = dn_meta["pos"], dn_meta["valid"]
    tgt = torch.gather(gt_enc, 1, dn_meta["gt_idx"][..., None].expand(
        -1, -1, gt_enc.shape[-1]))
    onehot = F.one_hot(dn_meta["labels"], num_classes + 1)[
        ..., :num_classes].to(dn_cls.dtype)
    n_pos = pos.sum().clamp(min=1)
    total_cls = total_reg = 0.
    for cls_l, bbox_l in zip(dn_cls, dn_bbox_enc):
        ce = _sigmoid_focal(cls_l, onehot)
        total_cls = total_cls + torch.where(valid[..., None], ce, 0.).sum() \
            / n_pos
        l1 = torch.abs(bbox_l - tgt) * cw
        total_reg = total_reg + torch.where(pos[..., None], l1, 0.).sum() \
            / n_pos
    return total_cls, total_reg


def _sigmoid_focal(logits, targets, alpha=0.25, gamma=2.0):
    p = torch.sigmoid(logits)
    ce = logits.clamp(min=0) - logits * targets + torch.log1p(
        torch.exp(-torch.abs(logits)))
    p_t = p * targets + (1 - p) * (1 - targets)
    a_t = alpha * targets + (1 - alpha) * (1 - targets)
    return a_t * ((1 - p_t) ** gamma) * ce
