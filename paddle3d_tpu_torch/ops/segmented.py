"""Segmented scans over rows sorted by a segment key.

Port of the functions of paddle3d_tpu/ops/segmented.py that the fused
voxelize + mean (ops/voxelize.voxel_mean: seg_prefix_sum_bounded,
blocked_cumsum) and the multi-layer pillar train path (ops/pillar_ops.py:
seg_prefix_max_bounded, seg_window_max_bounded, seg_broadcast_from_bounded)
use. They are plain tensor code in the JAX package (XLA, not Pallas) and
plain PyTorch here, with the JAX fill values (key -2, values -inf). All scan
along dim 1 of a batch [B, N, ...]. The doubling scans combine in the same
order as the JAX package's, so the two agree bit for bit up to the backends'
own rounding (the maxes and copies exactly).
"""
import torch

__all__ = ["seg_prefix_sum_bounded", "seg_prefix_max_bounded",
           "seg_window_max_bounded", "seg_broadcast_from_bounded",
           "blocked_cumsum"]


def _steps_for(max_len: int) -> int:
    k = 0
    while (1 << k) < max_len:
        k += 1
    return k


def _shift_down(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """x shifted along dim 1 so row j reads row j - d (top d rows = fill)."""
    pad = torch.full_like(x[:, :d], fill)
    return torch.cat([pad, x[:, :-d]], dim=1)


def _shift_up(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """x shifted along dim 1 so row j reads row j + d (bottom d rows =
    fill)."""
    pad = torch.full_like(x[:, :d], fill)
    return torch.cat([x[:, d:], pad], dim=1)


def _bcast(flag: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return flag.reshape(flag.shape + (1,) * (x.dim() - flag.dim()))


def seg_prefix_sum_bounded(vals: torch.Tensor, keys: torch.Tensor,
                           max_len: int) -> torch.Tensor:
    """Segment-inclusive prefix sum along dim 1, exact for rows whose
    in-segment rank is < 2^ceil(log2(max_len)).

    vals [B, N] or [B, N, C]; keys [B, N] sorted segment ids."""
    x = vals
    for k in range(_steps_for(max_len)):
        d = 1 << k
        if d >= x.shape[1]:
            break
        same = _bcast(_shift_down(keys, d, -2) == keys, x)
        x = torch.where(same, x + _shift_down(x, d, 0), x)
    return x


def seg_prefix_max_bounded(vals: torch.Tensor, keys: torch.Tensor,
                           max_len: int) -> torch.Tensor:
    """Segment-inclusive prefix max (the bounded sum's contract) of float
    values."""
    x = vals
    neg = -float("inf")
    for k in range(_steps_for(max_len)):
        d = 1 << k
        if d >= x.shape[1]:
            break
        same = _bcast(_shift_down(keys, d, -2) == keys, x)
        x = torch.where(same, torch.maximum(x, _shift_down(x, d, neg)), x)
    return x


def seg_window_max_bounded(vals: torch.Tensor, keys: torch.Tensor,
                           max_len: int) -> torch.Tensor:
    """Every row receives the max over the rows of its segment within the
    centred window [j - 2^K + 1, j + 2^K - 1], K = ceil(log2(max_len)): the
    whole segment when it has at most max_len rows. One bidirectional
    doubling pass (max is idempotent). Float values."""
    x = vals
    neg = -float("inf")
    for k in range(_steps_for(max_len)):
        d = 1 << k
        if d >= x.shape[1]:
            break
        same_dn = _bcast(_shift_down(keys, d, -2) == keys, x)
        same_up = _bcast(_shift_up(keys, d, -2) == keys, x)
        dn = torch.where(same_dn, _shift_down(x, d, neg), neg)
        up = torch.where(same_up, _shift_up(x, d, neg), neg)
        x = torch.maximum(x, torch.maximum(dn, up))
    return x


def seg_broadcast_from_bounded(vals: torch.Tensor, at: torch.Tensor,
                               keys: torch.Tensor,
                               max_len: int) -> torch.Tensor:
    """Copy each segment's value at its `at`-flagged row backward to every
    row of the segment within max_len rows before it; rows where ~at are
    ignored."""
    have = at
    x = torch.where(_bcast(at, vals), vals, 0.)
    for k in range(_steps_for(max_len)):
        d = 1 << k
        if d >= x.shape[1]:
            break
        same = _shift_up(keys, d, -2) == keys
        take = _shift_up(have, d, False) & same & ~have
        x = torch.where(_bcast(take, x), _shift_up(x, d, 0), x)
        have = have | take
    return x


def blocked_cumsum(x: torch.Tensor, block: int = 512) -> torch.Tensor:
    """Inclusive cumsum along dim 1 as a two-level blocked scan (the JAX
    package's form: per-block cumsums plus the exclusive prefix of the
    block totals). For integer inputs any order gives the same sums."""
    n = x.shape[1]
    if n <= block:
        return torch.cumsum(x, dim=1)
    pad = (-n) % block
    xp = torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], 1) \
        if pad else x
    nb = xp.shape[1] // block
    xb = xp.reshape((x.shape[0], nb, block) + x.shape[2:])
    intra = torch.cumsum(xb, dim=2)
    totals = intra[:, :, -1]
    carry = torch.cumsum(totals, dim=1) - totals
    out = (intra + carry[:, :, None]).reshape(xp.shape)
    return out[:, :n] if pad else out
