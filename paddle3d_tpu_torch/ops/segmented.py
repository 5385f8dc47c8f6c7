"""Segmented scans over rows sorted by a segment key.

Port of the two functions of paddle3d_tpu/ops/segmented.py that the fused
voxelize + mean (ops/voxelize.voxel_mean) uses: seg_prefix_sum_bounded and
blocked_cumsum. They are plain tensor code in the JAX package (XLA, not
Pallas) and plain PyTorch here. Both scan along dim 1 of a batch [B, N, ...].
The doubling scan adds in the same order as the JAX package's, so the two
agree bit for bit up to the backends' own rounding.
"""
import torch

__all__ = ["seg_prefix_sum_bounded", "blocked_cumsum"]


def _steps_for(max_len: int) -> int:
    k = 0
    while (1 << k) < max_len:
        k += 1
    return k


def _shift_down(x: torch.Tensor, d: int, fill) -> torch.Tensor:
    """x shifted along dim 1 so row j reads row j - d (top d rows = fill)."""
    pad = torch.full_like(x[:, :d], fill)
    return torch.cat([pad, x[:, :-d]], dim=1)


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
        same = _shift_down(keys, d, -2) == keys
        if x.dim() > 2:
            same = same.reshape(same.shape + (1,) * (x.dim() - 2))
        x = torch.where(same, x + _shift_down(x, d, 0), x)
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
