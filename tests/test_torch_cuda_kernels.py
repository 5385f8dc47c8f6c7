"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; without a CUDA card every test skips (a CUDA kernel has no
CPU mode). This file imports no JAX, so it also runs where only torch is
installed; tests/conftest.py imports jax, so run it there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from paddle3d_tpu_torch.ops import _build, fused_pfn, sorted_scatter
from paddle3d_tpu_torch.ops.pillar_ops import sort_points_by_cell

SENT = 2**31 - 1

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    # f32 comparisons: keep TF32 off for matmuls and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _scatter_inputs(seed, b=4, n=5000, c=65, num_cells=214272):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, num_cells, (b, n)), axis=1)
    keys[:, -500:] = SENT
    keys[1] = SENT                              # an empty batch row
    keys[0, 100:400] = keys[0, 100]             # a long duplicate run
    keys = np.sort(keys, axis=1).astype(np.int32)
    rows = rng.normal(0, 1, (b, n, c)).astype(np.float32)
    return torch.from_numpy(keys), torch.from_numpy(rows)


@pytest.mark.parametrize("split", [False, True])
def test_sorted_segment_sum_matches_plain(cuda, split):
    keys, rows = (t.to(cuda) for t in _scatter_inputs(0))
    before = _build.LAUNCHES["sorted_segment_sum"]
    fn = (sorted_scatter.sorted_segment_sum_split if split
          else sorted_scatter.sorted_segment_sum)
    got = fn(keys, rows, 214272)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sorted_segment_sum"] == before + 1
    got = torch.cat(got, dim=-1) if split else got
    ref = sorted_scatter.sorted_segment_sum_plain(keys, rows, 214272)
    # sums of up to 300 rows in another order (plain: atomics)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("P,maxV,c_in,with_distance", [
    (32, 40000, 4, False),     # the KITTI settings
    (8, 300, 4, False),        # many pillars over P, the cap firing
    (8, 300, 5, True),
])
def test_fused_pfn_rows_matches_plain(cuda, P, maxV, c_in, with_distance):
    rng = np.random.default_rng(P + maxV)
    b, n = 2, 20000
    lo = np.array([0., -39.68, -3., 0., 0.])[:c_in]
    hi = np.array([69.12, 39.68, 1., 1., .5])[:c_in]
    pts = rng.uniform(lo, hi, (b, n, c_in)).astype(np.float32)
    # half the points in a few dense clusters, a tenth out of range
    k = n // 2
    pts[:, :k, :2] = rng.uniform(lo[:2] + 5, hi[:2] - 5, (8, 2))[
        rng.integers(0, 8, k)] + rng.normal(0, .1, (b, k, 2))
    pts[:, -n // 10:, 0] = 100.
    voxel, pc_range = (0.16, 0.16, 4.), (0., -39.68, -3., 69.12, 39.68, 1.)
    keys, pts_t = sort_points_by_cell(torch.from_numpy(pts).to(cuda), voxel,
                                      pc_range)
    c_dec = c_in + 5 + int(with_distance)
    w1t = torch.from_numpy(rng.normal(0, .3, (64, c_dec)).astype(
        np.float32)).to(cuda)
    b1 = torch.from_numpy(rng.normal(0, .1, (64, 1)).astype(
        np.float32)).to(cuda)
    kw = dict(n_layers=1, P=P, maxV=maxV, nx=432, vx=0.16, vy=0.16,
              x_off=0.08, y_off=-39.6, with_distance=with_distance,
              occupancy=True)
    before = _build.LAUNCHES["fused_pfn_rows"]
    got = fused_pfn.fused_pfn_rows(keys, pts_t, w1t, b1, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_pfn_rows"] == before + 1
    ref = fused_pfn.fused_pfn_rows_plain(keys, pts_t, w1t, b1, **kw)
    # the same arithmetic in the same order (csrc/fused_pfn.cu): bit-equal
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    emitted = got[:, -1].sum(dim=1)
    assert (emitted > 0).all() and (emitted <= maxV).all()


def test_fused_pfn_two_layers_raise_on_card(cuda):
    keys = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    pts_t = torch.zeros((1, 4, 4), device=cuda)
    with pytest.raises(NotImplementedError, match="CenterPoint"):
        fused_pfn.fused_pfn_rows(
            keys, pts_t, torch.zeros((8, 9), device=cuda),
            torch.zeros((8, 1), device=cuda), torch.zeros((8, 16),
                                                          device=cuda),
            torch.zeros((8, 1), device=cuda), n_layers=2, P=4, maxV=10,
            nx=4, vx=1., vy=1., x_off=.5, y_off=.5)
