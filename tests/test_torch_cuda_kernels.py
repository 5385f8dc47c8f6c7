"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; without a CUDA card every test skips (a CUDA kernel has no
CPU mode). This file imports no JAX, so it also runs where only torch is
installed; tests/conftest.py imports jax, so run it there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""
import os

import numpy as np
import pytest
import torch

from paddle3d_tpu_torch.ops import (_build, fused_pfn, fused_pfn_train,
                                    sorted_scatter)
from paddle3d_tpu_torch.ops.pillar_ops import sort_points_by_cell

SENT = 2**31 - 1
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


def _row_order_sum(keys, rows, num_cells):
    """The plain segment sum with each cell's rows added one at a time in
    row order (keys sorted), as the kernels add them: they must agree bit
    for bit. index_add_ adds through atomics, in an order that changes from
    run to run, so its sums of long runs differ in the last bits."""
    b, n, c = rows.shape
    keys = keys.long()
    inside = (keys >= 0) & (keys < num_cells)
    rank = torch.arange(n, device=keys.device) - torch.searchsorted(keys,
                                                                     keys)
    out = torch.zeros((b, num_cells, c), dtype=rows.dtype,
                      device=rows.device)
    batch = torch.arange(b, device=keys.device)[:, None].expand(b, n)
    for j in range(int(rank[inside].max()) + 1 if inside.any() else 0):
        m = inside & (rank == j)        # at most one row a cell
        out[batch[m], keys[m]] += rows[m]
    return out


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
    ref = _row_order_sum(keys, rows, 214272)
    # sums of up to 300 rows, in row order as the kernel adds them
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


K2_CASES = ["sentinel", "no_in_grid", "empty_tiles", "long_last",
            "tile_edges"]


def _k2_keys(case, b=3, n=4000, cells=214272):
    """Sorted keys for K2's edge cases: every key the sentinel; a scan with
    no key in the grid (past its end) beside one with negative keys; rows
    only at the two ends of the grid (runs of empty tiles between); a
    1,000-row segment in the last cell; occupied cells on both sides of
    the first 31 boundaries of the kernel's 128-cell tiles."""
    rng = np.random.default_rng(K2_CASES.index(case))
    keys = rng.integers(0, cells, (b, n))
    if case == "sentinel":
        keys[:] = SENT
    elif case == "no_in_grid":
        keys[0] = cells + rng.integers(0, 50, n)
        keys[1, :1500] = -rng.integers(1, 5, 1500)
        keys[2, -300:] = SENT
    elif case == "empty_tiles":
        keys = np.where(keys % 2 == 0, keys % 1500, cells - 1 - keys % 1500)
    elif case == "long_last":
        keys[:2, -1000:] = cells - 1
    elif case == "tile_edges":
        edges = np.arange(128, 4096, 128)
        both = np.concatenate([edges - 1, edges])
        keys[:, :both.size * 3] = np.tile(both, 3)
    return torch.from_numpy(np.sort(keys, axis=1).astype(np.int32))


@pytest.mark.parametrize("c,split", [(7, False), (64, False), (65, True)])
@pytest.mark.parametrize("case", K2_CASES)
def test_sorted_segment_sum_edge_cases(cuda, case, c, split):
    """K2 bit for bit against the row-order sum at its edge cases (see
    _k2_keys), the table's span per tile 16-byte aligned (c_main = 64) and
    not (c_main = 7), through the wrapper (one launch, the density rule's
    sparse pick) and through the C entry into a NaN-filled table."""
    cells = 214272
    keys = _k2_keys(case, cells=cells).to(cuda)
    rows = torch.from_numpy(np.random.default_rng(c).normal(
        0, 1, tuple(keys.shape) + (c,)).astype(np.float32)).to(cuda)
    assert sorted_scatter.kernel_for(keys.shape[1], cells) == \
        "sorted_segment_sum"
    ref = _row_order_sum(keys, rows, cells)
    before = dict(_build.LAUNCHES)
    got = sorted_scatter.scatter_rows(keys, rows, cells, split)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sorted_segment_sum"] == \
        before["sorted_segment_sum"] + 1
    got = torch.cat(got, dim=-1) if split else got
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    b, n = keys.shape
    out = torch.full((b, cells, c - 1 if split else c), float("nan"),
                     device=cuda)
    extra = torch.full((b, cells, 1), float("nan"), device=cuda)
    _build.check(_build.function("p3d_sorted_segment_sum")(
        keys.data_ptr(), rows.data_ptr(), out.data_ptr(),
        extra.data_ptr() if split else None, b, n, c, cells,
        _build.stream_ptr(keys.device)), "sorted_segment_sum")
    full = torch.cat([out, extra], dim=-1) if split else out
    # NaN-filled first: every cell must be written
    torch.testing.assert_close(full, ref, rtol=0, atol=0)
    if case in ("sentinel", "no_in_grid"):
        assert not got[0].any()


PFN_CASES = [
    (32, 40000, 4, False),     # the KITTI settings
    (8, 300, 4, False),        # many pillars over P, the cap firing
    (8, 300, 5, True),
]


def _pfn_inputs(cuda, P, maxV, c_in, with_distance, b=2, n=20000):
    rng = np.random.default_rng(P + maxV)
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
    kw = dict(P=P, maxV=maxV, nx=432, vx=0.16, vy=0.16, x_off=0.08,
              y_off=-39.6, with_distance=with_distance)
    return rng, keys, pts_t, w1t, b1, kw


def _close(got, ref, tol):
    """Sums of many terms in another order: the largest error within tol
    of the output's largest magnitude."""
    err = (got - ref).abs().max().item()
    assert err <= tol * max(ref.abs().max().item(), 1e-30), (err, tol)


@pytest.mark.parametrize("P,maxV,c_in,with_distance", PFN_CASES)
def test_fused_pfn_rows_matches_plain(cuda, P, maxV, c_in, with_distance):
    _, keys, pts_t, w1t, b1, kw = _pfn_inputs(cuda, P, maxV, c_in,
                                              with_distance)
    kw.update(n_layers=1, occupancy=True)
    before = _build.LAUNCHES["fused_pfn_rows"]
    got = fused_pfn.fused_pfn_rows(keys, pts_t, w1t, b1, **kw)
    again = fused_pfn.fused_pfn_rows(keys, pts_t, w1t, b1, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["fused_pfn_rows"] == before + 2
    ref = fused_pfn.fused_pfn_rows_plain(keys, pts_t, w1t, b1, **kw)
    # the same arithmetic in the same order (csrc/fused_pfn.cu): bit-equal,
    # and to a second call
    assert _same_bits(got, ref) and _same_bits(again, got)
    emitted = got[:, -1].sum(dim=1)
    assert (emitted > 0).all() and (emitted <= maxV).all()


@pytest.mark.parametrize("P,maxV,c_in,with_distance", PFN_CASES + [
    (20, 60000, 5, False)])      # the CenterPoint-nuScenes settings
def test_fused_pfn_two_layers_match_plain(cuda, P, maxV, c_in,
                                          with_distance):
    rng, keys, pts_t, w1t, b1, kw = _pfn_inputs(cuda, P, maxV, c_in,
                                                with_distance)
    u1 = 32
    w1t, b1 = w1t[:u1].contiguous(), b1[:u1].contiguous()
    w2t = torch.from_numpy(rng.normal(0, .2, (64, 2 * u1)).astype(
        np.float32)).to(cuda)
    b2 = torch.from_numpy(rng.normal(0, .1, (64, 1)).astype(
        np.float32)).to(cuda)
    for occupancy in (False, True):
        kw.update(n_layers=2, occupancy=occupancy)
        before = _build.LAUNCHES["fused_pfn_rows_2l"]
        got = fused_pfn.fused_pfn_rows(keys, pts_t, w1t, b1, w2t, b2, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["fused_pfn_rows_2l"] == before + 1
        ref = fused_pfn.fused_pfn_rows_plain(keys, pts_t, w1t, b1, w2t, b2,
                                             **kw)
        # the same arithmetic in the same order: bit-equal
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
        assert got.shape == (2, 64 + occupancy, keys.shape[1])
        assert (got[:, :64].amax(dim=(1, 2)) > 0).all()


def _pfn2_edge_case(cuda, case, b=2):
    """Sorted keys and points at the two-layer kernel's tile edges (tiles of
    128 rows): -> (keys, pts_t, weights, kw, sizes of scan 0's pillars)."""
    rng = np.random.default_rng(len(case))
    P, maxV, nx = 20, 60000, 512
    keys, pts = [], []
    for s in range(b):
        if case == "straddle":            # pillars of 1..30 rows
            sizes = rng.integers(1, 31, 160)
        elif case == "no_emission_tile":  # rows 120..399 emit and keep none
            sizes = np.concatenate([[100, 300], rng.integers(1, 8, 90)])
        elif case == "cuts":              # pillars over P, the maxV cap
            sizes = rng.integers(15, 45, 60)
            maxV = 25
        elif case == "cap_at_chunk_edge":  # the cap row on row 8,192
            if s == 0:
                sizes = rng.integers(1, 9, 3000)
                ends = np.cumsum(sizes)
                j = int(np.searchsorted(ends, 8192))
                sizes[j] -= ends[j] - 8192  # pillar j + 1 starts at 8,192
                maxV = j + 1
        else:                             # "singletons": rank-0 pillars
            sizes = np.ones(700, np.int64)
            sizes[::7] = 3
        if s == 0:
            sizes0 = sizes
        cells = np.sort(rng.choice(nx * nx, len(sizes), replace=False))
        k = np.repeat(cells, sizes)
        n = sizes0.sum() + 77             # a ragged sentinel tail
        k = np.concatenate([k, np.full(n - len(k), SENT)])[:n]
        keys.append(k)
        pts.append(rng.uniform([-51.2, -51.2, -5., 0., 0.],
                               [51.2, 51.2, 3., 1., .5], (n, 5)).T)
    n = min(len(k) for k in keys)
    keys = torch.from_numpy(np.stack([k[:n] for k in keys]).astype(
        np.int32)).to(cuda)
    pts_t = torch.from_numpy(np.ascontiguousarray(np.stack(
        [p[:, :n] for p in pts]), dtype=np.float32)).to(cuda)
    weights = [torch.from_numpy(rng.normal(0, sd, shape).astype(
        np.float32)).to(cuda) for sd, shape in
        ((.3, (32, 10)), (.1, (32, 1)), (.2, (64, 64)), (.1, (64, 1)))]
    kw = dict(n_layers=2, P=P, maxV=maxV, nx=nx, vx=0.2, vy=0.2,
              x_off=-51.1, y_off=-51.1, with_distance=False)
    return keys, pts_t, weights, kw, sizes0


PFN2_EDGES = ["straddle", "no_emission_tile", "cuts", "cap_at_chunk_edge",
              "singletons"]


def _pfn2_edge(cuda, case):
    """The two-layer kernel at its tile edges, bit for bit against its
    plain version with and without occupancy: pillars across tile edges,
    tiles with no emission row, pillars cut at P and at maxV, the maxV cap
    on the first row of a later 4,096-row chunk of the cap passes, rank-0
    pillars."""
    keys, pts_t, weights, kw, sizes = _pfn2_edge_case(cuda, case)
    for occupancy in (False, True):
        got = fused_pfn.fused_pfn_rows(keys, pts_t, *weights,
                                       occupancy=occupancy, **kw)
        ref = fused_pfn.fused_pfn_rows_plain(keys, pts_t, *weights,
                                             occupancy=occupancy, **kw)
        torch.cuda.synchronize()
        assert got.shape == (2, 64 + occupancy, keys.shape[1])
        assert _same_bits(got, ref)
    emit = ref[0, -1].cpu().numpy()           # scan 0's emission rows
    ends = np.cumsum(sizes)
    starts = ends - sizes
    kept_ends = starts + np.minimum(sizes, kw["P"]) - 1
    if case == "straddle":
        assert (starts // 128 != kept_ends // 128).any()
    elif case == "no_emission_tile":
        assert emit[128:256].sum() == 0 and emit[:128].sum() == 2
    elif case == "cuts":
        assert emit.sum() == kw["maxV"] and (sizes > kw["P"]).any()
    elif case == "cap_at_chunk_edge":
        assert starts[kw["maxV"]] == 8192 and emit.sum() == kw["maxV"]
        assert emit[:8192].sum() == kw["maxV"] and not emit[8192:].any()
    else:
        assert (emit[starts[sizes == 1]] == 1).all()



def test_fused_pfn_two_layers_raise_on_card(cuda):
    """The two-layer kernel refuses a second layer that does not fit."""
    keys = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    pts_t = torch.zeros((1, 4, 4), device=cuda)
    with pytest.raises(ValueError, match="shape mismatch"):
        fused_pfn.fused_pfn_rows(
            keys, pts_t, torch.zeros((8, 9), device=cuda),
            torch.zeros((8, 1), device=cuda), torch.zeros((8, 15),
                                                          device=cuda),
            torch.zeros((8, 1), device=cuda), n_layers=2, P=4, maxV=10,
            nx=4, vx=1., vy=1., x_off=.5, y_off=.5)


@pytest.mark.parametrize("u1,u2", [(16, 32), (8, 64), (32, 40), (30, 61)])
def test_fused_pfn_two_layers_narrow_widths(cuda, u1, u2):
    """Layers narrower than the kernel's 32 and 64 channels take its
    guarded instantiation: bit-equal to the plain version."""
    keys, pts_t, _, kw, _ = _pfn2_edge_case(cuda, "straddle")
    rng = np.random.default_rng(u1 * u2)
    weights = [torch.from_numpy(rng.normal(0, sd, shape).astype(
        np.float32)).to(cuda) for sd, shape in
        ((.3, (u1, 10)), (.1, (u1, 1)), (.2, (u2, 2 * u1)), (.1, (u2, 1)))]
    for occupancy in (False, True):
        got = fused_pfn.fused_pfn_rows(keys, pts_t, *weights,
                                       occupancy=occupancy, **kw)
        ref = fused_pfn.fused_pfn_rows_plain(keys, pts_t, *weights,
                                             occupancy=occupancy, **kw)
        torch.cuda.synchronize()
        assert got.shape == (2, u2 + occupancy, keys.shape[1])
        assert _same_bits(got, ref)


@pytest.mark.parametrize("u1,u2", [(33, 64), (32, 65)])
def test_fused_pfn_two_layers_refuse_wide_layers(cuda, u1, u2):
    """The two-layer kernel holds at most 32 first-layer and 64
    second-layer channels: wider layers raise before a launch."""
    keys = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    pts_t = torch.zeros((1, 4, 4), device=cuda)
    before = _build.LAUNCHES["fused_pfn_rows_2l"]
    with pytest.raises(ValueError, match="unsupported widths"):
        fused_pfn.fused_pfn_rows(
            keys, pts_t, torch.zeros((u1, 9), device=cuda),
            torch.zeros((u1, 1), device=cuda),
            torch.zeros((u2, 2 * u1), device=cuda),
            torch.zeros((u2, 1), device=cuda), n_layers=2, P=4, maxV=10,
            nx=4, vx=1., vy=1., x_off=.5, y_off=.5)
    assert _build.LAUNCHES["fused_pfn_rows_2l"] == before


@pytest.mark.parametrize("split", [False, True])
def test_sorted_segment_sum_cm_matches_plain(cuda, split):
    """K6 on random rows read through strides (a channel-major view wider
    than the c channels and N columns it sums), with long duplicate runs,
    sentinel tails and an empty scan, at a dense nuScenes-like grid."""
    num_cells, c = 512 * 512, 65 if split else 64
    keys, _ = _scatter_inputs(3, n=40000, c=1, num_cells=num_cells)
    keys = keys.to(cuda)
    rng = np.random.default_rng(4)
    wide = torch.from_numpy(rng.normal(0, 1, (4, c + 3, 41000)).astype(
        np.float32)).to(cuda)
    before = _build.LAUNCHES["sorted_segment_sum_cm"]
    got = sorted_scatter.sorted_segment_sum_cm(keys, wide, num_cells, c=c,
                                               split_last=split)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sorted_segment_sum_cm"] == before + 1
    ref = _row_order_sum(keys, wide[:, :c, :keys.shape[1]].transpose(1, 2),
                         num_cells)
    if split:
        assert got[0].shape == (4, num_cells, 64)
        got = torch.cat(got, dim=-1)
    # sums of up to 300 rows, in row order as the kernel adds them
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert not got[1].any()


def test_sorted_segment_sum_cm_on_pfn_rows_is_exact(cuda):
    """On the fused PFN's own rows each cell has one non-zero row: the
    channel-major sum equals the transposed row-major sum bit for bit."""
    _, keys, pts_t, w1t, b1, kw = _pfn_inputs(cuda, 32, 40000, 4, False)
    rows_t = fused_pfn.fused_pfn_rows(keys, pts_t, w1t, b1, n_layers=1,
                                      occupancy=True, **kw)
    got = sorted_scatter.sorted_segment_sum_cm(keys, rows_t, 214272,
                                               split_last=True)
    ref = sorted_scatter.sorted_segment_sum_split(
        keys, rows_t.transpose(1, 2).contiguous(), 214272)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.parametrize("P,maxV,c_in,with_distance", PFN_CASES)
def test_pfn_stats_matches_plain(cuda, P, maxV, c_in, with_distance):
    _, keys, pts_t, w1t, _, kw = _pfn_inputs(cuda, P, maxV, c_in,
                                             with_distance)
    before = _build.LAUNCHES["pfn_stats"]
    got = fused_pfn_train.pfn_stats(keys, pts_t, w1t, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pfn_stats"] == before + 1
    ref = fused_pfn_train.pfn_stats_plain(keys, pts_t, w1t, **kw)
    assert got[2].item() == ref[2].item() > 0       # kept rows, exact
    for g, r in zip(got, ref):
        _close(g, r, 1e-9)          # exact f64 products, f64 sums
    # sums in an order fixed by the shapes: a second call, the same bits
    again = fused_pfn_train.pfn_stats(keys, pts_t, w1t, **kw)
    assert all(_same_bits(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("P,maxV,c_in,with_distance", PFN_CASES)
def test_pfn_bwd_matches_plain(cuda, P, maxV, c_in, with_distance):
    rng, keys, pts_t, w1t, _, kw = _pfn_inputs(cuda, P, maxV, c_in,
                                               with_distance)
    u1, n = w1t.shape[0], keys.shape[1]
    s1, s2, _, _, _ = fused_pfn_train.pfn_stats_plain(keys, pts_t, w1t, **kw)
    mu = (s1 / keys.numel()).float()
    invsig = torch.rsqrt((s2 / keys.numel() - (s1 / keys.numel()) ** 2)
                         .float() + 1e-3)
    a = invsig * torch.from_numpy(rng.uniform(.5, 1.5, u1).astype(
        np.float32)).to(cuda)
    c = torch.from_numpy(rng.normal(0, .5, u1).astype(np.float32)).to(cuda)
    # the cotangent as autograd hands it over: a [B, C, N] view of
    # [B, N, C] rows, the occupancy channel included
    g_t = torch.from_numpy(rng.normal(0, 1, (2, n, u1 + 1)).astype(
        np.float32)).to(cuda).transpose(1, 2)
    args = (keys, pts_t, g_t, w1t, a, c, mu, invsig)
    before = _build.LAUNCHES["pfn_bwd"]
    got = fused_pfn_train.pfn_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pfn_bwd"] == before + 1
    ref = fused_pfn_train.pfn_bwd_plain(*args, **kw)
    assert (ref[0] != 0).any()
    for g, r in zip(got, ref):
        _close(g, r, 1e-9)          # exact f64 products, f64 sums
    again = fused_pfn_train.pfn_bwd(*args, **kw)
    assert all(_same_bits(x, y) for x, y in zip(got, again))


PFN_TRAIN_EDGES = ["span_edge", "tiles", "cap_mid_span",
                   "cap_at_span_start", "ragged", "short", "one_scan",
                   "sentinel"]


def _span(cuda, b, n):
    """Rows of one block's span in the train kernels at this shape."""
    spans = fused_pfn.spans(b, n, cuda)
    return -(-(-(-n // spans)) // 32) * 32


def _pfn_train_edge(cuda, case, P=32, nx=432, ny=496):
    """Sorted keys and points at the train kernels' span edges: pillars of
    1..40 rows across span edges, and across the 256-row tiles of spans
    longer than a tile (one scan of 200,000 rows); the max_voxels cap
    inside a span and on a span's first row (pillars of 1..8 rows); n not
    a multiple of the span; n < P; one scan; a scan of sentinels only; and
    for the one-layer K1 a 1,000-row pillar (whole tiles with no emission
    row, one scan of 200,000 rows). ->
    (keys, pts_t, w1t, kw, sizes of scan 0's pillars, span)."""
    rng = np.random.default_rng(
        (PFN_TRAIN_EDGES + ["no_emission_tile"]).index(case))
    b = 1 if case in ("one_scan", "tiles", "no_emission_tile") else 2
    n = {"ragged": 12345, "short": 20, "tiles": 200000,
         "no_emission_tile": 200000}.get(case, 12000)
    span = _span(cuda, b, n)
    hi = {"short": 6, "cap_mid_span": 9, "cap_at_span_start": 9}.get(case,
                                                                     41)
    keys = np.full((b, n), SENT, np.int64)
    for s in range(b):
        sizes = rng.integers(1, hi, n)
        if case == "no_emission_tile":  # rows 72 .. 1,039 emit nothing
            sizes[:2] = 40, 1000
        sizes = sizes[:np.searchsorted(np.cumsum(sizes), n - n // 10)]
        if s == 0:
            sizes0 = sizes
            if case == "cap_at_span_start":  # pillar j + 1 starts at 2 span
                ends = np.cumsum(sizes)
                j = int(np.searchsorted(ends, 2 * span))
                sizes[j] -= ends[j] - 2 * span
        if case == "sentinel" and s == 1:
            continue
        cells = np.sort(rng.choice(nx * ny, len(sizes), replace=False))
        k = np.repeat(cells, sizes)
        keys[s, :len(k)] = k
    starts = np.cumsum(sizes0) - sizes0
    maxV = 40000
    if case == "cap_mid_span":
        maxV = int(np.flatnonzero((starts % span > 0) &
                                  (starts > 2 * span))[0])
    elif case == "cap_at_span_start":
        maxV = int(np.flatnonzero(starts == 2 * span)[0])
    pts = np.ascontiguousarray(rng.uniform(
        [0., -39.68, -3., 0.], [69.12, 39.68, 1., 1.],
        (b, n, 4)).transpose(0, 2, 1), dtype=np.float32)
    w1t = rng.normal(0, .3, (64, 9)).astype(np.float32)
    kw = dict(P=P, maxV=maxV, nx=nx, vx=0.16, vy=0.16, x_off=0.08,
              y_off=-39.6, with_distance=False)
    return (torch.from_numpy(keys.astype(np.int32)).to(cuda),
            torch.from_numpy(pts).to(cuda), torch.from_numpy(w1t).to(cuda),
            kw, sizes0, span)


PFN1_EDGES = PFN_TRAIN_EDGES + ["no_emission_tile", "c_in3", "c_in8",
                                "distance", "u1_32", "u1_128"]


def _pfn1_edge(cuda, case):
    """The one-layer kernel at its span and tile edges (the train kernels'
    spans and machinery), bit for bit against its plain version and a
    second call, with and without occupancy: _pfn_train_edge's cases
    (pillars across span edges and a span's inner 256-row tile edges, the
    maxV cap inside a span and on a span's first row, n not a multiple of
    the span, n < P, one scan, a scan of sentinels), whole tiles with no
    emission row, and on span_edge's keys C_in 3 and 8, with_distance, u1
    32 (a group of 32 channels) and 128 (two groups of 64)."""
    base = case if case in PFN_TRAIN_EDGES + ["no_emission_tile"] \
        else "span_edge"
    keys, pts_t, w1t, kw, sizes, span = _pfn_train_edge(cuda, base)
    b, n = keys.shape
    rng = np.random.default_rng(100 + PFN1_EDGES.index(case))
    c_in = {"c_in3": 3, "c_in8": 8}.get(case, 4)
    u1 = {"u1_32": 32, "u1_128": 128}.get(case, 64)
    kw["with_distance"] = case == "distance"
    if case != base:
        lo = np.array([0., -39.68, -3.] + [0.] * (c_in - 3))
        hi = np.array([69.12, 39.68, 1.] + [1.] * (c_in - 3))
        pts_t = torch.from_numpy(np.ascontiguousarray(rng.uniform(
            lo, hi, (b, n, c_in)).transpose(0, 2, 1), dtype=np.float32)
        ).to(cuda)
        w1t = torch.from_numpy(rng.normal(
            0, .3, (u1, c_in + 5 + int(kw["with_distance"]))).astype(
                np.float32)).to(cuda)
    b1 = torch.from_numpy(rng.normal(0, .1, (u1, 1)).astype(np.float32)
                          ).to(cuda)
    for occupancy in (False, True):
        kw1 = dict(kw, n_layers=1, occupancy=occupancy)
        before = _build.LAUNCHES["fused_pfn_rows"]
        got = fused_pfn.fused_pfn_rows(keys, pts_t, w1t, b1, **kw1)
        again = fused_pfn.fused_pfn_rows(keys, pts_t, w1t, b1, **kw1)
        ref = fused_pfn.fused_pfn_rows_plain(keys, pts_t, w1t, b1, **kw1)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["fused_pfn_rows"] == before + 2
        assert got.shape == (b, u1 + occupancy, n)
        assert _same_bits(got, ref) and _same_bits(again, got)
    emit = ref[0, -1].cpu().numpy()           # scan 0's emission rows
    starts = np.cumsum(sizes) - sizes
    kept_ends = starts + np.minimum(sizes, kw["P"]) - 1
    assert emit.sum() > 0
    if case == "span_edge":
        assert (starts // span != kept_ends // span).sum() > 10
    elif case == "tiles":   # pillars across a span's inner tile edges
        edges = (np.arange(0, n, span)[:, None] +
                 np.arange(256, span, 256)).ravel()
        assert span > 256 and ((starts[:, None] < edges) &
                               (edges <= kept_ends[:, None])).any()
    elif case == "no_emission_tile":   # rows 72 .. 1,039: one pillar
        assert span > 512 and emit[:72].sum() == 2 and \
            not emit[72:1040].any()
    elif case.startswith("cap"):
        assert emit.sum() == kw["maxV"] and (
            starts[kw["maxV"]] == 2 * span if case == "cap_at_span_start"
            else starts[kw["maxV"]] % span > 0)
    elif case == "ragged":
        assert n % span > 0 and n > span
    elif case == "short":
        assert n < kw["P"]
    elif case == "sentinel":
        assert not ref[1].any()


PFN_EDGES = [(2, c) for c in PFN2_EDGES] + [(1, c) for c in PFN1_EDGES]


@pytest.mark.parametrize("layers,case", PFN_EDGES,
                         ids=["{}l-{}".format(*e) for e in PFN_EDGES])
def test_fused_pfn_tile_edges(cuda, layers, case):
    """K1 at its tile and span edges, one and two layers (_pfn1_edge,
    _pfn2_edge): bit for bit against the plain version."""
    (_pfn2_edge if layers == 2 else _pfn1_edge)(cuda, case)


@pytest.mark.parametrize("case", PFN_TRAIN_EDGES)
def test_pfn_train_span_edges(cuda, case):
    """K3 and K4 at their span edges (see _pfn_train_edge): within 1e-9
    of each output's largest plain value, the kept count exact, a second
    call bit-equal."""
    keys, pts_t, w1t, kw, sizes, span = _pfn_train_edge(cuda, case)
    b, n = keys.shape
    stats = fused_pfn_train.pfn_stats(keys, pts_t, w1t, **kw)
    ref = fused_pfn_train.pfn_stats_plain(keys, pts_t, w1t, **kw)
    torch.cuda.synchronize()
    assert stats[2].item() == ref[2].item() > 0
    for g, r in zip(stats, ref):
        _close(g, r, 1e-9)
    again = fused_pfn_train.pfn_stats(keys, pts_t, w1t, **kw)
    assert all(_same_bits(x, y) for x, y in zip(stats, again))
    rng = np.random.default_rng(n)
    u1 = w1t.shape[0]
    mu = (ref[0] / keys.numel()).float()
    invsig = torch.rsqrt((ref[1] / keys.numel() - mu.double() ** 2).float()
                         + 1e-3)
    a = invsig * torch.from_numpy(rng.uniform(.5, 1.5, u1).astype(
        np.float32)).to(cuda)
    c = torch.from_numpy(rng.normal(0, .5, u1).astype(np.float32)).to(cuda)
    g_t = torch.from_numpy(rng.normal(0, 1, (b, n, u1 + 1)).astype(
        np.float32)).to(cuda).transpose(1, 2)
    args = (keys, pts_t, g_t, w1t, a, c, mu, invsig)
    got = fused_pfn_train.pfn_bwd(*args, **kw)
    ref_bwd = fused_pfn_train.pfn_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    assert (ref_bwd[0] != 0).any()
    for g, r in zip(got, ref_bwd):
        _close(g, r, 1e-9)
    again = fused_pfn_train.pfn_bwd(*args, **kw)
    assert all(_same_bits(x, y) for x, y in zip(got, again))
    starts = np.cumsum(sizes) - sizes
    kept_ends = starts + np.minimum(sizes, kw["P"]) - 1
    if case == "span_edge":
        assert (starts // span != kept_ends // span).sum() > 10
    elif case == "tiles":   # pillars across a span's inner tile edges
        edges = (np.arange(0, n, span)[:, None] +
                 np.arange(256, span, 256)).ravel()
        assert span > 256 and ((starts[:, None] < edges) &
                               (edges <= kept_ends[:, None])).any()
    elif case == "cap_mid_span":
        assert starts[kw["maxV"]] % span > 0
    elif case == "cap_at_span_start":
        assert starts[kw["maxV"]] == 2 * span
    elif case == "ragged":
        assert n % span > 0 and n > span
    elif case == "short":
        assert n < kw["P"]
    elif case == "sentinel":
        one = fused_pfn_train.pfn_stats(keys[:1], pts_t[:1].contiguous(),
                                        w1t, **kw)
        assert one[2].item() == stats[2].item()
    if case.startswith("cap"):
        uncapped = fused_pfn_train.pfn_stats_plain(
            keys, pts_t, w1t, **dict(kw, maxV=40000))
        assert ref[2].item() < uncapped[2].item()


def test_pfn_train_refuse_wide_layers(cuda):
    """The train kernels hold at most 64 channels: a wider PFN raises
    before a launch."""
    keys = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    pts_t = torch.zeros((1, 4, 4), device=cuda)
    before = _build.LAUNCHES["pfn_stats"]
    with pytest.raises(ValueError, match="unsupported widths"):
        fused_pfn_train.pfn_stats(keys, pts_t, torch.zeros((65, 9),
                                                          device=cuda),
                                  P=4, maxV=10, nx=4, vx=1., vy=1., x_off=.5,
                                  y_off=.5)
    assert _build.LAUNCHES["pfn_stats"] == before


def _gather_keys(case, b=4, n=5000, cells=30000):
    """Sorted keys for K5: random cells with a sentinel tail, an empty scan,
    a 300-row run and keys below 0; every key the sentinel; a run of 1,500
    rows across block boundaries; n not a multiple of 4."""
    rng = np.random.default_rng(2)
    if case == "odd n":
        n = 4999
    keys = np.sort(rng.integers(0, cells, (b, n)), axis=1)
    keys[:, -500:] = SENT
    keys[1] = SENT                              # an empty batch row
    keys[0, 100:400] = keys[0, 100]             # a long duplicate run
    keys[2, :7] = -1                            # below the grid
    if case == "long run":
        keys[3, 1000:2500] = keys[3, 1000]
    if case == "sentinel":
        keys[:] = SENT
    return torch.from_numpy(np.sort(keys, axis=1).astype(np.int32))


# (layout, c, split, g_extra given, keys): the cotangent channel-major ("cm",
# the pillar canvas's NCHW gradient), row-major ("rm"; "rm offset" not
# 16-byte aligned), the dense BEV's permuted gradient over 2 z planes (a
# row-major copy) and over 1 (a channel-major view), and other strides
GATHER_CASES = (
    ("cm", 65, True, False, "random"), ("cm", 65, True, True, "random"),
    ("cm", 65, False, False, "random"), ("rm", 64, False, False, "random"),
    ("rm", 65, True, True, "random"), ("rm", 256, False, False, "random"),
    ("rm offset", 64, False, False, "random"),
    ("cm", 256, False, False, "long run"), ("bev", 64, False, False, "random"),
    ("bev1", 64, False, False, "random"), ("strided", 65, True, True, "random"),
    ("cm", 1, False, False, "random"), ("rm", 1, False, False, "random"),
    ("cm", 64, False, False, "sentinel"), ("rm", 65, True, False, "sentinel"),
    ("cm", 65, True, False, "long run"), ("rm", 64, False, False, "odd n"),
    ("cm", 65, True, True, "odd n"))


def _cotangent(layout, b, cells, c, gen, device):
    """g [b, cells, c] in the layout named."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    if layout == "cm":
        return randn(b, c, cells).transpose(1, 2)
    if layout == "rm":
        return randn(b, cells, c)
    if layout == "rm offset":
        return randn(b, cells, c + 1)[..., 1:]
    if layout == "strided":
        return randn(b, cells, 2 * c)[..., ::2]
    # the dense BEV: canvas [b, d*h*w, c] -> [b, h, w, d*c] -> NCHW; its
    # gradient back through the same views (a copy where they do not merge)
    d = 2 if layout == "bev" else 1
    h, w = 100, cells // (100 * d)
    g_nchw = randn(b, d * c, h, w)
    return g_nchw.permute(0, 2, 3, 1).reshape(b, h, w, d, c).permute(
        0, 3, 1, 2, 4).reshape(b, d * h * w, c)


@pytest.mark.parametrize("layout,c,split,extra,keys_case", GATHER_CASES)
def test_sorted_table_gather_matches_plain(cuda, layout, c, split, extra,
                                           keys_case):
    """K5 bit for bit against its plain version (a gather: tolerance 0) at
    every layout the paths hand it, split with and without g_extra, at
    c = 1 to 256, on sentinel-only scans, long runs and odd n."""
    keys = _gather_keys(keys_case).to(cuda)
    b, cells = keys.shape[0], 30000
    gen = torch.Generator(device=cuda).manual_seed(5)
    g = _cotangent(layout, b, cells, c, gen, cuda)
    if layout == "bev":
        assert g.is_contiguous()
    if layout == "bev1":
        assert g.stride()[1] == 1
    g_main = g[..., :-1] if split else g
    g_extra = g[..., -1:] if extra else None
    before = _build.LAUNCHES["sorted_table_gather"]
    got = sorted_scatter.sorted_table_gather(keys, g_main, g_extra, cells, c)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sorted_table_gather"] == before + 1
    ref = sorted_scatter.sorted_table_gather_plain(keys, g_main, g_extra,
                                                   cells, c)
    assert _same_bits(got, ref)
    inside = (keys >= 0) & (keys < cells)
    assert not got[~inside].any()
    if split and not extra:
        assert not got[..., -1].any()
    if keys_case == "sentinel":
        assert not got.any()


def test_train_canvas_on_card_matches_cpu(cuda):
    """The tiny config's train-mode canvas, K1-K5 on the card against the
    plain versions on the CPU: canvas, occupancy, running stats and the
    PFN grads."""
    from paddle3d_tpu_torch.apis import Config
    from paddle3d_tpu_torch.ops.pillar_ops import fused_pillar_canvas
    path = os.path.join(REPO, "configs", "pointpillars",
                        "pointpillars_synthetic_tiny.yml")
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform([0, -16, -2, 0], [32, 16, 2, 1],
                                       (2, 1024, 4)).astype(np.float32))
    pts[:, :400, :2] = pts[:, :1, :2] + torch.from_numpy(rng.normal(
        0, .2, (2, 400, 2)).astype(np.float32))     # pillars over P
    results = []
    for device in ("cpu", cuda):
        model = Config(path=path, device=device).model.train()
        mods = (model.voxelizer, model.pillar_encoder, model.middle_encoder)
        canvas, occ = fused_pillar_canvas(*mods, pts.to(device), True,
                                          with_occupancy=True)
        w = torch.from_numpy(rng.normal(0, 1, canvas.shape).astype(
            np.float32)) if device == "cpu" else w.to(device)
        (canvas * w).sum().backward()
        mlp = model.pillar_encoder.pfn_layers[0].mlp
        results.append([t.detach().cpu() for t in (
            canvas, occ, mlp.bn.running_mean, mlp.bn.running_var,
            mlp.linear.weight.grad, mlp.bn.weight.grad, mlp.bn.bias.grad)])
    cpu, card = results
    torch.testing.assert_close(card[1], cpu[1], rtol=0, atol=0)
    for got, ref in zip(card[:1] + card[2:], cpu[:1] + cpu[2:]):
        _close(got, ref, 1e-5)


def _voxel_set(seed, grid, b=2, v=4000, cin=16, dense_planes=0):
    """Sorted unique voxel coords per scan with a masked tail and the
    layers' distinct padding keys D*H*W + 7 + row; dense_planes fills the
    lowest z layers completely (long spans of in_keys)."""
    from paddle3d_tpu_torch.models.layers.sparse_layers import SparseConv3D
    rng = np.random.default_rng(seed)
    d, h, w = grid
    coords = np.zeros((b, v, 3), np.int32)
    mask = np.zeros((b, v), bool)
    for i in range(b):
        lin = rng.integers(0, d * h * w, v)
        lin[:dense_planes * h * w] = np.arange(dense_planes * h * w)
        uk = np.unique(lin)[:v - 50 * (i + 1)]
        coords[i, :len(uk)] = np.stack([uk // (h * w), uk // w % h, uk % w],
                                       -1)
        mask[i, :len(uk)] = True
    feats = rng.normal(size=(b, v, cin)).astype(np.float32)
    feats[~mask] = 0.0
    coords, mask = torch.from_numpy(coords), torch.from_numpy(mask)
    return coords, mask, SparseConv3D._lin_keys(coords, mask, grid), \
        torch.from_numpy(feats)


SPARSE_CASES = {   # name: (grid, kernel_size, stride, cin, cout, planes)
    "subm_stem": ((41, 64, 64), 3, 1, 5, 16, 0),
    "subm_128": ((5, 24, 24), 3, 1, 128, 128, 0),
    "strided": ((41, 64, 64), 3, 2, 16, 32, 0),
    "z_stride": ((5, 24, 24), 3, (2, 1, 1), 128, 128, 0),
    "k1": ((9, 32, 32), 1, 1, 32, 48, 0),
    "long_spans": ((6, 40, 40), 3, 1, 8, 64, 2),
}


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_sparse_conv3d_matches_plain(cuda, case, fused):
    """K8 against its plain version, which repeats the kernel's products
    and sums in its order: bit-equal. Submanifold and strided, K = 1 and
    3, every output width of the path, and spans of in_keys longer than
    the kernel stages in shared memory (dense planes under a sparse
    query set)."""
    from paddle3d_tpu_torch.models.layers.sparse_layers import SparseConv3D
    from paddle3d_tpu_torch.ops import sparse_conv
    from paddle3d_tpu_torch.ops.sparse import downsample_coords
    grid, ks, stride, cin, cout, planes = SPARSE_CASES[case]
    coords, mask, keys, feats = _voxel_set(1, grid, cin=cin,
                                           dense_planes=planes)
    rng = np.random.default_rng(2)
    w = torch.from_numpy((rng.normal(size=(ks ** 3 * cin, cout)) * .1)
                         .astype(np.float32))
    kw = {}
    if fused:
        kw = dict(scale=torch.from_numpy(rng.uniform(.5, 1.5, cout).astype(
            np.float32)).to(cuda), shift=torch.from_numpy(rng.normal(
                0, .5, cout).astype(np.float32)).to(cuda), relu=True)
    if stride == 1 and planes == 0:
        qbase = keys
    elif stride == 1:               # a sparse query set over dense planes
        qbase = keys[:, ::37].contiguous()
    else:
        oc, om = downsample_coords(coords, mask, grid, stride, 1500)
        sv = torch.tensor(stride if isinstance(stride, tuple) else
                          (stride,) * 3, dtype=torch.int32)
        qbase = SparseConv3D._lin_keys(oc * sv, om, grid)
    args = (qbase.to(cuda), keys.to(cuda), feats.to(cuda), w.to(cuda),
            *grid, ks)
    before = _build.LAUNCHES["sparse_conv3d"]
    got = sparse_conv.sparse_conv3d(*args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sparse_conv3d"] == before + 1
    ref = sparse_conv.sparse_conv3d_plain(*args, **kw)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert got.abs().max() > 0
    d, h, w_ = grid
    pad = (qbase < 0) | (qbase >= d * h * w_)
    assert not got[pad.to(cuda)].any()          # padding rows exactly zero


def test_sparse_conv3d_refuses_what_it_cannot_take(cuda):
    """The conv and map kernels raise on CUDA inputs they cannot take
    (type, output width, contiguity, a map of another type or shape) and
    never take the plain version on the card: no launch is counted."""
    from paddle3d_tpu_torch.ops import sparse_conv
    keys = torch.arange(8, dtype=torch.int32, device=cuda)[None]
    feats = torch.zeros((1, 8, 4), device=cuda)
    w = torch.zeros((108, 16), device=cuda)
    nbr = sparse_conv.sparse_conv3d_map(keys, keys, 2, 2, 2, 3)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match="multiple of 16"):
        sparse_conv.sparse_conv3d(keys, keys, feats, torch.zeros(
            (108, 24), device=cuda), 2, 2, 2, 3)
    with pytest.raises(TypeError, match="f32"):
        sparse_conv.sparse_conv3d(keys, keys, feats.double(), torch.zeros(
            (108, 16), device=cuda, dtype=torch.float64), 2, 2, 2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        sparse_conv.sparse_conv3d(keys, keys, torch.zeros(
            (1, 4, 8), device=cuda).transpose(1, 2), w, 2, 2, 2, 3)
    with pytest.raises(TypeError, match="int32 map"):
        sparse_conv.sparse_conv3d(keys, keys, feats, w, 2, 2, 2, 3,
                                  nbr=nbr.long())
    with pytest.raises(ValueError, match="nbr"):
        sparse_conv.sparse_conv3d(keys, keys, feats, w, 2, 2, 2, 3,
                                  nbr=nbr[..., :1].contiguous())
    with pytest.raises(TypeError, match="int32 keys"):
        sparse_conv.sparse_conv3d_map(keys.long(), keys.long(), 2, 2, 2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        sparse_conv.sparse_conv3d_map(keys[:, ::2], keys, 2, 2, 2, 3)
    with pytest.raises(ValueError, match="kernel_size"):
        sparse_conv.sparse_conv3d_map(keys, keys, 2, 2, 2, 5)
    assert _build.LAUNCHES == before


def _map_case(name):
    """(qbase, in_keys, grid, kernel_size) of a MAP_CASES entry, on the
    CPU."""
    from paddle3d_tpu_torch.models.layers.sparse_layers import SparseConv3D
    from paddle3d_tpu_torch.ops.sparse import downsample_coords
    grid, ks, stride, planes = MAP_CASES[name]
    if name == "grid_edges":
        # every voxel of a small grid: a neighbour that wrapped across an x
        # or y edge would land on a present key
        d, h, w = grid
        lin = np.arange(d * h * w)
        coords = torch.from_numpy(np.stack(
            [lin // (h * w), lin // w % h, lin % w], -1).astype(np.int32))
        coords = coords[None].repeat(2, 1, 1)
        mask = torch.ones((2, d * h * w), dtype=torch.bool)
        mask[1, 50:] = False
        keys = SparseConv3D._lin_keys(coords, mask, grid)
    else:
        coords, mask, keys, _ = _voxel_set(3, grid, dense_planes=planes)
        if name == "all_padding":
            mask[1, 40:] = False           # tiles of padding rows only
            keys = SparseConv3D._lin_keys(coords, mask, grid)
    if stride == 1:
        qbase = keys if planes == 0 else keys[:, ::37].contiguous()
    else:
        oc, om = downsample_coords(coords, mask, grid, stride, 1500)
        sv = torch.tensor(stride if isinstance(stride, tuple) else
                          (stride,) * 3, dtype=torch.int32)
        qbase = SparseConv3D._lin_keys(oc * sv, om, grid)
    return qbase, keys, grid, ks


MAP_CASES = {   # name: (grid, kernel_size, stride, dense planes)
    "subm": ((41, 64, 64), 3, 1, 0),
    "subm_k1": ((9, 32, 32), 1, 1, 0),
    "strided": ((41, 64, 64), 3, 2, 0),
    "z_stride": ((5, 24, 24), 3, (2, 1, 1), 0),
    "strided_k1": ((9, 32, 32), 1, 2, 0),
    "long_spans": ((6, 40, 40), 3, 1, 2),
    "all_padding": ((41, 64, 64), 3, 1, 0),
    "grid_edges": ((4, 6, 5), 3, 1, 0),
}


@pytest.mark.parametrize("case", sorted(MAP_CASES))
def test_sparse_conv_map_matches_neighbour_map(cuda, case):
    """The map kernel equals neighbour_map element for element: K = 1 and
    3, submanifold and strided, tiles of padding only, z-group spans of
    more than 1,024 keys (dense planes under a sparse query set), and every
    x and y edge of a full grid (no wrap across rows)."""
    from paddle3d_tpu_torch.ops import sparse_conv
    qbase, keys, grid, ks = _map_case(case)
    if case == "long_spans":
        assert keys.shape[1] > 1024 and 2 * 40 * 40 > 1024
    ref = sparse_conv.neighbour_map(qbase, keys, *grid, ks)
    before = _build.LAUNCHES["sparse_conv3d_map"]
    got = sparse_conv.sparse_conv3d_map(qbase.to(cuda), keys.to(cuda), *grid,
                                        ks)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sparse_conv3d_map"] == before + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == tuple(ref.shape)
    torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=0)
    assert (ref >= 0).any()
    if case == "all_padding":
        assert (ref[1, 40:] == -1).all()
    if case == "grid_edges":
        assert (ref[0] >= 0).sum(dim=1).max() == 27


def _hit_patterns(grid=(20, 40, 40), b=2, v=1200):
    """Sorted voxel sets whose tiles hit one tap (isolated voxels: only the
    centre), all 27 (the inside of dense 6 x 6 x 6 blocks) and none (a
    scan of padding rows after a few voxels)."""
    from paddle3d_tpu_torch.models.layers.sparse_layers import SparseConv3D
    d, h, w = grid
    iso = np.stack(np.meshgrid(np.arange(0, 6, 3), np.arange(0, 40, 3),
                               np.arange(0, 40, 3), indexing="ij"),
                   -1).reshape(-1, 3)
    blk = np.stack(np.meshgrid(np.arange(10, 16), np.arange(10, 16),
                               np.arange(10, 16), indexing="ij"),
                   -1).reshape(-1, 3) + [0, 5, 20]
    coords = np.zeros((b, v, 3), np.int32)
    mask = np.zeros((b, v), bool)
    scan0 = np.concatenate([iso, blk])
    lin = scan0[:, 0] * h * w + scan0[:, 1] * w + scan0[:, 2]
    scan0 = scan0[np.argsort(lin)]
    coords[0, :len(scan0)] = scan0
    mask[0, :len(scan0)] = True
    coords[1, :5] = iso[:5]
    mask[1, :5] = True
    coords, mask = torch.from_numpy(coords), torch.from_numpy(mask)
    return SparseConv3D._lin_keys(coords, mask, grid), grid


@pytest.mark.parametrize("prebuilt", [False, True], ids=["own", "prebuilt"])
@pytest.mark.parametrize("cin,cout", [(4, 16), (16, 32), (128, 48),
                                      (4, 64), (16, 80), (128, 96),
                                      (4, 112), (128, 128)])
def test_sparse_conv3d_hits_only_matches_plain(cuda, cin, cout, prebuilt):
    """K8 over a map, bit-equal to its plain version for every output width
    and Cin 4 (float4 rows), 16 and 128 (four channel chunks), on tiles
    whose rows hit one tap, all 27, or none, with the map built by the conv
    itself or handed to it (no second map launch then)."""
    from paddle3d_tpu_torch.ops import sparse_conv
    keys, grid = _hit_patterns()
    rng = np.random.default_rng(cin + cout)
    feats = rng.normal(size=keys.shape + (cin,)).astype(np.float32)
    feats[keys.numpy() >= np.prod(grid)] = 0.0
    w = (rng.normal(size=(27 * cin, cout)) * .1).astype(np.float32)
    shift = rng.normal(0, .5, cout).astype(np.float32)
    args = (keys.to(cuda), keys.to(cuda), torch.from_numpy(feats).to(cuda),
            torch.from_numpy(w).to(cuda), *grid, 3)
    kw = dict(shift=torch.from_numpy(shift).to(cuda), relu=True)
    nbr = sparse_conv.sparse_conv3d_map(*args[:2], *grid, 3)
    hits = (nbr >= 0).sum(dim=-1)
    assert hits.max() == 27 and (hits[0] == 1).any() and (hits[1] == 0).any()
    before = dict(_build.LAUNCHES)
    got = sparse_conv.sparse_conv3d(*args, **kw,
                                    nbr=nbr if prebuilt else None)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sparse_conv3d"] == before["sparse_conv3d"] + 1
    assert _build.LAUNCHES["sparse_conv3d_map"] == \
        before["sparse_conv3d_map"] + (0 if prebuilt else 1)
    ref = sparse_conv.sparse_conv3d_plain(*args, **kw)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert got.abs().max() > 0
    assert not got[1, 5:].any()                 # padding rows exactly zero


@pytest.mark.parametrize("split", [False, True])
def test_sorted_segment_sum_dense_matches_plain(cuda, split):
    """K7 on a dense scan (the density rule sends it there, not to K2):
    every eighth cell used, ~2.5 rows each, a long duplicate run, keys past
    the table, sentinel tails and an empty scan, at the voxel BEV's 64,800
    cells."""
    cells, c = 2 * 180 * 180, 129 if split else 128
    keys, rows = _scatter_inputs(6, b=4, n=20000, c=c,
                                 num_cells=cells // 8 + 50)
    keys = torch.where(keys == SENT, keys, keys * 8)
    keys, rows = keys.to(cuda), rows.to(cuda)
    assert sorted_scatter.kernel_for(20000, cells) == \
        "sorted_segment_sum_dense"
    before = dict(_build.LAUNCHES)
    fn = (sorted_scatter.sorted_segment_sum_split if split
          else sorted_scatter.sorted_segment_sum)
    got = fn(keys, rows, cells)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sorted_segment_sum_dense"] == \
        before["sorted_segment_sum_dense"] + 1
    assert _build.LAUNCHES["sorted_segment_sum"] == \
        before["sorted_segment_sum"]
    ref = _row_order_sum(keys, rows, cells)
    got = torch.cat(got, dim=-1) if split else got
    # sums of up to 300 rows, in row order as the kernel adds them
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert not got[1].any()


DENSE_EDGE_CASES = ["random", "long_cell", "empty_spans"]


@pytest.mark.parametrize("c", [1, 3, 64, 65, 128, 129, 256, 300])
@pytest.mark.parametrize("case", DENSE_EDGE_CASES)
def test_sorted_segment_sum_dense_edges(cuda, case, c):
    """K7 bit for bit at its edges, 3 scans of 12,000 rows onto 9,001 cells
    (dense by the density rule), each with keys past the table, negative
    keys and a last scan all sentinel: 'long_cell' one cell holding 9,000
    rows (a segment across chunks at every c), 'empty_spans' rows only at
    the two ends of the table (runs of spans with no row). Contiguous rows
    [B, N, c]: where c is no multiple of 4 most chunks start off a 16-byte
    boundary; c = 300 takes two channel groups; the split form at c = 65,
    129 and 300. Through the wrapper against the row-order sum and a second
    call, and through the C entry into a NaN-filled table (every cell
    written)."""
    b, n, cells = 3, 12000, 9001
    split = c in (65, 129, 300)
    rng = np.random.default_rng(10 * c + DENSE_EDGE_CASES.index(case))
    keys = rng.integers(-3, cells + 40, (b, n))
    if case == "long_cell":
        keys[0, 1000:10000] = 4321
    elif case == "empty_spans":
        keys = np.where(keys % 2 == 0, keys % 700, cells - 1 - keys % 700)
    keys[-1] = SENT
    keys = torch.from_numpy(np.sort(keys, axis=1).astype(np.int32)).to(cuda)
    rows = torch.from_numpy(rng.normal(0, 1, (b, n, c)).astype(
        np.float32)).to(cuda)
    assert sorted_scatter.kernel_for(n, cells) == "sorted_segment_sum_dense"
    ref = _row_order_sum(keys, rows, cells)
    before = dict(_build.LAUNCHES)
    got, again = (sorted_scatter.scatter_rows(keys, rows, cells, split)
                  for _ in range(2))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sorted_segment_sum_dense"] == \
        before["sorted_segment_sum_dense"] + 2
    if split:
        got, again = torch.cat(got, dim=-1), torch.cat(again, dim=-1)
    assert _same_bits(got, ref) and _same_bits(again, got)
    assert not got[-1].any()
    out = torch.full((b, cells, c - int(split)), float("nan"), device=cuda)
    extra = torch.full((b, cells, 1), float("nan"), device=cuda)
    _build.check(_build.function("p3d_sorted_segment_sum_dense")(
        keys.data_ptr(), rows.data_ptr(), out.data_ptr(),
        extra.data_ptr() if split else None, b, n, c, cells,
        _build.stream_ptr(keys.device)), "sorted_segment_sum_dense")
    torch.cuda.synchronize()
    assert _same_bits(torch.cat([out, extra], dim=-1) if split else out, ref)


CM_EDGE_CASES = ["strided", "transposed", "long_cell", "empty_tiles"]
CM_EDGE_CELLS = 9001   # no multiple of any tile of the K6 / K13 kernel


def _cm_edge_inputs(case, c, cuda, b=3, n=12000, cells=CM_EDGE_CELLS):
    """Sorted keys and channel-major rows at the edges of the kernel K6 and
    K13 share, each with keys past the table, negative keys and a last
    batch row all sentinel: 'strided' reads a view [B, c + 3, N + 3] of a
    wider buffer (N + 3 is no multiple of 4, so most channel rows start off
    a 16-byte boundary); 'transposed' a [B, N + 3, c + 3] buffer viewed
    channel-major (no channel row is contiguous: 4-byte copies only);
    'long_cell' one cell holding 40 rows more than a stage buffer
    ((8192 // c) & ~3 rows); 'empty_tiles' rows only at the two ends of
    the table (runs of tiles with no row between)."""
    rng = np.random.default_rng(10 * c + CM_EDGE_CASES.index(case))
    keys = rng.integers(-3, cells + 40, (b, n))
    if case == "long_cell":
        keys[0, 100:100 + ((8192 // c) & ~3) + 40] = 4321
    elif case == "empty_tiles":
        keys = np.where(keys % 2 == 0, keys % 700, cells - 1 - keys % 700)
    keys[-1] = SENT
    keys = torch.from_numpy(np.sort(keys, axis=1).astype(np.int32)).to(cuda)
    if case == "transposed":
        wide = torch.from_numpy(rng.normal(0, 1, (b, n + 3, c + 3)).astype(
            np.float32)).to(cuda).transpose(1, 2)
    else:
        wide = torch.from_numpy(rng.normal(0, 1, (b, c + 3, n + 3)).astype(
            np.float32)).to(cuda)
    return keys, wide


@pytest.mark.parametrize("c", [1, 3, 64, 65, 256])
@pytest.mark.parametrize("case", CM_EDGE_CASES)
def test_segment_sum_cm_rw_kernel_edges(cuda, case, c):
    """K6 and K13, one kernel, bit for bit at its edges (_cm_edge_inputs,
    9,001 cells): K6 through its wrapper (the split form at c = 65) against
    the row-order sum, and through its C entry into a NaN-filled table
    (every cell written); K13 where c divides 128 against its plain version
    and K6, and refusing the other widths."""
    keys, wide = _cm_edge_inputs(case, c, cuda)
    b, n = keys.shape
    cells, split = CM_EDGE_CELLS, c == 65
    ref = _row_order_sum(keys, wide[:, :c, :n].transpose(1, 2), cells)
    before = dict(_build.LAUNCHES)
    got = sorted_scatter.sorted_segment_sum_cm(keys, wide, cells, c=c,
                                               split_last=split)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sorted_segment_sum_cm"] == \
        before["sorted_segment_sum_cm"] + 1
    got = torch.cat(got, dim=-1) if split else got
    assert torch.equal(got, ref)
    assert not got[-1].any()
    out = torch.full((b, cells, c - 1 if split else c), float("nan"),
                     device=cuda)
    extra = torch.full((b, cells, 1), float("nan"), device=cuda)
    _build.check(_build.function("p3d_sorted_segment_sum_cm")(
        keys.data_ptr(), wide.data_ptr(), *wide.stride(), out.data_ptr(),
        extra.data_ptr() if split else None, b, n, c, cells,
        _build.stream_ptr(keys.device)), "sorted_segment_sum_cm")
    torch.cuda.synchronize()
    # NaN-filled first: every cell must be written
    assert torch.equal(torch.cat([out, extra], dim=-1) if split else out,
                       ref)
    if 128 % c == 0:
        rw = sorted_scatter.sorted_segment_sum_rw(keys, wide, c, cells)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["sorted_segment_sum_rw"] == \
            before["sorted_segment_sum_rw"] + 1
        assert torch.equal(rw, sorted_scatter.sorted_segment_sum_rw_plain(
            keys, wide, c, cells))
        assert torch.equal(rw, got)
    else:
        with pytest.raises(ValueError, match="dividing 128"):
            sorted_scatter.sorted_segment_sum_rw(keys, wide, c, cells)


RW_CASES = [(2, 5000, 64, 4096), (2, 1200, 16, 65536), (1, 4096, 8, 1024),
            (2, 700, 32, 2048), (3, 9000, 128, 5000)]


@pytest.mark.parametrize("b,n,c,cells", RW_CASES)
def test_sorted_segment_sum_rw_matches_row_order(cuda, b, n, c, cells):
    """K13 bit for bit against the row-order sum and its plain version, at
    the CPU test's shapes plus one with a 3,000-row segment (it crosses many
    row windows); keys past the table, negative keys, an empty batch row
    (b > 1) and a channel-major view wider and longer than read."""
    rng = np.random.default_rng(n)
    keys = np.sort(rng.integers(0, cells + 40, (b, n)), axis=1)
    keys[0, :5] = -2
    if n >= 9000:
        keys[0, 2000:5000] = keys[0, 2000]       # the 3,000-row segment
    if b > 1:
        keys[-1] = SENT
    keys = torch.from_numpy(np.sort(keys, axis=1).astype(np.int32)).to(cuda)
    wide = torch.from_numpy(rng.normal(0, 1, (b, c + 3, n + 300)).astype(
        np.float32)).to(cuda)
    wide[:, c:] = 1e6
    wide[:, :, n:] = 1e6
    before = _build.LAUNCHES["sorted_segment_sum_rw"]
    got = sorted_scatter.sorted_segment_sum_rw(keys, wide, c, cells)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sorted_segment_sum_rw"] == before + 1
    ref = _row_order_sum(keys, wide[:, :c, :n].transpose(1, 2), cells)
    assert got.shape == (b, cells, c)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert torch.equal(got, sorted_scatter.sorted_segment_sum_rw_plain(
        keys, wide, c, cells))
    if b > 1:
        assert not got[-1].any()
    with pytest.raises(ValueError, match="dividing 128"):
        sorted_scatter.sorted_segment_sum_rw(keys, wide, 65, cells)


def _gather_case(cuda, c, layout, b=3, a=5000, k=1000, seed=0):
    """K14's inputs: src [B, A, C] in one of the layouts a caller hands it
    (contiguous; a column slice of wider rows; the NCHW view SMOKE passes,
    channel stride A; contiguous but 4 bytes off 16-byte alignment), idx
    [B, K] int32 with the ends, a repeat, wrapped negatives and indices
    past either end among random ones."""
    rng = np.random.default_rng(seed + c)
    vals = rng.normal(size=(b, a, c)).astype(np.float32)
    if layout == "contiguous":
        src = torch.from_numpy(vals).to(cuda)
    elif layout == "strided":
        wide = torch.zeros((b, a, c + 8), device=cuda)
        wide[..., 4:4 + c] = torch.from_numpy(vals).to(cuda)
        src = wide[..., 4:4 + c]
    elif layout == "nchw":
        src = torch.from_numpy(np.ascontiguousarray(vals.transpose(
            0, 2, 1))).to(cuda).transpose(1, 2)
    else:
        flat = torch.zeros(b * a * c + 1, device=cuda)
        flat[1:] = torch.from_numpy(vals.reshape(-1)).to(cuda)
        src = flat[1:].view(b, a, c)
    idx = rng.integers(0, a, (b, k)).astype(np.int32)
    if k >= 9:
        idx[0, :9] = [0, a - 1, 0, -1, -a, a, -a - 1, 2**31 - 1, -2**31]
    return src, torch.from_numpy(idx).to(cuda)


@pytest.mark.parametrize("c", [1, 7, 10, 16, 64, 65, 256])
@pytest.mark.parametrize("layout", ["contiguous", "strided", "nchw",
                                    "unaligned"])
def test_gather_rows_matches_plain(cuda, c, layout):
    """K14 bit for bit against its plain version (NaN rows equal by bit
    pattern): lane groups on float4 rows (c = 16, 64, 256, contiguous or a
    slice 16 bytes in), the flat form on the others (c = 1, 7, 10, 65, the
    NCHW view, the unaligned source); out-of-range indices wrapped once or
    NaN; one launch a call; int64 indices refused."""
    from paddle3d_tpu_torch.ops import gather
    src, idx = _gather_case(cuda, c, layout)
    before = _build.LAUNCHES["gather_rows"]
    got = gather.gather_rows(src, idx)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gather_rows"] == before + 1
    assert tuple(got.shape) == (3, 1000, c) and got.is_contiguous()
    assert _same_bits(got, gather.gather_rows_plain(src, idx))
    assert torch.isnan(got[0, 5:9]).all()
    assert not torch.isnan(got[0, :5]).any() and not torch.isnan(
        got[1:]).any()
    with pytest.raises(TypeError, match="int32"):
        gather.gather_rows(src, idx.long())


@pytest.mark.parametrize("b,a,k,c", [(3, 50, 0, 10), (0, 50, 7, 10),
                                     (70000, 3, 2, 10), (40000, 4, 3, 64)])
def test_gather_rows_empty_and_many_batch_rows(cuda, b, a, k, c):
    """K = 0 or B = 0: an empty result and no launch; tens of thousands of
    batch rows of a few indices each: bit-equal to the plain version."""
    from paddle3d_tpu_torch.ops import gather
    src, idx = _gather_case(cuda, c, "contiguous", b=b, a=a, k=k)
    before = _build.LAUNCHES["gather_rows"]
    got = gather.gather_rows(src, idx)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (b, k, c)
    assert _build.LAUNCHES["gather_rows"] == before + int(got.numel() > 0)
    assert _same_bits(got, gather.gather_rows_plain(src, idx))


def test_voxel_canvas_on_card_matches_cpu(cuda, tmp_path):
    """A tiny CenterPoint-voxels config (the nuScenes voxel config over
    16 m x 16 m at 0.125 m, 41 z layers): the BEV canvas through K8 and K7
    on the card against the plain versions on the CPU."""
    import yaml

    from paddle3d_tpu_torch.apis import Config
    rng_ = [0., -8., -2., 16., 8., 2.]
    vs = [0.125, 0.125, 0.1]
    path = tmp_path / "voxels_tiny.yml"
    path.write_text(yaml.safe_dump({
        "_base_": os.path.join(REPO, "configs", "centerpoint",
                               "centerpoint_voxels_0075voxel_nuscenes_"
                               "10sweep.yml"),
        "model": {"voxelizer": {"point_cloud_range": rng_, "voxel_size": vs,
                                "max_num_voxels": [1200, 1500]},
                  "middle_encoder": {"point_cloud_range": rng_,
                                     "voxel_size": vs},
                  "test_cfg": {"point_cloud_range": rng_, "voxel_size": vs}}}))
    rng = np.random.default_rng(0)
    pts = rng.uniform([0, -8, -2, 0, 0], [16, 8, 0, 1, .45], (2, 6000, 5))
    pts[:, :3000, :3] = rng.uniform([1, -7, -1.5], [15, 7, 1.9], (8, 3))[
        rng.integers(0, 8, 3000)] + rng.normal(0, [.8, .4, .3], (2, 3000, 3))
    pts = torch.from_numpy(pts.astype(np.float32))
    model = Config(path=str(path), device="cpu").model.eval()
    with torch.no_grad():
        ref = model._canvas(pts, False)
    model.cuda()
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        got = model._canvas(pts.to(cuda), False)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sparse_conv3d"] == before["sparse_conv3d"] + 21
    # one map a key set: stage 1's five subm convs, each later stage's four,
    # and the four strided convs
    assert _build.LAUNCHES["sparse_conv3d_map"] == \
        before["sparse_conv3d_map"] + 8
    _close(got.cpu(), ref, 1e-5)
    assert ref.abs().max() > 0


def _clustered(seed, b, n, valid, spread=1.0, box=20.):
    """[b, n, 3] points around 8 centres a scan; the first valid[i] valid."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((b, n, 3), np.float32)
    for i in range(b):
        centers = rng.uniform(-box, box, (8, 3))
        pts[i] = centers[rng.integers(0, 8, n)] + rng.normal(0, spread,
                                                             (n, 3))
    mask = np.arange(n)[None, :] < np.asarray(valid)[:, None]
    return torch.from_numpy(pts), torch.from_numpy(mask)


@pytest.mark.parametrize("n,m,nsample,radius", [
    (700, 200, 16, 1.2),          # ragged tiles, partial warps
    (2048, 27648, 16, 0.8),       # the PV-RCNN RoI grid's shape
    (20000, 2048, 16, 0.8),       # the keypoints on the raw scan
    (1000, 513, 8, 2.5),          # far more hits than nsample
    (4096, 1024, 32, 0.8),        # an IA-SSD layer
    (31, 5, 48, 3.0),             # nsample above a warp, one short tile
], ids=["ragged", "roi_grid", "raw_scan", "crowded", "iassd", "wide"])
def test_ball_query_matches_plain(cuda, n, m, nsample, radius):
    """K9 against its plain version, indices and counts equal: masked
    supports, queries on support points (d2 = 0), far queries (empty
    balls), full balls, one scan with no valid support."""
    from paddle3d_tpu_torch.ops import ball_query
    xyz, mask = _clustered(n, 3, n, [n, max(n // 3, 1), 0])
    rng = np.random.default_rng(m)
    pick = torch.from_numpy(rng.integers(0, n, (3, m)))
    q = torch.gather(xyz, 1, pick[..., None].expand(-1, -1, 3)) + \
        torch.from_numpy(rng.normal(0, 0.4, (3, m, 3)).astype(np.float32))
    q[:, :4] = xyz[:, :4]
    q[:, 4:5] = 500.
    before = dict(_build.LAUNCHES)
    idx, cnt = ball_query.ball_query_batched(radius, nsample, xyz.to(cuda),
                                             q.to(cuda), mask.to(cuda))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ball_query"] == before["ball_query"] + 1
    ref_idx, ref_cnt = ball_query.ball_query_plain(radius, nsample, xyz, q,
                                                   mask)
    assert idx.dtype == torch.int32 and cnt.dtype == torch.int32
    torch.testing.assert_close(cnt.cpu(), ref_cnt, rtol=0, atol=0)
    torch.testing.assert_close(idx.cpu(), ref_idx, rtol=0, atol=0)
    # the plain version on the card gives the same (its arithmetic there)
    card_idx, card_cnt = ball_query.ball_query_plain(
        radius, nsample, xyz.to(cuda), q.to(cuda), mask.to(cuda))
    torch.testing.assert_close(idx, card_idx, rtol=0, atol=0)
    torch.testing.assert_close(cnt, card_cnt, rtol=0, atol=0)
    assert not cnt[2].any() and not idx[2].any()
    assert (ref_cnt == 0).any() and (ref_cnt[0] > 0).any()


def test_ball_query_surface(cuda):
    """d2 <= r2 inclusive, r2 the double product rounded once to f32, sums
    without fused multiply-adds: lattice points at distance exactly r."""
    from paddle3d_tpu_torch.ops import ball_query
    g = torch.arange(-6, 7, dtype=torch.float32) * 0.25
    xyz = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(
        1, -1, 3)
    mask = torch.ones(xyz.shape[:2], dtype=torch.bool)
    q = torch.zeros((1, 3, 3))
    q[0, 1] = 0.125
    q[0, 2, 0] = 0.3
    for radius in (0.75, 0.8, 1.25, 1.0606601717798212):
        idx, cnt = ball_query.ball_query_batched(
            radius, 64, xyz.to(cuda), q.to(cuda), mask.to(cuda))
        ref_idx, ref_cnt = ball_query.ball_query_plain(radius, 64, xyz, q,
                                                       mask)
        torch.testing.assert_close(idx.cpu(), ref_idx, rtol=0, atol=0)
        torch.testing.assert_close(cnt.cpu(), ref_cnt, rtol=0, atol=0)


def _key_sorted(xyz, mask, cell=0.2):
    """Each scan's supports in the order of a voxel key (z, y, x cells of
    `cell` m), as the sparse stages hand them."""
    c = torch.floor(xyz / cell).to(torch.int64)
    c = c - c.amin(dim=1, keepdim=True)
    key = (c[..., 2] * 4096 + c[..., 1]) * 4096 + c[..., 0]
    order = torch.argsort(key, dim=1, stable=True)
    return (torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3)),
            torch.gather(mask, 1, order))


@pytest.mark.parametrize("queries", ["spread", "tight"])
@pytest.mark.parametrize("order", ["key", "shuffled"])
def test_ball_query_supports_in_key_and_shuffled_order(cuda, order,
                                                       queries):
    """The culled K9 index for index against its plain version with the
    supports in key order (small chunk boxes: most chunks skipped) and
    shuffled (wide boxes), the queries spread (random picks) or tight (in
    key order, as an RoI's grid points)."""
    from paddle3d_tpu_torch.ops import ball_query
    n, m, nsample, radius = 6000, 2048, 16, 0.8
    xyz, mask = _clustered(7, 3, n, [n, n // 2, n // 5], spread=1.5)
    xyz, mask = _key_sorted(xyz, mask)
    rng = np.random.default_rng(11)
    if order == "shuffled":
        perm = torch.from_numpy(rng.permutation(n))
        xyz, mask = xyz[:, perm].contiguous(), mask[:, perm].contiguous()
    pick = torch.from_numpy(rng.integers(0, n, (3, m)))
    q = torch.gather(xyz, 1, pick[..., None].expand(-1, -1, 3)) + \
        torch.from_numpy(rng.normal(0, 0.3, (3, m, 3)).astype(np.float32))
    if queries == "tight":
        q, _ = _key_sorted(q, torch.ones(q.shape[:2], dtype=torch.bool))
    idx, cnt = ball_query.ball_query_batched(radius, nsample, xyz.to(cuda),
                                             q.to(cuda), mask.to(cuda))
    ref_idx, ref_cnt = ball_query.ball_query_plain(radius, nsample, xyz, q,
                                                   mask)
    torch.testing.assert_close(cnt.cpu(), ref_cnt, rtol=0, atol=0)
    torch.testing.assert_close(idx.cpu(), ref_idx, rtol=0, atol=0)
    assert (ref_cnt == nsample).any() and (ref_cnt < nsample).any()


def _cull_edge_case(case, radius=0.75):
    """One query scan around the origin, supports in chunks of 32 (K9's):
    "surface": chunks whose box touches the ball exactly at the rounded r2
    (a lattice point on the surface at the chunk's first or last lane, the
    other 31 points outside with that point the box's nearest), each
    followed by a chunk just beyond the ball; "masked_chunk": a chunk inside
    the ball, every point masked, then one valid; "exactly_nsample": 8 hits,
    a chunk beyond the ball, 8 hits, then 10 more. -> (xyz [1, N, 3], mask
    [1, N], queries [1, 3, 3], nsample)."""
    g = torch.arange(-8, 9, dtype=torch.float32) * 0.25
    lat = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(
        -1, 3)
    r2 = torch.tensor(radius * radius, dtype=torch.float32)
    d2 = (lat[:, 0] * lat[:, 0] + lat[:, 1] * lat[:, 1]) + \
        lat[:, 2] * lat[:, 2]
    order = torch.argsort(d2, stable=True)
    lat, d2 = lat[order], d2[order]
    inside, surf, out = lat[d2 < r2], lat[d2 == r2], lat[d2 > r2]
    far = lat[lat[:, 0] > radius]            # the box lies beyond the ball
    chunks, valid, nsample = [], [], 64
    if case == "surface":
        for i, s in enumerate(surf[:12]):
            dom = (((out * s) > 0) | (s == 0)) & (out.abs() >= s.abs())
            rest = out[dom.all(dim=1)][:31]
            chunks += [torch.cat([s[None], rest] if i % 2 == 0 else
                                 [rest, s[None]]), far[32 * i:32 * i + 32]]
            valid += [True, True]
    elif case == "masked_chunk":
        chunks, valid = [inside[:32], inside[32:64]], [False, True]
    else:
        chunks = [torch.cat([inside[:8], out[:24]]), far[:32],
                  torch.cat([inside[8:16], out[24:48]]),
                  torch.cat([inside[16:26], out[48:70]])]
        valid, nsample = [True] * 4, 16
    assert all(len(c) == 32 for c in chunks)
    xyz = torch.cat(chunks)[None]
    mask = torch.tensor(valid).repeat_interleave(32)[None]
    q = torch.zeros((1, 3, 3))
    q[0, 1] = 0.125
    q[0, 2, 0] = 0.3
    return xyz, mask, q, nsample


@pytest.mark.parametrize("radius", [0.75, 1.25, 1.0606601717798212])
@pytest.mark.parametrize("case", ["surface", "masked_chunk",
                                  "exactly_nsample"])
def test_ball_query_cull_edges(cuda, case, radius):
    """K9's chunk and block culls at their edges, index for index against
    the plain version: boxes that touch the ball at the rounded r2, a fully
    masked chunk, a ball of exactly nsample points across a skipped
    chunk."""
    from paddle3d_tpu_torch.ops import ball_query
    xyz, mask, q, nsample = _cull_edge_case(case, radius)
    idx, cnt = ball_query.ball_query_batched(radius, nsample, xyz.to(cuda),
                                             q.to(cuda), mask.to(cuda))
    ref_idx, ref_cnt = ball_query.ball_query_plain(radius, nsample, xyz, q,
                                                   mask)
    torch.testing.assert_close(cnt.cpu(), ref_cnt, rtol=0, atol=0)
    torch.testing.assert_close(idx.cpu(), ref_idx, rtol=0, atol=0)
    if case == "surface":
        assert ref_cnt[0, 0] == 12
    elif case == "masked_chunk":
        assert ref_cnt[0, 0] == 32 and (ref_idx[0, 0] >= 32).all()
    else:
        assert ref_cnt[0, 0] == 16 and 64 <= ref_idx[0, 0, -1] < 96


def test_ball_query_refuses_what_it_cannot_take(cuda):
    from paddle3d_tpu_torch.ops import ball_query
    xyz = torch.zeros((1, 8, 3), device=cuda)
    mask = torch.ones((1, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError, match="f32"):
        ball_query.ball_query_batched(1., 4, xyz.double(), xyz, mask)
    with pytest.raises(ValueError, match="contiguous"):
        ball_query.ball_query_batched(
            1., 4, torch.zeros((1, 8, 4), device=cuda)[..., :3], xyz, mask)
    with pytest.raises(ValueError, match="expected"):
        ball_query.ball_query_batched(1., 4, xyz, xyz, mask[:, :4])


@pytest.mark.parametrize("n,npoint,valid", [
    (1200, 128, (1200, 777, 1)),
    (20000, 2048, (20000, 15000, 300)),     # PV-RCNN's keypoints
    (16384, 4096, (16384, 16000, 2000)),    # IA-SSD's first layer
    (1024, 512, (1024, 100, 0)),            # fewer valid than npoint, none
    (40000, 64, (40000, 39000, 5)),         # a 16-CTA cluster
    (37, 50, (37, 20, 0)),                  # one warp's worth of points
], ids=["masked", "pv_rcnn", "iassd", "short", "scratch", "tiny"])
def test_fps_matches_plain(cuda, n, npoint, valid):
    """K10 against its plain version, index for index: masked scans, scans
    with fewer valid points than npoint (picks repeat the first valid
    point), a scan with no valid point (index 0 throughout)."""
    from paddle3d_tpu_torch.ops import fps
    xyz, mask = _clustered(n + npoint, 3, n, valid, spread=2.0, box=30.)
    mask = mask.roll(3, dims=1) if valid[0] == n else mask
    mask[0] = True
    before = dict(_build.LAUNCHES)
    idx = fps.farthest_point_sample_batched(xyz.to(cuda), mask.to(cuda),
                                            npoint)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["farthest_point_sample"] == \
        before["farthest_point_sample"] + 1
    ref = fps.farthest_point_sample_plain(xyz, mask, npoint)
    assert idx.dtype == torch.int32 and idx.shape == (3, npoint)
    torch.testing.assert_close(idx.cpu(), ref, rtol=0, atol=0)
    if valid[2] == 0:
        assert not idx[2].any()


def test_fps_ties_keep_the_lowest_index(cuda):
    """A lattice repeated three times: every pick ties with its copies (and
    with its mirror images) at equal distance, and the lowest index wins,
    in the kernel, in the plain version on the CPU and in the plain version
    on the card."""
    from paddle3d_tpu_torch.ops import fps
    g = torch.arange(-4, 5, dtype=torch.float32)
    lattice = torch.stack(torch.meshgrid(g, g, g, indexing="ij"),
                          -1).reshape(-1, 3)
    xyz = torch.cat([lattice, lattice, lattice])[None].contiguous()
    mask = torch.ones(xyz.shape[:2], dtype=torch.bool)
    mask[0, :7] = False
    idx = fps.farthest_point_sample_batched(xyz.to(cuda), mask.to(cuda), 400)
    ref = fps.farthest_point_sample_plain(xyz, mask, 400)
    card = fps.farthest_point_sample_plain(xyz.to(cuda), mask.to(cuda), 400)
    torch.testing.assert_close(idx.cpu(), ref, rtol=0, atol=0)
    torch.testing.assert_close(idx, card, rtol=0, atol=0)
    assert idx[0, 0] == 7 and int(idx.max()) < 2 * lattice.shape[0]


def _fps_check(cuda, xyz, mask, npoint, cluster=0):
    """K10 (the cluster size given, or its own choice) index for index
    against the plain version on the CPU."""
    from paddle3d_tpu_torch.ops import fps
    idx = fps._call(xyz.to(cuda), mask.to(cuda), npoint, cluster)
    torch.cuda.synchronize()
    ref = fps.farthest_point_sample_plain(xyz, mask, npoint)
    torch.testing.assert_close(idx.cpu(), ref, rtol=0, atol=0)
    return idx.cpu()


@pytest.mark.parametrize("cluster", [2, 4, 8, 16])
def test_fps_ties_across_the_ctas_of_a_cluster(cuda, cluster):
    """Equal farthest points in two CTAs of one cluster (one point a
    thread): the lower index wins, whichever CTA holds it."""
    from paddle3d_tpu_torch.ops import fps
    n = cluster * 512
    assert fps.plan(1, n, cluster)["points_a_thread"] == 1
    rng = np.random.default_rng(cluster)
    xyz = rng.normal(0, 1, (2, n, 3)).astype(np.float32)
    far = [100, n - 100, 600, n - 600]     # CTA 0 and the last CTA
    xyz[:, far[:2]] = (50., 0., 0.)
    xyz[:, far[2:]] = (-50., 0., 0.)
    mask = np.ones((2, n), bool)
    mask[1, :100] = False                  # scan 1 starts past CTA 0's tie
    idx = _fps_check(cuda, torch.from_numpy(xyz), torch.from_numpy(mask), 6,
                     cluster)
    low = min(600, n - 600)                # the lower of the second pair
    assert sorted(idx[0, 1:3].tolist()) == [100, low]
    assert idx[1, 0] == 100 and idx[1, 1] == low


@pytest.mark.parametrize("cluster", [0, 1, 2, 4, 8, 16])
@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_fps_around_a_full_cluster(cuda, cluster, offset):
    """n just below, at and just above C x 512 threads (C forced, or the
    kernel's own choice around 8 x 512), with masked points and a scan with
    fewer valid points than npoint."""
    n = (cluster or 8) * 512 + offset
    xyz, mask = _clustered(n + cluster, 3, n, (n, n // 2, 5), spread=2.0)
    _fps_check(cuda, xyz, mask.roll(7, dims=1), 40, cluster)


@pytest.mark.parametrize("n,npoint,valid", [
    (1, 1, (1, 0)), (1, 5, (1, 0)), (700, 700, (700, 350)),
    (2000, 64, (0, 0)), (2000, 100, (40, 1))],
    ids=["one", "one_repeat", "npoint_n", "none_valid", "few_valid"])
def test_fps_small_and_empty_scans(cuda, n, npoint, valid):
    """n = 1, npoint = n, no valid point (index 0 throughout) and fewer
    valid points than npoint (the first valid point repeats)."""
    xyz, mask = _clustered(n + npoint, 2, n, valid)
    idx = _fps_check(cuda, xyz, mask, npoint)
    if valid[1] == 0:
        assert not idx[1].any()


def test_fps_clusters_in_waves(cuda):
    """More scans than clusters resident at once: the clusters run in
    waves and each scan still gets its own picks."""
    from paddle3d_tpu_torch.ops import fps
    n, cluster = 16 * 512, 16
    b = fps.plan(1, n, cluster)["resident"] + 3
    xyz, mask = _clustered(b, b, n, [n - i for i in range(b)], spread=3.0)
    _fps_check(cuda, xyz, mask, 48, cluster)


def test_fps_scratch_path(cuda):
    """A scan longer than the largest cluster holds on chip takes the
    scratch path (one block a scan, d2 in device memory)."""
    from paddle3d_tpu_torch.ops import fps
    n = 16 * 512 * 16 + 5000
    assert fps.plan(2, n)["cluster"] == 0
    xyz, mask = _clustered(n, 2, n, (n, n - 9000), spread=4.0, box=40.)
    _fps_check(cuda, xyz, mask, 32)


@pytest.mark.parametrize("b,n", [(4, 20000), (2, 20000), (4, 16384),
                                 (8, 16384), (4, 4096), (8, 4096),
                                 (4, 1024), (8, 1024)])
def test_fps_path_shapes_take_one_cluster_a_scan(cuda, b, n):
    """At the PV-RCNN and IA-SSD call shapes the sampler launches one
    cluster a scan, all of them resident at once."""
    from paddle3d_tpu_torch.ops import fps
    p = fps.plan(b, n)
    assert p["cluster"] >= 1 and p["resident"] >= b
    assert p["cluster"] * p["threads"] * p["points_a_thread"] >= n


def test_fps_refuses_what_it_cannot_take(cuda):
    from paddle3d_tpu_torch.ops import fps
    xyz = torch.zeros((1, 8, 3), device=cuda)
    mask = torch.ones((1, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError, match="f32"):
        fps.farthest_point_sample_batched(xyz.double(), mask, 4)
    with pytest.raises(TypeError, match="bool"):
        fps.farthest_point_sample_batched(xyz, mask.float(), 4)
    with pytest.raises(ValueError, match="expected"):
        fps.farthest_point_sample_batched(xyz, mask[:, :4], 4)


def _tiny_two_stage(tmp_path, name):
    """A tiny PV-RCNN or Voxel-RCNN config (the KITTI config over 16 m x
    16 m at 0.25 m, 41 z layers, 64 keypoints, a 2^3 RoI grid)."""
    import yaml
    rng_, vs = [0., -8., -2., 16., 8., 2.], [0.25, 0.25, 0.1]
    anchor = dict(sizes=[1.6, 3.9, 1.56], anchor_strides=[2.0, 2.0, 0.0],
                  anchor_offsets=[1.0, -7.0, -1.78], rotations=[0.0, 1.57],
                  matched_threshold=0.6, unmatched_threshold=0.45)
    pv = name == "pv_rcnn"
    model = {
        "voxelizer": {"point_cloud_range": rng_, "voxel_size": vs,
                      "max_num_voxels": [600, 900]},
        "middle_encoder": {"point_cloud_range": rng_, "voxel_size": vs},
        "backbone": {"layer_nums": [1, 1]},
        "rpn_head": {"point_cloud_range": rng_, "voxel_size": vs,
                     "num_proposals": 16, "nms_pre": 64,
                     "anchor_configs": [anchor] * (3 if pv else 1)},
        "roi_head": {"grid_size": 2, "head_fc": [32, 32]}}
    if pv:
        model["point_encoder"] = {"num_keypoints": 64,
                                  "point_cloud_range": rng_,
                                  "voxel_size": vs}
    base = (("pv_rcnn", "pv_rcnn_005voxel_kitti.yml") if pv else
            ("voxel_rcnn", "voxel_rcnn_005voxel_kitti_car.yml"))
    path = tmp_path / (name + "_tiny.yml")
    path.write_text(yaml.safe_dump({
        "_base_": os.path.join(REPO, "configs", *base), "model": model}))
    return str(path)


def _scaled(path, device):
    """The config's model, eval, dense weights scaled so the signal
    survives the stack."""
    from paddle3d_tpu_torch.apis import Config
    model = Config(path=path, device=device).model.eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                              torch.nn.Linear)):
                m.weight.mul_(6 ** 0.5)
    return model


@pytest.mark.parametrize("name,k9,k10", [("pv_rcnn", 7, 1),
                                         ("voxel_rcnn", 2, 0)])
def test_two_stage_on_card_matches_cpu(cuda, tmp_path, name, k9, k10):
    """Tiny PV-RCNN and Voxel-RCNN: test_forward through the kernels on the
    card against the plain versions on the CPU; keypoints and proposal
    labels equal, scores 1e-4, boxes 1e-3 (cuDNN and the CPU convolutions
    sum in other orders)."""
    rng = np.random.default_rng(0)
    pts = rng.uniform([0, -8, -2, 0], [16, 8, -1.5, 1], (2, 3000, 4))
    pts[:, :1500, :3] = rng.uniform([1, -7, -1.5], [15, 7, 0], (8, 3))[
        rng.integers(0, 8, 1500)] + rng.normal(0, [.8, .4, .3],
                                               (2, 1500, 3))
    pts[:, -16:] = np.nan
    pts[-1, 600:] = np.nan
    pts = torch.from_numpy(pts.astype(np.float32))
    model = _scaled(_tiny_two_stage(tmp_path, name), "cpu")
    ref = model.test_forward({"data": pts})
    model.cuda()
    before = dict(_build.LAUNCHES)
    got = model.test_forward({"data": pts.to(cuda)})
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ball_query"] == before["ball_query"] + k9
    assert _build.LAUNCHES["farthest_point_sample"] == \
        before["farthest_point_sample"] + k10
    assert _build.LAUNCHES["sparse_conv3d"] == before["sparse_conv3d"] + 8
    assert _build.LAUNCHES["sparse_conv3d_map"] == \
        before["sparse_conv3d_map"] + 7
    torch.testing.assert_close(got["label_preds"].cpu(), ref["label_preds"],
                               rtol=0, atol=0)
    torch.testing.assert_close(got["scores"].cpu(), ref["scores"],
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got["box3d_lidar"].cpu(), ref["box3d_lidar"],
                               rtol=1e-3, atol=1e-3)
    assert (ref["label_preds"] >= 0).sum() >= 8


def test_iassd_on_card_matches_cpu(cuda):
    """The tiny IA-SSD config: test_forward through the kernels on the card
    against the plain versions on the CPU."""
    rng = np.random.default_rng(1)
    pts = rng.uniform([0, -16, -2, 0], [32, 16, -1.2, 1], (2, 1024, 4))
    pts[:, :512, :3] = rng.uniform([4, -12, -1.2], [28, 12, 0], (6, 3))[
        rng.integers(0, 6, 512)] + rng.normal(0, [.9, .5, .4], (2, 512, 3))
    pts[:, -24:] = np.nan
    pts[-1, 200:] = np.nan
    pts = torch.from_numpy(pts.astype(np.float32))
    model = _scaled(os.path.join(REPO, "configs", "iassd",
                                 "iassd_synthetic_tiny.yml"), "cpu")
    ref = model.test_forward({"data": pts})
    model.cuda()
    before = dict(_build.LAUNCHES)
    got = model.test_forward({"data": pts.to(cuda)})
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ball_query"] == before["ball_query"] + 8
    assert _build.LAUNCHES["farthest_point_sample"] == \
        before["farthest_point_sample"] + 2
    torch.testing.assert_close(got["label_preds"].cpu(), ref["label_preds"],
                               rtol=0, atol=0)
    torch.testing.assert_close(got["scores"].cpu(), ref["scores"],
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got["box3d_lidar"].cpu(), ref["box3d_lidar"],
                               rtol=1e-3, atol=1e-3)
    assert (ref["label_preds"] >= 0).any()


def _seg_window_inputs(case, c, seed=0):
    """Sorted keys and values for K12: an exact-tie lattice (post-relu
    integers), segments longer than the window, an all-sentinel tail, the
    -1e9 mask, -0 values and cotangents, segments of 63 rows with one
    maximum (a row that takes the cotangents of all 62 neighbours at
    P = 20), segments of one row; N not a multiple of any tile."""
    rng = np.random.default_rng(seed)
    b, n = 2, 3001
    max_seg = 120 if case == "long" else 30
    keys = np.cumsum(rng.random((b, n)) < 1.0 / max_seg * 2, axis=1)
    if case == "sentinel":
        keys[:, -700:] = SENT
        keys[1, :] = SENT
    if case == "peak":
        keys = np.tile(np.arange(n) // 63, (b, 1))
    if case == "singletons":
        keys = np.tile(np.arange(n) * 3, (b, 1))
    if case == "ties":
        vals = np.maximum(rng.integers(-3, 4, (b, n, c)), 0)
    else:
        vals = rng.normal(0, 1, (b, n, c))
    if case in ("masked", "sentinel"):
        vals = np.where(rng.random((b, n, 1)) < 0.3, -1e9, vals)
    g = rng.normal(0, 1, (b, n, c))
    if case == "signed_zero":
        vals = np.where(rng.random((b, n, c)) < 0.5,
                        np.where(rng.random((b, n, c)) < 0.5, -0., 0.), vals)
        zero_g = (rng.random((b, n, 1)) < 0.5) | (keys % 3 == 0)[..., None]
        g = np.where(zero_g, -0., g)
    if case == "peak":
        vals[:, 31::63] += 10.
        g = np.where((keys % 2 == 0)[..., None], -0., g)
    return (torch.from_numpy(vals.astype(np.float32)),
            torch.from_numpy(keys.astype(np.int32)),
            torch.from_numpy(g.astype(np.float32)))


def _same_bits(a, b):
    """Equal f32 or f64 bit patterns: tells -0 from +0, where torch.equal
    does not."""
    bits = {4: torch.int32, 8: torch.int64}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(bits), b.view(bits))


@pytest.mark.parametrize("c", [32, 64, 20, 6])
@pytest.mark.parametrize("case", ["ties", "long", "sentinel", "masked",
                                  "signed_zero", "peak", "singletons"])
def test_seg_window_max_matches_plain(cuda, case, c):
    """K12 forward and backward bit for bit against the plain versions:
    values, int8 offsets and input gradients (c = 6 takes the kernels'
    staging by plain loads)."""
    from paddle3d_tpu_torch.ops import seg_window
    vals, keys, g = (t.to(cuda) for t in _seg_window_inputs(case, c))
    for p in (20, 16):
        before = dict(_build.LAUNCHES)
        out, off = seg_window.seg_window_max_fwd(vals, keys, p)
        gin = seg_window.seg_window_max_bwd(off, g, p, keys)
        ref, ref_off = seg_window.seg_window_max_plain(vals, keys, p)
        ref_gin = seg_window.seg_window_max_bwd_plain(ref_off, g, p)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["seg_window_max"] == \
            before["seg_window_max"] + 1
        assert _build.LAUNCHES["seg_window_max_bwd"] == \
            before["seg_window_max_bwd"] + 1
        assert _same_bits(out, ref)
        assert torch.equal(off, ref_off)
        assert _same_bits(gin, ref_gin)
        if case == "peak" and p == 20:
            # every middle row of a whole segment took all 62 cotangents
            # of its segment, none skipped: -0 ones stay -0
            mid = gin[:, 31:keys.shape[1] // 63 * 63:63]
            assert _same_bits(mid[:, ::2], torch.full_like(mid[:, ::2], -0.))
    if case == "ties":
        assert (off != 0).float().mean() > 0.3
    if case == "signed_zero":
        # a row alone in its segment with a -0 cotangent: the kernel
        # probes nothing and must still give the plain version's +0
        neg0 = torch.tensor(-0.).view(torch.int32).item()
        alone = torch.ones_like(keys, dtype=torch.bool)
        alone[:, 1:] &= keys[:, 1:] != keys[:, :-1]
        alone[:, :-1] &= keys[:, :-1] != keys[:, 1:]
        sel = alone[..., None] & (g.view(torch.int32) == neg0)
        assert (g.view(torch.int32) == neg0).float().mean() > 0.3
        assert (out.view(torch.int32) == neg0).any()
        assert sel.any() and (gin.view(torch.int32)[sel] == 0).all()
    if case == "singletons":
        assert not off.any() and _same_bits(out, vals)


def test_seg_window_max_bwd_reads_strided_g(cuda):
    """A cotangent whose rows are evenly spaced (the slice of a wider
    tensor, as a concatenation's gradient is) is read in place; one that is
    not is copied first: both bit-equal to the plain version."""
    from paddle3d_tpu_torch.ops import seg_window
    vals, keys, g = (t.to(cuda) for t in _seg_window_inputs("ties", 32))
    _, off = seg_window.seg_window_max_fwd(vals, keys, 20)
    wide = torch.cat([torch.randn_like(g), g], dim=-1)[..., 32:]
    cols = g.transpose(1, 2).contiguous().transpose(1, 2)
    assert seg_window._rows_apart(wide) == 64
    assert seg_window._rows_apart(cols) == 0
    ref = seg_window.seg_window_max_bwd_plain(off, g, 20)
    for view in (wide, cols):
        assert _same_bits(seg_window.seg_window_max_bwd(off, view, 20, keys),
                          ref)


def test_seg_window_max_bwd_refuses_bad_keys(cuda):
    """The backward takes the forward's keys: [B, N] int32 on the card."""
    from paddle3d_tpu_torch.ops import seg_window
    vals, keys, g = (t.to(cuda) for t in _seg_window_inputs("masked", 32))
    _, off = seg_window.seg_window_max_fwd(vals, keys, 20)
    with pytest.raises(TypeError):
        seg_window.seg_window_max_bwd(off, g, 20, keys.long())
    with pytest.raises(ValueError):
        seg_window.seg_window_max_bwd(off, g, 20, keys[:, :-1].contiguous())
    with pytest.raises(ValueError):
        seg_window.seg_window_max_bwd(off, g, 20, keys[None])
    with pytest.raises(ValueError):
        seg_window.seg_window_max_bwd(off, g, 20, keys.cpu())


def test_seg_window_max_autograd_on_card(cuda):
    """seg_window_max under autograd launches both kernels and equals the
    plain path's gradient; bad inputs raise."""
    from paddle3d_tpu_torch.ops import seg_window
    vals, keys, g = (t.to(cuda) for t in _seg_window_inputs("masked", 64))
    x = vals.clone().requires_grad_()
    (seg_window.seg_window_max(x, keys, 20) * g).sum().backward()
    _, off = seg_window.seg_window_max_plain(vals, keys, 20)
    ref = seg_window.seg_window_max_bwd_plain(off, g, 20)
    assert torch.equal(x.grad, ref)
    with pytest.raises(TypeError):
        seg_window.seg_window_max_fwd(vals.double(), keys, 20)
    with pytest.raises(ValueError):
        seg_window.seg_window_max_fwd(vals, keys, 200)
    with pytest.raises(ValueError):
        seg_window.seg_window_max_fwd(vals[:, ::2], keys[:, ::2], 20)


def test_two_layer_train_canvas_on_card_matches_cpu(cuda, tmp_path):
    """The two-layer train canvas (K12 forward and backward, the row-major
    sum and K5) on the card against the plain versions on the CPU: canvas,
    running stats and the PFN grads within 1e-5 of their largest values."""
    import yaml

    from paddle3d_tpu_torch.apis import Config
    from paddle3d_tpu_torch.ops.pillar_ops import fused_pillar_canvas
    with open(os.path.join(REPO, "configs", "centerpoint",
                           "centerpoint_synthetic_tiny.yml")) as f:
        dic = yaml.safe_load(f)
    dic["model"]["voxel_encoder"].update(in_channels=5,
                                         feat_channels=[16, 16])
    dic["model"]["middle_encoder"]["in_channels"] = 16
    dic["model"]["backbone"]["in_channels"] = 16
    path = tmp_path / "cp2.yml"
    path.write_text(yaml.safe_dump(dic))
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform([0, -16, -2, 0, 0],
                                       [32, 16, 2, 1, .45],
                                       (2, 1024, 5)).astype(np.float32))
    pts[:, :400, :2] = pts[:, :1, :2] + torch.from_numpy(rng.normal(
        0, .2, (2, 400, 2)).astype(np.float32))     # pillars over P
    w = torch.from_numpy(rng.normal(0, 1, (2, 64, 64, 16)).astype(
        np.float32))
    results = []
    for device in ("cpu", cuda):
        model = Config(path=str(path), device=device).model.train()
        pfn = model.voxel_encoder
        before = dict(_build.LAUNCHES)
        canvas = fused_pillar_canvas(model.voxelizer, pfn,
                                     model.middle_encoder, pts.to(device),
                                     True)
        (canvas * w.to(device)).sum().backward()
        if device != "cpu":
            torch.cuda.synchronize()
            assert _build.LAUNCHES["seg_window_max"] == \
                before["seg_window_max"] + 2
            assert _build.LAUNCHES["seg_window_max_bwd"] == \
                before["seg_window_max_bwd"] + 2
        results.append([canvas.detach().cpu()] + [
            t.detach().cpu() for k, t in sorted(pfn.state_dict().items())
            if "running" in k] + [p.grad.cpu() for _, p in
                                  sorted(pfn.named_parameters())])
    for got, ref in zip(results[1], results[0]):
        _close(got, ref, 1e-5)


IOU_CASES = ("clustered", "lattice", "degenerate", "far", "unbatched",
             "all past the guard", "n is 1", "m is 1", "ragged tiles",
             "zero size", "tie lattice", "grid limit")


def _iou_case(name, device):
    """Corners (a, b) of one K11 case: clustered car-sized boxes and jittered
    copies [4, 100] x [4, 120]; a tie lattice (unit and 2 x 1 m boxes on a
    1 m lattice, duplicates, yaw a multiple of pi/2) and chip_smoke's 8 x 8
    one; degenerate boxes (zero size, 1 mm) among ordinary ones; far-apart
    pairs (no pair past the guard); one unbatched pair of sets; boxes that
    all overlap; n or m of 1; n and m that leave ragged tiles (m past one
    128-box tile, several A rows a tile); zero-size boxes on the others'
    centres (past the guard, clipping nothing); the most batch rows a launch
    takes."""
    from chip_smoke import tie_lattice
    from paddle3d_tpu_torch.ops.box_ops import boxes_to_corners_bev
    rng = np.random.default_rng(11)

    def cars(b, n, spread=20.):
        x = np.zeros((b, n, 7), np.float32)
        x[..., :2] = rng.uniform(-spread, spread, (b, n, 2))
        x[..., 3:6] = rng.uniform([1.4, 3.2, 1.3], [2.0, 4.6, 1.8],
                                  (b, n, 3))
        x[..., 6] = rng.uniform(-np.pi, np.pi, (b, n))
        return x

    def jitter(x, s=0.8):
        y = x.copy()
        y[..., :2] += rng.normal(0, s, y[..., :2].shape)
        y[..., 6] += rng.normal(0, 0.2, y[..., 6].shape)
        return y

    a = cars(4, 100)
    if name == "clustered":
        x, y = a, jitter(np.concatenate([a, a[:, :20]], axis=1))
    elif name == "lattice":
        g = np.stack(np.meshgrid(np.arange(6.), np.arange(6.),
                                 indexing="ij"), -1).reshape(-1, 2)
        x = np.zeros((2, 36, 7), np.float32)
        x[..., :2] = g
        x[1, :, :2] += 0.5
        x[..., 3:6] = np.where((np.arange(36) % 3 == 0)[:, None], [2, 1, 1],
                               [1, 1, 1])
        x[..., 6] = (np.arange(36) % 4) * np.pi / 2
        y = x.copy()
        y[:, 1::2] = x[:, ::2]
    elif name == "tie lattice":
        x, y = (t.cpu().numpy() for t in tie_lattice("cpu"))
    elif name == "degenerate":
        x = a[:1, :24].copy()
        x[0, :4, 3:5] = [[0, 0], [1e-3, 1e-3], [0, 2], [1e-3, 4]]
        x[0, 4:8] = x[0, 8:12]                         # coincident pairs
        y = x
    elif name == "far":
        x, y = a[:1, :24], a[:1, :24].copy()
        y[..., 0] += 1000.
    elif name == "unbatched":
        x, y = a[0], jitter(a[0])[:70]
    elif name == "all past the guard":
        x, y = cars(2, 40, 0.5), cars(2, 50, 0.5)
    elif name == "n is 1":
        x, y = a[:3, :1], jitter(a[:3, :70])
    elif name == "m is 1":
        x, y = a[:3, :70], jitter(a[:3, :1])
    elif name == "ragged tiles":
        x = cars(2, 300, 12.)
        y = jitter(np.concatenate([x[:, :130], x[:, :3]], axis=1))
    elif name == "zero size":
        y = cars(2, 60)
        x = jitter(y[:, :50], 0.)
        x[..., 3:5] = 0.
    else:                                   # "grid limit"
        x = cars(65535, 1, 2.)
        y = np.concatenate([jitter(x, 0.5), cars(65535, 1, 2.)], axis=1)
    return (boxes_to_corners_bev(torch.from_numpy(x).to(device)),
            boxes_to_corners_bev(torch.from_numpy(y).to(device)))


@pytest.mark.parametrize("case", IOU_CASES)
def test_pairwise_intersection_area_matches_plain(cuda, case):
    """K11 bit for bit against its plain version: one launch a call, the
    batch on the grid."""
    from paddle3d_tpu_torch.ops import iou_clip
    ca, cb = _iou_case(case, cuda)
    before = _build.LAUNCHES["pairwise_intersection_area"]
    got = iou_clip.pairwise_intersection_area(ca, cb)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["pairwise_intersection_area"] == before + 1
    ref = iou_clip.pairwise_intersection_area_plain(ca, cb)
    assert got.shape == ref.shape
    assert _same_bits(got, ref), (got - ref).abs().max().item()
    if case in ("clustered", "lattice", "tie lattice", "ragged tiles"):
        assert (ref > 0).sum() > 50
    if case == "far":
        assert not got.any()
    if case == "zero size":
        from chip_smoke import iou_work
        assert iou_work(ca, cb)[3] > 50 and not got.any()
    if case == "all past the guard":
        from chip_smoke import iou_work
        _, _, pairs, clipped = iou_work(ca, cb)
        assert clipped == pairs


def test_pairwise_intersection_area_refuses_what_it_cannot_take(cuda):
    from paddle3d_tpu_torch.ops import iou_clip
    ca = torch.zeros((2, 8, 4, 2), device=cuda)
    with pytest.raises(TypeError, match="f32"):
        iou_clip.pairwise_intersection_area(ca.double(), ca.double())
    with pytest.raises(ValueError, match="expected"):
        iou_clip.pairwise_intersection_area(ca, ca[:1])
    with pytest.raises(ValueError, match="expected"):
        iou_clip.pairwise_intersection_area(ca[..., :1], ca[..., :1])
    before = _build.LAUNCHES["pairwise_intersection_area"]
    big = torch.zeros((iou_clip.MAX_BATCH + 1, 1, 4, 2), device=cuda)
    with pytest.raises(ValueError, match="batch rows"):
        iou_clip.pairwise_intersection_area(big, big)
    assert _build.LAUNCHES["pairwise_intersection_area"] == before


def test_two_stage_train_step_on_card_matches_cpu(cuda, tmp_path):
    """A tiny Voxel-RCNN train step (AdamWOnecycle) through the kernels on
    the card (one K11 and two K9 launches, the dense BEV's segment sum and
    its VJP) against the plain versions on the CPU, from one state, the
    sampler's draws alike, gt boxes from the first proposals: the sampled
    targets equal; losses 1e-4, grads 1e-3 and running stats 1e-4 of each
    tensor's largest value (cuDNN and the CPU convolutions sum in other
    orders, autograd's gathers add with atomics on the card)."""
    import copy

    import yaml

    from paddle3d_tpu_torch.apis import Config, make_train_step
    from paddle3d_tpu_torch.models.detection.pv_rcnn import pv_rcnn
    path = _tiny_two_stage(tmp_path, "voxel_rcnn")
    dic = yaml.safe_load(open(path))
    dic["model"]["target_config"] = {"roi_per_image": 8}
    with open(path, "w") as f:
        yaml.safe_dump(dic, f)
    rng = np.random.default_rng(2)
    pts = rng.uniform([0, -8, -2, 0], [16, 8, -1.5, 1], (2, 3000, 4))
    pts[:, :1500, :3] = rng.uniform([1, -7, -1.5], [15, 7, 0], (8, 3))[
        rng.integers(0, 8, 1500)] + rng.normal(0, [.8, .4, .3],
                                               (2, 1500, 3))
    pts[:, -16:] = np.nan
    pts = torch.from_numpy(pts.astype(np.float32))
    cpu_cfg = Config(path=path, device="cpu")
    model = cpu_cfg.model.train()
    with torch.no_grad():
        probe = copy.deepcopy(model)
        rois, _, labels = probe.rpn_head.proposals(probe._stage1(pts,
                                                                 True)[0])
    boxes = rois[:, :6].clone()
    boxes[..., :3] += 0.05
    gt_labels = torch.where(labels[:, :6] >= 0, labels[:, :6], -1).long()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    out = []
    for device in ("cpu", "cuda"):
        cfg = cpu_cfg if device == "cpu" else Config(path=path,
                                                     device=device)
        m = cfg.model.train()
        m.load_state_dict(state)
        targets = []
        fn = pv_rcnn.proposal_targets

        def rec(*a):
            targets.append(fn(*a))
            return targets[-1]
        before = dict(_build.LAUNCHES)
        pv_rcnn.proposal_targets = rec
        try:
            losses = make_train_step(lr_scheduler=cfg.lr_scheduler)(
                m, cfg.optimizer, {"data": pts.to(device),
                                   "gt_boxes": boxes.to(device),
                                   "gt_labels": gt_labels.to(device)})
        finally:
            pv_rcnn.proposal_targets = fn
        torch.cuda.synchronize()
        launched = {k: _build.LAUNCHES[k] - before[k] for k in before}
        out.append((losses, targets[0], m, launched))
    (l_cpu, t_cpu, m_cpu, n_cpu), (l_gpu, t_gpu, m_gpu, n_gpu) = out
    assert not any(n_cpu.values())
    assert n_gpu["pairwise_intersection_area"] == 1
    assert n_gpu["ball_query"] == 2 and n_gpu["sorted_table_gather"] == 1
    assert n_gpu["sparse_conv3d"] == 0
    for k in ("valid", "roi_labels", "reg_valid_mask"):
        assert torch.equal(t_gpu[k].cpu(), t_cpu[k]), k
    for k in l_cpu:
        assert np.isfinite(l_gpu[k].item())
        np.testing.assert_allclose(l_gpu[k].item(), l_cpu[k].item(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    for (name, p), q in zip(m_gpu.named_parameters(), m_cpu.parameters()):
        ref = q.grad
        err = (p.grad.cpu() - ref).abs().max().item()
        assert err <= 1e-3 * max(ref.abs().max().item(), 1e-30), name
    for (name, s), r in zip(m_gpu.state_dict().items(),
                            m_cpu.state_dict().values()):
        if "running" in name:
            err = (s.cpu() - r).abs().max().item()
            assert err <= 1e-4 * max(r.abs().max().item(), 1e-30), name


def _caddn(cuda, b=2):
    """CADDN's full-width frustum (80 x 96 x 312 rows a frame onto 376 x
    280 cells) under chip_smoke.py's KITTI camera, and its pool's inputs
    from a seed: (model, img2lidars on the card, feature table [B, h*w,
    64], depth weights [B, D, h, w])."""
    import chip_smoke
    from paddle3d_tpu_torch.apis import Config
    model = Config(path=chip_smoke.CADDN_KITTI, device="cpu").model
    cam = torch.from_numpy(np.stack([
        chip_smoke.caddn_camera(*chip_smoke.CADDN_HW, yaw=0.05 * i)
        for i in range(b)])).to(cuda)
    gen = torch.Generator(device="cpu").manual_seed(19)
    table = torch.randn((b, 96 * 312, 64), generator=gen).to(cuda)
    dep = torch.rand((b, 80, 96, 312), generator=gen).to(cuda)
    return model, cam, table, dep


def test_caddn_frustum_ranks_on_card_match_cpu(cuda):
    """The frustum's rank and valid computed on the card index for index
    as on the CPU (true divisions on both)."""
    model, cam, _, _ = _caddn(cuda)
    rank, valid = model.frustum_ranks(cam, 96, 312)
    ref_rank, ref_valid = model.frustum_ranks(cam.cpu(), 96, 312)
    assert torch.equal(valid.cpu(), ref_valid) and valid.float().mean() > .5
    assert torch.equal(rank.cpu()[ref_valid], ref_rank[ref_valid])


def test_caddn_pool_runs_k7_and_k5_at_full_width(cuda, monkeypatch):
    """ops/scatter.bev_pool_sorted at CADDN's full-width call: the
    forward launches K7 (a dense scan by the density rule), bit-equal to
    the row-order sum of the rows it was handed; the backward launches K5,
    bit-equal to its plain version on the cotangent it was handed."""
    from paddle3d_tpu_torch.ops import scatter
    model, cam, table, dep = _caddn(cuda)
    rank, valid = model.frustum_ranks(cam, 96, 312)
    b, cells = cam.shape[0], 376 * 280
    seen = {}
    fwd, bwd = sorted_scatter.scatter_rows, sorted_scatter.sorted_table_gather

    def rec_fwd(*args):
        seen["fwd"] = (args, fwd(*args))
        return seen["fwd"][1]

    def rec_bwd(*args):
        seen["bwd"] = (args, bwd(*args))
        return seen["bwd"][1]
    monkeypatch.setattr(sorted_scatter, "scatter_rows", rec_fwd)
    monkeypatch.setattr(sorted_scatter, "sorted_table_gather", rec_bwd)
    table.requires_grad_()
    before = dict(_build.LAUNCHES)
    out = scatter.bev_pool_sorted(
        table, torch.arange(96 * 312, device=cuda).repeat(80)[None].expand(
            b, -1), dep.reshape(b, -1), rank.reshape(b, -1),
        valid.reshape(b, -1), cells)
    out.backward(torch.randn_like(out))
    torch.cuda.synchronize()
    assert {k: _build.LAUNCHES[k] - before[k] for k in before
            if _build.LAUNCHES[k] != before[k]} == {
                "sorted_segment_sum_dense": 1, "sorted_table_gather": 1}
    (keys, rows, n_cells, _), got = seen["fwd"]
    assert n_cells == cells and keys.shape == (b, 80 * 96 * 312)
    torch.testing.assert_close(got, _row_order_sum(keys, rows, cells),
                               rtol=0, atol=0)
    args, got = seen["bwd"]
    torch.testing.assert_close(
        got, sorted_scatter.sorted_table_gather_plain(*args), rtol=0, atol=0)


def _bevdet(cuda, b=2):
    """BEVDet4D's full-width view transformer (six 256 x 704 cameras, 59
    depth bins onto 128 x 128 cells: 249,216 frustum rows a frame) under
    chip_smoke.py's rig, tilted and under a BEV yaw, and its pool's inputs
    from a seed: (view transformer, the camera matrices on the card, depth
    probabilities [B, 6, 59, 16, 44], context [B, 6, 64, 16, 44])."""
    import chip_smoke
    from paddle3d_tpu_torch.apis import Config
    vt = Config(path=chip_smoke.BEVDET, device="cpu").model \
        .img_view_transformer
    mats = {k: torch.from_numpy(v).to(cuda) for k, v in chip_smoke.bevdet_rig(
        chip_smoke.BEVDET_HW, b=b, tilt=0.02, bda_yaw=0.2).items()}
    gen = torch.Generator(device="cpu").manual_seed(23)
    depth = torch.softmax(torch.randn((b, 6, 59, 16, 44), generator=gen),
                          dim=2).to(cuda)
    feat = torch.randn((b, 6, 64, 16, 44), generator=gen).to(cuda)
    return vt, mats, depth, feat


def test_bevdet_frustum_ranks_on_card_match_cpu(cuda):
    """The frustum's points computed on the card bit for bit as on the CPU
    (elementwise ops only: no cuBLAS, no contraction into FMAs), so its
    rank and valid index for index."""
    vt, mats, _, _ = _bevdet(cuda)
    cpu = {k: v.cpu() for k, v in mats.items()}
    coor = vt.get_lidar_coor(**mats)
    ref = vt.get_lidar_coor(**cpu)
    assert torch.equal(coor.cpu().view(torch.int32), ref.view(torch.int32))
    rank, valid = vt.frustum_ranks(**mats)
    ref_rank, ref_valid = vt.frustum_ranks(**cpu)
    assert torch.equal(valid.cpu(), ref_valid) and valid.float().mean() > .5
    assert torch.equal(rank.cpu()[ref_valid], ref_rank[ref_valid])


def test_bevdet_pool_runs_k7_and_k5_at_full_width(cuda, monkeypatch):
    """LSSViewTransformer.lift_splat at BEVDet4D's full-width call: the
    forward launches K7 (a dense scan by the density rule), bit-equal to
    the row-order sum of the rows it was handed; the backward launches K5,
    bit-equal to its plain version on the cotangent it was handed."""
    vt, mats, depth, feat = _bevdet(cuda)
    b, cells = depth.shape[0], 128 * 128
    seen = {}
    fwd, bwd = sorted_scatter.scatter_rows, sorted_scatter.sorted_table_gather

    def rec_fwd(*args):
        seen["fwd"] = (args, fwd(*args))
        return seen["fwd"][1]

    def rec_bwd(*args):
        seen["bwd"] = (args, bwd(*args))
        return seen["bwd"][1]
    monkeypatch.setattr(sorted_scatter, "scatter_rows", rec_fwd)
    monkeypatch.setattr(sorted_scatter, "sorted_table_gather", rec_bwd)
    feat.requires_grad_()
    depth.requires_grad_()
    before = dict(_build.LAUNCHES)
    out = vt.lift_splat(depth, feat, **mats)
    out.backward(torch.randn_like(out))
    torch.cuda.synchronize()
    assert {k: _build.LAUNCHES[k] - before[k] for k in before
            if _build.LAUNCHES[k] != before[k]} == {
                "sorted_segment_sum_dense": 1, "sorted_table_gather": 1}
    (keys, rows, n_cells, _), got = seen["fwd"]
    assert n_cells == cells and keys.shape == (b, 6 * 59 * 16 * 44)
    torch.testing.assert_close(got, _row_order_sum(keys, rows, cells),
                               rtol=0, atol=0)
    args, got = seen["bwd"]
    torch.testing.assert_close(
        got, sorted_scatter.sorted_table_gather_plain(*args), rtol=0, atol=0)
    assert torch.isfinite(depth.grad).all() and torch.isfinite(feat.grad).all()


def _rtebev(cuda, b=2):
    """RTEBev's full-width view transformer (six 256 x 704 cameras at
    stride 8, 118 depth bins onto 128 x 128 cells: 1,993,728 frustum rows
    a frame) under chip_smoke.py's rig, tilted and under a BEV yaw, and
    its pool's inputs from a seed: (view transformer, the camera matrices
    on the card, depth probabilities [B, 6, 118, 32, 88], context [B, 6,
    80, 32, 88])."""
    import chip_smoke
    from paddle3d_tpu_torch.apis import Config
    vt = Config(path=chip_smoke.RTEBEV, device="cpu").model \
        .img_view_transformer
    mats = {k: torch.from_numpy(v).to(cuda) for k, v in chip_smoke.bevdet_rig(
        chip_smoke.BEVDET_HW, b=b, tilt=0.02, bda_yaw=0.2).items()}
    gen = torch.Generator(device="cpu").manual_seed(29)
    depth = torch.softmax(torch.randn((b, 6, 118, 32, 88), generator=gen),
                          dim=2).to(cuda)
    feat = torch.randn((b, 6, 80, 32, 88), generator=gen).to(cuda)
    return vt, mats, depth, feat


def test_rtebev_frustum_ranks_on_card_match_cpu(cuda):
    """RTEBev's frustum points on the card bit for bit as on the CPU, so
    its rank and valid index for index."""
    vt, mats, _, _ = _rtebev(cuda)
    cpu = {k: v.cpu() for k, v in mats.items()}
    coor = vt.get_lidar_coor(**mats)
    ref = vt.get_lidar_coor(**cpu)
    assert torch.equal(coor.cpu().view(torch.int32), ref.view(torch.int32))
    rank, valid = vt.frustum_ranks(**mats)
    ref_rank, ref_valid = vt.frustum_ranks(**cpu)
    assert torch.equal(valid.cpu(), ref_valid) and valid.float().mean() > .3
    assert torch.equal(rank.cpu()[ref_valid], ref_rank[ref_valid])


def test_rtebev_pool_runs_k7_and_k5_at_full_width(cuda, monkeypatch):
    """lift_splat at RTEBev's full-width call: the forward launches K7,
    bit-equal to the row-order sum of the rows it was handed; the backward
    launches K5, bit-equal to its plain version on its cotangent."""
    vt, mats, depth, feat = _rtebev(cuda)
    b, cells = depth.shape[0], 128 * 128
    seen = {}
    fwd, bwd = sorted_scatter.scatter_rows, sorted_scatter.sorted_table_gather

    def rec_fwd(*args):
        seen["fwd"] = (args, fwd(*args))
        return seen["fwd"][1]

    def rec_bwd(*args):
        seen["bwd"] = (args, bwd(*args))
        return seen["bwd"][1]
    monkeypatch.setattr(sorted_scatter, "scatter_rows", rec_fwd)
    monkeypatch.setattr(sorted_scatter, "sorted_table_gather", rec_bwd)
    feat.requires_grad_()
    depth.requires_grad_()
    before = dict(_build.LAUNCHES)
    out = vt.lift_splat(depth, feat, **mats)
    out.backward(torch.randn_like(out))
    torch.cuda.synchronize()
    assert {k: _build.LAUNCHES[k] - before[k] for k in before
            if _build.LAUNCHES[k] != before[k]} == {
                "sorted_segment_sum_dense": 1, "sorted_table_gather": 1}
    (keys, rows, n_cells, _), got = seen["fwd"]
    assert n_cells == cells and keys.shape == (b, 6 * 118 * 32 * 88)
    torch.testing.assert_close(got, _row_order_sum(keys, rows, cells),
                               rtol=0, atol=0)
    args, got = seen["bwd"]
    torch.testing.assert_close(
        got, sorted_scatter.sorted_table_gather_plain(*args), rtol=0, atol=0)
    assert torch.isfinite(depth.grad).all() and torch.isfinite(feat.grad).all()


def _voxel_case(case, cuda):
    """Points for the hard voxelizer: BEVFusion's nuScenes scans
    (make_cp_points, 2 x 250,000 points of 5 channels, pillars of 0.25 m
    onto 400 x 400 cells, 64 points a pillar, the eval cap 40,000), or a
    small overflowing lattice with NaN rows and points on cell faces."""
    import chip_smoke
    if case == "bevfusion":
        return (chip_smoke.make_cp_points(cuda, batch=2), (0.25, 0.25, 8.0),
                (-50., -50., -5., 50., 50., 3.), 64, 40000)
    rng = np.random.default_rng(31)
    lattice = np.stack(np.meshgrid(*(np.arange(0, 2.01, 0.25),) * 3,
                                   indexing="ij"), -1).reshape(-1, 3)
    pts = np.concatenate([np.tile(lattice, (3, 1)),
                          rng.uniform(-0.5, 2.5, (700, 3))])
    pts = np.concatenate([pts, rng.uniform(0, 1, (len(pts), 1))], -1)
    pts = rng.permutation(pts)[None].repeat(2, 0)
    pts[1, ::9] = np.nan
    return (torch.from_numpy(pts.astype(np.float32)).to(cuda),
            (0.5, 0.5, 0.5), (0., 0., 0., 2., 2., 2.), 3, 40)


@pytest.mark.parametrize("case", ["lattice", "bevfusion"])
def test_hard_voxelize_on_card_matches_cpu(cuda, case):
    """ops/voxelize.hard_voxelize_batch on the card (its sort, cumulative
    max and index writes) equal to the CPU's, output for output."""
    from paddle3d_tpu_torch.ops.voxelize import hard_voxelize_batch
    pts, vs, pc, p, v = _voxel_case(case, cuda)
    got = hard_voxelize_batch(pts, vs, pc, p, v)
    ref = hard_voxelize_batch(pts.cpu(), vs, pc, p, v)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)
    mask, num = ref[3], ref[2]
    assert mask.any() and (num[mask] > 0).all()
    if case == "bevfusion":
        assert (num == p).any() and bool(mask.all())


def test_bevfusion_pillar_canvas_runs_k2_and_k5_at_full_width(cuda,
                                                              monkeypatch):
    """The L+C config's lidar stream at full width on the card, from the
    hard voxelizer (train cap 30,000) through the buffer PFN to
    PointPillarsScatter: the forward launches K2 (sparse by the density
    rule: 30,000 pillars onto 400 x 400 cells), bit-equal to the row-order
    sum; the backward launches K5, bit-equal to its plain version; the PFN
    on the card within 1e-5 of the CPU's in eval mode."""
    import chip_smoke
    from paddle3d_tpu_torch.apis import Config
    model = Config(path=chip_smoke.BEVF, device="cpu").model
    vox, pfn, mid = (model.lidar_voxelizer, model.lidar_voxel_encoder,
                     model.lidar_middle_encoder)
    points = chip_smoke.make_cp_points(cuda, batch=2)
    voxels, coords, num, mask = vox(points, True)
    pfn.eval()
    ref = pfn(voxels.cpu(), num.cpu(), coords.cpu())
    pfn.to(cuda)
    feats = pfn(voxels, num, coords)
    torch.testing.assert_close(feats.cpu(), ref, rtol=0,
                               atol=1e-5 * ref.abs().max().item())
    seen = {}
    fwd, bwd = sorted_scatter.scatter_rows, sorted_scatter.sorted_table_gather

    def rec_fwd(*args):
        seen["fwd"] = (args, fwd(*args))
        return seen["fwd"][1]

    def rec_bwd(*args):
        seen["bwd"] = (args, bwd(*args))
        return seen["bwd"][1]
    monkeypatch.setattr(sorted_scatter, "scatter_rows", rec_fwd)
    monkeypatch.setattr(sorted_scatter, "sorted_table_gather", rec_bwd)
    rows = (feats.detach() * mask[..., None]).requires_grad_()
    before = dict(_build.LAUNCHES)
    canvas = mid(rows, coords, mask)
    canvas.permute(0, 3, 1, 2).contiguous().backward(
        torch.randn((2, 64, 400, 400), device=cuda))
    torch.cuda.synchronize()
    assert {k: _build.LAUNCHES[k] - before[k] for k in before
            if _build.LAUNCHES[k] != before[k]} == {
                "sorted_segment_sum": 1, "sorted_table_gather": 1}
    (keys, krows, n_cells, _), got = seen["fwd"]
    assert n_cells == 400 * 400 and keys.shape == (2, 30000)
    torch.testing.assert_close(got, _row_order_sum(keys, krows, n_cells),
                               rtol=0, atol=0)
    args, got = seen["bwd"]
    torch.testing.assert_close(
        got, sorted_scatter.sorted_table_gather_plain(*args), rtol=0, atol=0)
    assert torch.isfinite(rows.grad).all()


def test_png_unfilter_and_camera_batch_on_the_card_host(cuda, tmp_path):
    """The camera path's host code on the card's machine: the native PNG
    unfilter (built there with g++) equals the plain one on random rows of
    every filter type, chip_smoke's camera tree reads back equal to the
    arrays written, and a SMOKE-KITTI batch from it reaches the card."""
    import hashlib

    import chip_smoke
    from paddle3d_tpu_torch.apis.trainer import to_device
    from paddle3d_tpu_torch.datasets import KittiMonoDataset
    from paddle3d_tpu_torch.transforms import Gt2SmokeTarget
    from paddle3d_tpu_torch.utils import png
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, (40, 3 * 413 + 1), dtype=np.uint8)
    raw[:, 0] = np.arange(40) % 5
    np.testing.assert_array_equal(
        png.unfilter(raw.tobytes(), 40, 3 * 413, 3),
        png.unfilter_plain(raw.tobytes(), 40, 3 * 413, 3))
    hashes = {}
    chip_smoke.kitti_tree(str(tmp_path), train=4, val=1, points=2000,
                          images=True, hashes=hashes)
    ds = KittiMonoDataset(str(tmp_path), class_names=["Car"],
                          transforms=[Gt2SmokeTarget(mode="train",
                                                     num_classes=1)])
    raw_ds = KittiMonoDataset(str(tmp_path), class_names=["Car"])
    for i in range(4):
        assert hashlib.sha256(raw_ds[i].data.tobytes()).hexdigest() == \
            hashes[raw_ds.ids[i]]
    batch, _ = ds.collate_fn([ds[i] for i in range(4)])
    dev = to_device(batch, cuda)
    assert dev["data"].shape == (4, 384, 1280, 3) and dev["data"].is_cuda
    assert all(v.is_cuda for v in dev["target"].values())
