"""Port parity: the plain sorted segment sums (paddle3d_tpu_torch) against
the JAX package's Pallas kernels in interpret mode: the row-major K2, plain
and split forms, the channel-major K6 in both its TPU variants, and the
row-window K13 at the shapes of the JAX package's own K13 tests.

Tolerances: K2 1e-6 (both sides sum the same f32 rows per cell, only the
order differs; rows per cell ≤ a handful here); K6 and K13 1e-5 relative and
1e-4 absolute, as the JAX package's own tests state (the TPU kernels sum by
one-hot matrix products, K13 a window's rows first and then the carried
chunk, up to ~20 rows per cell here)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle3d_tpu.ops.pallas.sorted_scatter import (
    _sorted_segment_sum_cm, _sorted_segment_sum_cmg,
    _sorted_segment_sum_pallas, _sorted_segment_sum_rw, pick_cells_per_block,
    sorted_segment_sum_cm)
from paddle3d_tpu_torch.ops import pillar_ops, sorted_scatter

SENT = 2**31 - 1
NUM_CELLS = 1280   # two blocks of 640 cells on the JAX side


def make_inputs(seed, b=3, n=300, c=5):
    """Sorted keys with duplicates and sentinel tails; batch row 1 is
    empty (all sentinel)."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, NUM_CELLS, (b, n)), axis=1)
    keys[:, -40:] = SENT
    keys[0, 100:140] = keys[0, 100]          # one long duplicate run
    keys[1] = SENT
    keys = np.sort(keys, axis=1).astype(np.int32)
    rows = rng.normal(0, 1, (b, n, c)).astype(np.float32)
    return keys, rows


@pytest.mark.parametrize("split", [False, True])
def test_plain_matches_pallas_interpret(split):
    keys, rows = make_inputs(0)
    ref = _sorted_segment_sum_pallas(keys, rows, NUM_CELLS, interpret=True,
                                     split_last=split)
    kt, rt = torch.from_numpy(keys), torch.from_numpy(rows)
    if split:
        out, extra = sorted_scatter.sorted_segment_sum_split(kt, rt,
                                                             NUM_CELLS)
        assert out.shape == (3, NUM_CELLS, 4) and extra.shape == (3,
                                                                  NUM_CELLS,
                                                                  1)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref[0]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(extra.numpy(), np.asarray(ref[1]),
                                   rtol=1e-6, atol=1e-6)
    else:
        out = sorted_scatter.sorted_segment_sum(kt, rt, NUM_CELLS)
        assert out.shape == (3, NUM_CELLS, 5)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)
    assert not np.asarray(out[1]).any()      # the empty batch row


def test_plain_drops_out_of_range_keys():
    keys = torch.tensor([[0, 0, 3, 5, 9, SENT]], dtype=torch.int32)
    rows = torch.arange(6, dtype=torch.float32).reshape(1, 6, 1) + 1
    out = sorted_scatter.sorted_segment_sum_plain(keys, rows, 5)
    np.testing.assert_array_equal(out[0, :, 0].numpy(), [3, 0, 0, 3, 0])


def test_cpu_wrapper_takes_plain_version(monkeypatch):
    """A CPU tensor never reaches the kernel library or its counter."""
    def no_build():
        raise AssertionError("kernel library requested for a CPU tensor")

    monkeypatch.setattr(sorted_scatter._build, "library", no_build)
    before = sorted_scatter._build.LAUNCHES["sorted_segment_sum"]
    keys, rows = make_inputs(1)
    sorted_scatter.sorted_segment_sum(torch.from_numpy(keys),
                                      torch.from_numpy(rows), NUM_CELLS)
    assert sorted_scatter._build.LAUNCHES["sorted_segment_sum"] == before


def make_cm_inputs(seed, b, n, c, cells, wide=3, extra_cols=300):
    """Sorted keys with duplicates and sentinel tails (the last batch row
    all sentinel) and channel-major rows [B, c + wide, n + extra_cols]:
    channels past c and columns past n hold garbage the sum must not
    read."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, cells, (b, n)), axis=1)
    keys[:, -n // 8:] = SENT
    keys[0, 10:40] = keys[0, 10]                 # a long duplicate run
    keys[-1] = SENT
    keys = np.sort(keys, axis=1).astype(np.int32)
    rows_cm = rng.normal(0, 1, (b, c + wide, n + extra_cols)).astype(
        np.float32)
    rows_cm[:, c:] = 1e6
    rows_cm[:, :, n:] = 1e6
    return keys, rows_cm


def _jax_rows(keys, rows_cm, c):
    """The same rows as the JAX kernels take them: exactly c channels, zero
    past n (their producer's padding contract)."""
    n = keys.shape[1]
    return jnp.asarray(np.pad(rows_cm[:, :c, :n], ((0, 0), (0, 0), (0, 256))))


def _check_cm(got, ref, split):
    if split:
        assert got[0].shape == ref[0].shape and got[1].shape == ref[1].shape
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                       atol=1e-4)
        got = got[0]
    else:
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-4)
    assert not got[-1].numpy().any()             # the all-sentinel scan


@pytest.mark.parametrize("split", [False, True])
def test_cm_plain_matches_kernel_cm_interpret(split):
    """The TPU's `_kernel_cm` (sparse scan: 4,320 cells in blocks of 864)."""
    b, n, c, cells = 2, 600, 17, 4320
    keys, rows_cm = make_cm_inputs(4, b, n, c, cells)
    assert not pillar_ops.is_dense_scan(n, cells)
    ref = sorted_segment_sum_cm(jnp.asarray(keys), _jax_rows(keys, rows_cm, c),
                                cells, split_last=split, interpret=True)
    got = sorted_scatter.sorted_segment_sum_cm(
        torch.from_numpy(keys), torch.from_numpy(rows_cm), cells, c=c,
        split_last=split)
    _check_cm(got, ref, split)


@pytest.mark.parametrize("split", [False, True])
def test_cm_plain_matches_kernel_cmg_interpret(split):
    """The TPU's grouped `_kernel_cmg` at a small dense shape (4,096 cells,
    a multiple of 512 x 8; 2,048 rows a scan, dense by the JAX rule)."""
    b, n, c, cells = 2, 2048, 16, 4096
    keys, rows_cm = make_cm_inputs(5, b, n, c, cells)
    assert pillar_ops.is_dense_scan(n, cells)
    ref = _sorted_segment_sum_cmg(jnp.asarray(keys),
                                  _jax_rows(keys, rows_cm, c), c, cells,
                                  interpret=True, cpb=512, sb=8, wrows=2048,
                                  nviews=4, swidth=768, split_last=split)
    got = sorted_scatter.sorted_segment_sum_cm(
        torch.from_numpy(keys), torch.from_numpy(rows_cm), cells, c=c,
        split_last=split)
    _check_cm(got, ref, split)


def test_cm_plain_equals_row_major_sum():
    """All channels (c=None) of exact-width rows: the row-major plain sum on
    the transposed rows, bit for bit."""
    keys, rows_cm = make_cm_inputs(6, 3, 500, 8, 1280, wide=0,
                                   extra_cols=0)
    kt, rt = torch.from_numpy(keys), torch.from_numpy(rows_cm)
    got = sorted_scatter.sorted_segment_sum_cm(kt, rt, 1280)
    ref = sorted_scatter.sorted_segment_sum_plain(
        kt, rt.transpose(1, 2).contiguous(), 1280)
    assert torch.equal(got, ref)


def test_density_rule_matches_jax():
    """The port's copy of the TPU block rule and its density threshold."""
    for cells in (214272, 262144, 4096, 4320, 1000):
        assert sorted_scatter.pick_cells_per_block(cells) == \
            pick_cells_per_block(cells)
    assert pillar_ops.is_dense_scan(250000, 512 * 512)      # nuScenes
    assert not pillar_ops.is_dense_scan(20000, 214272)      # KITTI
    assert pillar_ops.is_dense_scan(1100, 64 * 64)
    assert not pillar_ops.is_dense_scan(1024, 64 * 64)


def make_rw_inputs(seed, b, n, c, cells):
    """The JAX K13 tests' inputs (tests/ops/test_sorted_scatter.py:_mk):
    sorted keys over cells + 40 (a tail past the table), normal rows,
    channel-major."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, cells + 40, size=(b, n)).astype(np.int32),
                   axis=1)
    rows = rng.normal(size=(b, n, c)).astype(np.float32)
    return keys, np.ascontiguousarray(rows.transpose(0, 2, 1))


def _check_rw(keys, rows_cm, c, cells, wrows):
    ref = _sorted_segment_sum_rw(jnp.asarray(keys), jnp.asarray(rows_cm), c,
                                 cells, interpret=True, wrows=wrows)
    got = sorted_scatter.sorted_segment_sum_rw(
        torch.from_numpy(keys), torch.from_numpy(rows_cm), c, cells)
    assert got.shape == ref.shape == (keys.shape[0], cells, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-4)
    return got


@pytest.mark.parametrize("b,n,c,cells,wrows", [
    (2, 5000, 64, 4096, 512),      # dense: many rows a chunk, chunk carries
    (2, 1200, 16, 65536, 256),     # sparse spans: the chunk-skip path
    (1, 4096, 8, 1024, 1024),      # an exact window multiple, heavy dupes
    (2, 700, 32, 2048, 256),       # four lane groups a flat row
])
def test_rw_plain_matches_kernel_rw_interpret(b, n, c, cells, wrows):
    """The TPU's `_kernel_rw` at the four shapes of the JAX package's test."""
    _check_rw(*make_rw_inputs(5, b, n, c, cells), c, cells, wrows)


def test_rw_prepadded_producer_buffer():
    """A longer, window-aligned producer buffer is taken as it is: its
    trailing columns (zero on the JAX side, garbage here) are not read."""
    keys, rows_cm = make_rw_inputs(6, 2, 900, 16, 4096)
    pad = 2 * 256 + (256 - 900 % 256)
    padded = np.pad(rows_cm, ((0, 0), (0, 0), (0, pad)))
    ref = _sorted_segment_sum_rw(jnp.asarray(keys), jnp.asarray(padded), 16,
                                 4096, interpret=True, wrows=256)
    padded[:, :, 900:] = 1e6
    got = sorted_scatter.sorted_segment_sum_rw(
        torch.from_numpy(keys), torch.from_numpy(padded), 16, 4096)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-4)


def test_rw_empty_batch_row():
    """A batch row with no valid key gives an all-zero table."""
    keys, rows_cm = make_rw_inputs(7, 2, 600, 8, 1024)
    keys[1] = SENT
    got = _check_rw(keys, rows_cm, 8, 1024, 256)
    assert not got[1].numpy().any() and got[0].numpy().any()


def test_rw_rejects_non_divisor_c():
    """c must divide 128, on both sides; the cell-major sum takes c = 65."""
    keys, rows_cm = make_rw_inputs(8, 1, 2000, 65, 512)
    with pytest.raises(ValueError):
        _sorted_segment_sum_rw(jnp.asarray(keys), jnp.asarray(rows_cm), 65,
                               512)
    kt, rt = torch.from_numpy(keys), torch.from_numpy(rows_cm)
    with pytest.raises(ValueError, match="dividing 128"):
        sorted_scatter.sorted_segment_sum_rw(kt, rt, 65, 512)
    with pytest.raises(ValueError, match="dividing 128"):
        sorted_scatter.sorted_segment_sum_rw_plain(kt, rt, 65, 512)
    assert sorted_scatter.sorted_segment_sum_cm(kt, rt, 512).shape == \
        (1, 512, 65)


def test_rw_plain_equals_row_major_sum(monkeypatch):
    """The row-order plain version equals the CPU row-major plain sum bit for
    bit (negative keys, a long run and a channel-major view wider than c
    included), and a CPU tensor never reaches the kernel library."""
    def no_build():
        raise AssertionError("kernel library requested for a CPU tensor")

    monkeypatch.setattr(sorted_scatter._build, "library", no_build)
    keys, rows_cm = make_rw_inputs(9, 3, 3000, 32, 700)
    keys[0, :20] = -3
    keys[1, 100:600] = keys[1, 100]
    keys = np.sort(keys, axis=1)
    wide = np.concatenate([rows_cm, np.full_like(rows_cm[:, :3], 1e6)], 1)
    kt, rt = torch.from_numpy(keys), torch.from_numpy(wide)
    got = sorted_scatter.sorted_segment_sum_rw(kt, rt, 32, 700)
    ref = sorted_scatter.sorted_segment_sum_plain(
        kt, torch.from_numpy(rows_cm).transpose(1, 2).contiguous(), 700)
    assert torch.equal(got, ref)
    assert sorted_scatter._build.LAUNCHES["sorted_segment_sum_rw"] == 0


@pytest.mark.parametrize("entry", ["cm", "rw"])
def test_kernel_edge_shapes_match_interpret(entry):
    """At the edges of the card kernel K6 and K13 share: one cell holding
    200 rows, more than a stage buffer at c = 64 (128 rows), and 1,000
    cells, no multiple of its 128-cell tile (sentinel tails and an
    all-sentinel scan beside). The port's sorted_segment_sum_cm and
    sorted_segment_sum_rw on the CPU against the JAX package's
    _sorted_segment_sum_cm and _sorted_segment_sum_rw in interpret mode,
    1e-5 relative and 1e-4 absolute (the TPU kernels sum by one-hot matrix
    products, up to 200 rows a cell here)."""
    b, n, c, cells = 2, 700, 64, 1000
    keys, rows_cm = make_cm_inputs(10, b, n, c, cells)
    keys[0, 300:500] = keys[0, 300]                   # the 200-row cell
    assert keys[0, 300] < cells
    kt, rt = torch.from_numpy(keys), torch.from_numpy(rows_cm)
    if entry == "cm":
        ref = _sorted_segment_sum_cm(jnp.asarray(keys),
                                     _jax_rows(keys, rows_cm, c), c, cells,
                                     interpret=True)
        got = sorted_scatter.sorted_segment_sum_cm(kt, rt, cells, c=c)
    else:
        ref = _sorted_segment_sum_rw(jnp.asarray(keys),
                                     _jax_rows(keys, rows_cm, c), c, cells,
                                     interpret=True, wrows=256)
        got = sorted_scatter.sorted_segment_sum_rw(kt, rt, c, cells)
    assert got.shape == ref.shape == (b, cells, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-4)
    assert not got[-1].numpy().any()                  # the all-sentinel scan
    assert got[0, keys[0, 300]].abs().sum() > 0
