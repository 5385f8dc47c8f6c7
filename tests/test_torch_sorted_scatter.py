"""Port parity: the plain sorted segment sum (paddle3d_tpu_torch) against
the JAX package's Pallas kernel in interpret mode, plain and split forms.

Tolerance 1e-6: both sides sum the same f32 rows per cell, only the order
differs (rows per cell ≤ a handful here)."""
import numpy as np
import pytest
import torch

from paddle3d_tpu.ops.pallas.sorted_scatter import _sorted_segment_sum_pallas
from paddle3d_tpu_torch.ops import sorted_scatter

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
