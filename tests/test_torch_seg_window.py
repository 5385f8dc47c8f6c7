"""Port parity of the segmented window max (K12) and the segmented scans
and pillar decoration of the multi-layer pillar train path.

The port's plain versions of the K12 forward and backward against the JAX
package's Pallas kernel in interpret mode (values, arg-max offsets and
input gradients equal bit for bit: ties, segments longer than the window,
a length that is not a multiple of the Pallas block, the -1e9 mask, -0
values and cotangents, segments of 2 win + 1 rows that route every
cotangent to their middle row), against the XLA
form seg_window_max_bounded (values equal; on tie-free data the autograd
gradient equals jax.grad's, which splits tied cotangents where the kernel
routes them to one row), the bounded scans against ops/segmented.py, and
pillar_decorate_sorted / pillar_emit_rows against ops/pillar_ops.py.
Tolerances: 0 for maxes, copies, offsets and the backward (the same adds
in the same order); the decoration 1e-5 (the pillar mean sums in another
order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle3d_tpu.ops import pillar_ops as jax_pillar_ops
from paddle3d_tpu.ops import segmented as jax_segmented
from paddle3d_tpu.ops.pallas import seg_window as jax_seg_window
from paddle3d_tpu_torch.ops import _build, pillar_ops, segmented, seg_window

VOXEL = (0.5, 0.5, 4.0)
PC_RANGE = (0.0, -8.0, -2.0, 16.0, 8.0, 2.0)


def sorted_keys(rng, b, n, max_seg, sentinel_tail=0):
    """[b, n] ascending keys in runs of 1..max_seg-1 rows, the last
    sentinel_tail rows 2^31-1."""
    out = []
    for _ in range(b):
        ks, k = [], 0
        while len(ks) < n:
            ks.extend([k] * int(rng.integers(1, max_seg)))
            k += int(rng.integers(1, 9))
        out.append(ks[:n])
    keys = np.array(out, np.int32)
    if sentinel_tail:
        keys[:, -sentinel_tail:] = 2**31 - 1
    return keys


def make_case(name):
    rng = np.random.default_rng(SEEDS.index(name))
    b, n, c, max_seg, p, tail = CASES[name]
    keys = sorted_keys(rng, b, n, max_seg, tail)
    if name == "ties":
        # a lattice of exact ties: post-relu integers, many zeros
        vals = np.maximum(rng.integers(-3, 4, (b, n, c)), 0)
    else:
        vals = rng.normal(size=(b, n, c))
    if name == "masked":
        vals = np.where(rng.random((b, n, 1)) < 0.3, -1e9, vals)
    g = rng.normal(size=(b, n, c)).astype(np.float32)
    if name == "signed_zero":
        # -0 and +0 values tie; -0 cotangents, whole segments of them
        vals = np.where(rng.random((b, n, c)) < 0.5,
                        np.where(rng.random((b, n, c)) < 0.5, -0., 0.), vals)
        zero_g = (rng.random((b, n, 1)) < 0.5) | (keys % 3 == 0)[..., None]
        g = np.where(zero_g, np.float32(-0.), g)
    if name == "peak":
        # segments of 2 win + 1 rows, each with one maximum in its middle
        # row: that row receives from all 2 win positions, none skipped;
        # every other segment's cotangents are -0
        seg = 2 * seg_window.window_of(p) + 1
        keys = np.broadcast_to(np.arange(n, dtype=np.int32) // seg,
                               (b, n)).copy()
        vals[:, seg // 2::seg] += 10.
        g = np.where((keys % 2 == 0)[..., None], np.float32(-0.), g)
    return vals.astype(np.float32), keys, p, g


# name: (B, N, C, longest segment + 1, max_len, sentinel rows)
CASES = {
    "random": (2, 700, 8, 40, 20, 0),
    "ties": (2, 600, 8, 40, 20, 0),
    "long_segments": (1, 1100, 4, 120, 16, 0),      # segments >> window
    "masked": (2, 513, 16, 30, 20, 37),             # N = block + 1
    "signed_zero": (2, 600, 8, 12, 20, 0),
    "peak": (2, 630, 8, 64, 20, 0),                 # keys made in make_case
}
# each case's seed: its place here (new cases at the end)
SEEDS = ["long_segments", "masked", "random", "ties", "signed_zero", "peak"]


def bits(a):
    """The float32 bit patterns of a: equal bits tell -0 from +0."""
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_interpret(name):
    vals, keys, p, g = make_case(name)
    want, want_off = jax_seg_window._fwd(jnp.asarray(vals), jnp.asarray(keys),
                                         p, True, with_off=True)
    want_g, _ = jax_seg_window._vjp_bwd(p, True, want_off, jnp.asarray(g))
    out, off = seg_window.seg_window_max_plain(torch.from_numpy(vals),
                                               torch.from_numpy(keys), p)
    assert off.dtype == torch.int8
    np.testing.assert_array_equal(bits(out.numpy()), bits(want))
    np.testing.assert_array_equal(off.numpy().astype(np.int32),
                                  np.asarray(want_off))
    assert np.abs(off.numpy()).max() <= seg_window.window_of(p)
    got_g = seg_window.seg_window_max_bwd_plain(off, torch.from_numpy(g), p)
    np.testing.assert_array_equal(bits(got_g.numpy()), bits(want_g))
    if name == "signed_zero":
        # -0 in; a sum with a skipped (+0) term out is +0
        assert (bits(g) == bits(-0.)).mean() > 0.3
        assert (bits(got_g.numpy()) == bits(-0.)).sum() == 0
        assert (bits(out.numpy()) == bits(-0.)).sum() > 0
    if name == "peak":
        # each middle row takes all 2 win cotangents of its segment; a
        # segment of -0 cotangents sums to -0, added nowhere else
        middle = got_g.numpy()[:, 31::63]
        np.testing.assert_array_equal(off.numpy()[:, 31::63], 0)
        assert (bits(middle[:, ::2]) == bits(-0.)).all()
    if name == "ties":
        # ties routed to one row: each output's cotangent lands once
        assert (off.numpy() != 0).mean() > 0.3
        np.testing.assert_allclose(got_g.sum().item(), g.sum(), rtol=1e-4)


@pytest.mark.parametrize("name", sorted(CASES))
def test_values_match_xla_form(name):
    vals, keys, p, _ = make_case(name)
    want = jax.vmap(lambda v, k: jax_segmented.seg_window_max_bounded(
        v, k, p))(jnp.asarray(vals), jnp.asarray(keys))
    t_vals, t_keys = torch.from_numpy(vals), torch.from_numpy(keys)
    np.testing.assert_array_equal(
        segmented.seg_window_max_bounded(t_vals, t_keys, p).numpy(),
        np.asarray(want))
    np.testing.assert_array_equal(
        seg_window.seg_window_max(t_vals, t_keys, p).numpy(),
        np.asarray(want))


def test_autograd_matches_jax_grad_tie_free():
    vals, keys, p, g = make_case("random")
    want = jax.grad(lambda v: jnp.sum(jax.vmap(
        lambda a, k: jax_segmented.seg_window_max_bounded(a, k, p))(
            v, jnp.asarray(keys)) * g))(jnp.asarray(vals))
    t_vals = torch.from_numpy(vals).requires_grad_()
    (seg_window.seg_window_max(t_vals, torch.from_numpy(keys), p)
     * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(t_vals.grad.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    assert (t_vals.grad != 0).float().mean() < 0.9      # routed, not dense


def test_bounded_scans_match_jax():
    rng = np.random.default_rng(5)
    keys = sorted_keys(rng, 2, 300, 30, 11)
    vals = rng.normal(size=(2, 300, 3)).astype(np.float32)
    at = rng.random((2, 300)) < 0.2
    t_vals, t_keys = torch.from_numpy(vals), torch.from_numpy(keys)
    for p in (1, 7, 16):
        want_max = jax.vmap(lambda v, k: jax_segmented.seg_prefix_max_bounded(
            v, k, p))(jnp.asarray(vals), jnp.asarray(keys))
        np.testing.assert_array_equal(
            segmented.seg_prefix_max_bounded(t_vals, t_keys, p).numpy(),
            np.asarray(want_max))
        want_win = jax.vmap(lambda v, k: jax_segmented.seg_window_max_bounded(
            v, k, p))(jnp.asarray(vals), jnp.asarray(keys))
        np.testing.assert_array_equal(
            segmented.seg_window_max_bounded(t_vals, t_keys, p).numpy(),
            np.asarray(want_win))
        want_b = jax.vmap(
            lambda v, a, k: jax_segmented.seg_broadcast_from_bounded(
                v, a, k, p))(jnp.asarray(vals), jnp.asarray(at),
                             jnp.asarray(keys))
        np.testing.assert_array_equal(
            segmented.seg_broadcast_from_bounded(
                t_vals, torch.from_numpy(at), t_keys, p).numpy(),
            np.asarray(want_b))


def decorate_points(seed):
    """Two scans with dense pillars (more than P rows), NaN and
    out-of-range rows."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([0, -8, -2, 0, 0], [16, 8, 2, 1, .45], (2, 900, 5))
    pts[:, :300, :2] = pts[:, :1, :2] + rng.normal(0, .3, (2, 300, 2))
    pts[:, -6:, 0] = 100.
    pts[1, -12:-6] = np.nan
    return pts.astype(np.float32)


@pytest.mark.parametrize("max_voxels", [400, 30])
def test_pillar_decorate_and_emit_rows_match_jax(max_voxels):
    pts = decorate_points(max_voxels)
    p = 8
    want = jax.vmap(lambda x: jax_pillar_ops.pillar_decorate_sorted(
        x, VOXEL, PC_RANGE, p, max_voxels))(jnp.asarray(pts))
    got = pillar_ops.pillar_decorate_sorted(torch.from_numpy(pts), VOXEL,
                                            PC_RANGE, p, max_voxels)
    for name in ("keys", "head", "tail", "keep", "emit"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    # NaN-padded rows: the JAX form keeps NaN * 0 (a quirk the port does
    # not copy: its rows are zero)
    dec, ref = got["decorated"].numpy(), np.asarray(want["decorated"])
    nan_rows = np.isnan(ref).any(axis=-1)
    assert nan_rows.sum() == 6 and (dec[nan_rows] == 0).all()
    np.testing.assert_allclose(dec[~nan_rows], ref[~nan_rows], rtol=1e-5,
                               atol=1e-5)
    assert 0 < got["emit"].sum(dim=1).max() <= max_voxels
    feats = np.random.default_rng(1).normal(size=(2, 900, 6)).astype(
        np.float32)
    keys, keep, emit = got["keys"], got["keep"], got["emit"]
    want_rows = jax.vmap(lambda f, k, kp, e: jax_pillar_ops.pillar_emit_rows(
        f, k, kp, e, p))(jnp.asarray(feats), jnp.asarray(keys.numpy()),
                         jnp.asarray(keep.numpy()), jnp.asarray(emit.numpy()))
    rows = pillar_ops.pillar_emit_rows(torch.from_numpy(feats), keys, keep,
                                       emit, p)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    # the train path's form: the centred window max (K12) over the masked
    # rows, taken at the emission rows
    win = seg_window.seg_window_max(
        torch.where(keep[..., None], torch.from_numpy(feats), -1e9), keys, p)
    torch.testing.assert_close(torch.where(emit[..., None], win, 0.), rows,
                               rtol=0, atol=0)


def test_cpu_takes_no_kernel(monkeypatch):
    """A CPU tensor never reaches the kernel library or its counters."""
    def no_build():
        raise AssertionError("kernel library requested for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_build)
    before = dict(_build.LAUNCHES)
    vals, keys, p, g = make_case("random")
    t_vals = torch.from_numpy(vals).requires_grad_()
    (seg_window.seg_window_max(t_vals, torch.from_numpy(keys), p)
     * torch.from_numpy(g)).sum().backward()
    assert _build.LAUNCHES == before
    assert {"seg_window_max", "seg_window_max_bwd"} <= set(before)
