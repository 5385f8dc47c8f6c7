"""Port parity: the plain fused PFN rows (paddle3d_tpu_torch) against the
JAX package's Pallas kernel in interpret mode.

Tolerance 1e-4 (as tests/ops/test_fused_pfn.py): the JAX kernel sums a
pillar's points by a doubling tree and the port in row order, so the
decoration and the 9-term products differ in the last bits."""
import functools

import jax
import numpy as np
import pytest
import torch

from paddle3d_tpu.ops.pallas.fused_pfn import fused_pfn_rows as jax_rows
from paddle3d_tpu.ops.pillar_ops import sort_points_by_cell
from paddle3d_tpu_torch.ops import fused_pfn

PC_RANGE = (0., -4., -2., 12.8, 4., 2.)   # grid 32 x 20 @ 0.4
VOXEL = (0.4, 0.4, 4.0)
NX = 32
GEO = dict(nx=NX, vx=0.4, vy=0.4, x_off=0.2, y_off=-3.8)


def make_sorted(seed, b=2, n=1000, c=4):
    """Clustered points (half in four cells: pillars far over P), with the
    last tenth out of range (sentinel keys), sorted by the JAX package."""
    rng = np.random.default_rng(seed)
    lo = np.array([0., -4., -2., 0., 0.])[:c]
    hi = np.array([12.8, 4., 2., 1., .5])[:c]
    pts = rng.uniform(lo, hi, (b, n, c)).astype(np.float32)
    k = n // 2
    centers = rng.uniform(lo[:2] + 0.5, hi[:2] - 0.5, (4, 2))
    asn = rng.integers(0, 4, k)
    pts[:, :k, 0] = centers[asn, 0] + rng.normal(0, .05, (b, k))
    pts[:, :k, 1] = centers[asn, 1] + rng.normal(0, .05, (b, k))
    pts[:, -n // 10:, 0] = 100.0
    keys, pts_t = jax.vmap(functools.partial(
        sort_points_by_cell, voxel_size=VOXEL,
        point_cloud_range=PC_RANGE))(pts)
    return np.array(keys), np.array(pts_t)


def make_weights(seed, c_dec, u1=16, u2=None):
    rng = np.random.default_rng(seed)
    w = [rng.normal(0, .3, (u1, c_dec)), rng.normal(0, .1, (u1, 1))]
    if u2:
        w += [rng.normal(0, .2, (u2, 2 * u1)), rng.normal(0, .1, (u2, 1))]
    else:
        w += [None, None]
    return [None if a is None else a.astype(np.float32) for a in w]


@pytest.mark.parametrize("n_layers,P,maxV,c_in,with_distance,occ,n", [
    # KITTI form: one layer + occupancy
    pytest.param(1, 8, 512, 4, False, True, 1000, id="1-8-512-4-False-True"),
    # max_voxels cap fires
    pytest.param(1, 8, 40, 4, False, True, 1000, id="1-8-40-4-False-True"),
    # CenterPoint form (plain only on CUDA)
    pytest.param(2, 8, 512, 4, False, False, 1000,
                 id="2-8-512-4-False-False"),
    # cap + distance + 5 channels
    pytest.param(2, 8, 40, 5, True, True, 1000, id="2-8-40-5-True-True"),
    # the one-layer kernel's edges: scan 0's cap on row 128 (maxV None: the
    # heads before it), N < P, N no multiple of 128 (nor of the 256-row
    # tiles)
    pytest.param(1, 8, None, 4, False, True, 1000, id="1-cap-at-row-128"),
    pytest.param(1, 8, 512, 4, False, True, 6, id="1-n-below-P"),
    pytest.param(1, 8, 512, 3, False, True, 777, id="1-n-777-c_in-3"),
])
def test_plain_matches_pallas_interpret(n_layers, P, maxV, c_in,
                                        with_distance, occ, n):
    keys, pts_t = make_sorted(n_layers * 10 + (maxV or 7) +
                              (n if n != 1000 else 0), n=n, c=c_in)
    if maxV is None:
        # a pillar head on row 128 of scan 0, and the cap just before it
        k = keys[0]
        if k[128] == k[127]:
            k[128:][k[128:] == k[128]] += 1
        heads = np.flatnonzero(k[:129] != np.r_[-1, k[:128]])
        maxV = len(heads) - 1
        assert heads[-1] == 128
    c_dec = c_in + 5 + int(with_distance)
    w1t, b1, w2t, b2 = make_weights(maxV, c_dec,
                                    u2=16 if n_layers == 2 else None)
    kw = dict(n_layers=n_layers, P=P, maxV=maxV, with_distance=with_distance,
              occupancy=occ, **GEO)
    # block_rows 256 < N: several grid steps, halos and the ordinal carry
    ref = np.asarray(jax_rows(keys, pts_t, w1t, b1, w2t, b2, interpret=True,
                              block_rows=256, **kw))
    t = lambda a: None if a is None else torch.from_numpy(a)
    out = fused_pfn.fused_pfn_rows(t(keys), t(pts_t), t(w1t), t(b1), t(w2t),
                                   t(b2), **kw).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    if occ:
        emit = out[:, -1]
        np.testing.assert_array_equal(emit, ref[:, -1])
        # the cap bounds the emitted pillars per scan
        assert (emit.sum(axis=1) <= maxV).all()
        assert emit.sum() > 0
        if n == 1000 and maxV < 100:    # the cap fires in scan 0
            assert emit[0].sum() == maxV


def test_pillar_ordinals_count_valid_heads():
    keys = torch.tensor([[2, 2, 5, 7, 7, 7, 2**31 - 1, 2**31 - 1]],
                        dtype=torch.int32)
    np.testing.assert_array_equal(
        fused_pfn.pillar_ordinals(keys)[0, :6].numpy(), [0, 0, 1, 2, 2, 2])
