"""Port parity of the train-mode pillar kernels' plain versions against the
JAX package: K3 (`pfn_stats`) against `_pfn_stats`, K4 (`pfn_bwd`) against
`_pfn_bwd`, K5 (`sorted_table_gather`) against `_sorted_table_gather_tg`,
all in interpret mode, and K5 against the XLA VJP of sorted_segment_sum;
then the port's train `fused_pillar_canvas` against
`_fused_pillar_canvas_pallas_train` (interpret) and the XLA train path.

Tolerances: K3/K4 sums 1e-5 of each output's largest magnitude (f32 sums of
~1e3 terms in another order); K5 exact (a gather); the canvas, the running
stats and the PFN grads as tests/ops/test_fused_pfn_train.py holds the
JAX kernel path against its XLA path (2e-3 / 5e-3), and 1e-4 / 1e-5 against
the interpret path, which folds the BN the same way."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from paddle3d_tpu.models.middle_encoders.pillar_scatter import \
    PointPillarsScatter as JaxScatter
from paddle3d_tpu.models.voxel_encoders.pillar_encoder import \
    PillarFeatureNet as JaxPFN
from paddle3d_tpu.models.voxelizers.voxelize import HardVoxelizer as JaxVox
from paddle3d_tpu.ops.pallas.fused_pfn_train import _pfn_bwd, _pfn_stats
from paddle3d_tpu.ops.pallas.sorted_scatter import (
    _sorted_table_gather_tg, sorted_segment_sum as jax_ssum,
    sorted_segment_sum_split as jax_ssum_split)
from paddle3d_tpu.ops.pillar_ops import (_fused_pillar_canvas_pallas_train,
                                         fused_pillar_canvas as jax_canvas,
                                         sort_points_by_cell)
from paddle3d_tpu_torch.models.middle_encoders import PointPillarsScatter
from paddle3d_tpu_torch.models.voxel_encoders import PillarFeatureNet
from paddle3d_tpu_torch.models.voxelizers import HardVoxelizer
from paddle3d_tpu_torch.ops import fused_pfn_train, sorted_scatter
from paddle3d_tpu_torch.ops.pillar_ops import fused_pillar_canvas
from paddle3d_tpu_torch.utils.convert import load_jax_params, to_torch_names

PC_RANGE = (0., -4., -2., 12.8, 4., 2.)   # grid 32 x 20 @ 0.4
VOXEL = (0.4, 0.4, 4.0)
GEO = dict(nx=32, vx=0.4, vy=0.4, x_off=0.2, y_off=-3.8)
SENT = 2**31 - 1


def flat_state(module, kinds=(nnx.Param, nnx.BatchStat)):
    """nnx parameters and running stats as {dotted path: numpy array}."""
    return {".".join(map(str, k)): np.asarray(getattr(v, "value", v))
            for kind in kinds
            for k, v in nnx.state(module, kind).flat_state()}


def make_points(seed, b=2, n=1000):
    """tests/ops/test_fused_pfn.py's scans: half the points in four cells
    (pillars far over P), a tenth out of range (sentinel keys)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.array([0., -4., -2., 0.]), np.array([12.8, 4., 2., 1.])
    pts = rng.uniform(lo, hi, (b, n, 4)).astype(np.float32)
    k = n // 2
    centers = rng.uniform(lo[:2] + 0.5, hi[:2] - 0.5, (4, 2))
    asn = rng.integers(0, 4, k)
    pts[:, :k, 0] = centers[asn, 0] + rng.normal(0, .05, (b, k))
    pts[:, :k, 1] = centers[asn, 1] + rng.normal(0, .05, (b, k))
    pts[:, -n // 10:, 0] = 100.0
    return pts


def sorted_inputs(seed, maxV, u1=16):
    pts = make_points(seed)
    keys, pts_t = jax.vmap(functools.partial(
        sort_points_by_cell, voxel_size=VOXEL,
        point_cloud_range=PC_RANGE))(jnp.asarray(pts))
    rng = np.random.default_rng(seed + 1)
    w1t = rng.normal(0, .3, (u1, 9)).astype(np.float32)
    kw = dict(P=8, maxV=maxV, **GEO)
    return np.asarray(keys), np.asarray(pts_t), w1t, kw, rng


def close(got, ref, tol):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (err, tol)


@pytest.mark.parametrize("maxV", [512, 40])
def test_pfn_stats_plain_matches_interpret(maxV):
    keys, pts_t, w1t, kw, _ = sorted_inputs(maxV, maxV)
    ref = _pfn_stats(keys, pts_t, w1t, interpret=True, block_rows=256, **kw)
    t = torch.from_numpy
    s1, s2, count, t3, sx = fused_pfn_train.pfn_stats(t(keys), t(pts_t),
                                                      t(w1t), **kw)
    for got, want in zip((s1, s2, t3, sx), ref):
        assert got.shape == want.shape
        close(got.numpy(), want, 1e-5)
    assert 0 < count.item() <= 8 * maxV


@pytest.mark.parametrize("maxV", [512, 40])
def test_pfn_bwd_plain_matches_interpret(maxV):
    keys, pts_t, w1t, kw, rng = sorted_inputs(maxV + 3, maxV)
    u1, n = w1t.shape[0], keys.shape[1]
    a = rng.uniform(.5, 1.5, u1).astype(np.float32)
    c = rng.normal(0, .5, u1).astype(np.float32)
    mu = rng.normal(0, 1, u1).astype(np.float32)
    invsig = rng.uniform(.5, 2, u1).astype(np.float32)
    g = rng.normal(0, 1, (2, u1 + 1, n)).astype(np.float32)
    ref = _pfn_bwd(keys, pts_t, g[:, :u1], w1t, a[:, None], c[:, None],
                   mu[:, None], invsig[:, None], interpret=True,
                   block_rows=256, **kw)
    t = torch.from_numpy
    got = fused_pfn_train.pfn_bwd(t(keys), t(pts_t), t(g), t(w1t), t(a),
                                  t(c), t(mu), t(invsig), **kw)
    assert np.abs(np.asarray(ref[0])).max() > 0
    for gt, want in zip(got, ref):
        assert gt.shape == want.shape
        close(gt.numpy(), want, 1e-5)


def scatter_keys(seed, b=2, n=3000, cells=50000):
    """Sorted keys in two dense clusters and a sparse spread, duplicate
    runs, sentinel tails and an all-sentinel batch row."""
    rng = np.random.default_rng(seed)
    base = np.concatenate([rng.integers(0, 500, (b, n // 3)),
                           rng.integers(24000, 24500, (b, n // 3)),
                           rng.integers(0, cells, (b, n - 2 * (n // 3)))],
                          axis=1)
    keys = np.sort(base, axis=1).astype(np.int32)
    keys[:, -40:] = SENT
    keys[1, :] = SENT
    return keys, rng


def test_table_gather_plain_matches_interpret_and_xla_vjp():
    cells, c = 50000, 65
    keys, rng = scatter_keys(0)
    g = rng.standard_normal((2, cells, c)).astype(np.float32)
    got = sorted_scatter.sorted_table_gather(
        torch.from_numpy(keys), torch.from_numpy(g), None, cells, c).numpy()
    tg = np.array(_sorted_table_gather_tg(jnp.asarray(keys), jnp.asarray(g),
                                          cells, interpret=True))
    tg[keys >= cells] = 0         # the TPU kernel leaves these to the VJP
    np.testing.assert_array_equal(got, tg)
    rows = rng.standard_normal((2, keys.shape[1], c)).astype(np.float32)
    _, vjp = jax.vjp(lambda r: jax_ssum(jnp.asarray(keys), r, cells),
                     jnp.asarray(rows))
    np.testing.assert_array_equal(got, np.asarray(vjp(jnp.asarray(g))[0]))
    assert not got[1].any() and got[0].any()


def test_split_scatter_vjp_matches_xla():
    """The split form through torch autograd: the main channels' cotangent
    and an occupancy cotangent, then none for the occupancy (zero rows)."""
    cells, c = 50000, 5
    keys, rng = scatter_keys(1)
    rows = rng.standard_normal((2, keys.shape[1], c)).astype(np.float32)
    gm = rng.standard_normal((2, cells, c - 1)).astype(np.float32)
    ge = rng.standard_normal((2, cells, 1)).astype(np.float32)
    _, vjp = jax.vjp(lambda r: jax_ssum_split(jnp.asarray(keys), r, cells),
                     jnp.asarray(rows))
    want = np.asarray(vjp((jnp.asarray(gm), jnp.asarray(ge)))[0])
    r = torch.from_numpy(rows).requires_grad_()
    table, occ = sorted_scatter.sorted_segment_sum_split(
        torch.from_numpy(keys), r, cells)
    ((table * torch.from_numpy(gm)).sum()
     + (occ * torch.from_numpy(ge)).sum()).backward()
    np.testing.assert_allclose(r.grad.numpy(), want, rtol=0, atol=0)
    r.grad = None
    table, _ = sorted_scatter.sorted_segment_sum_split(
        torch.from_numpy(keys), r, cells)
    (table * torch.from_numpy(gm)).sum().backward()
    np.testing.assert_array_equal(r.grad[..., :-1].numpy(),
                                  want[..., :-1])
    assert not r.grad[..., -1].any()


def build_train_pair(max_voxels):
    """JAX modules (train-mode BN, randomised running stats and affine)
    and the port's, with the JAX state carried across."""
    vox = JaxVox(VOXEL, PC_RANGE, 8, [max_voxels, max_voxels])
    mods = []
    for _ in range(3):          # XLA path, interpret path, the port's source
        pfn = JaxPFN(in_channels=4, feat_channels=(16,),
                     max_num_points_in_voxel=8, voxel_size=VOXEL,
                     point_cloud_range=PC_RANGE, legacy=False,
                     rngs=nnx.Rngs(0))
        rng = np.random.default_rng(3)
        bn = pfn.pfn_layers[0].mlp.bn
        c = bn.mean.value.shape
        bn.mean.value = jnp.asarray(rng.normal(0, .2, c), jnp.float32)
        bn.var.value = jnp.asarray(rng.uniform(.5, 2., c), jnp.float32)
        bn.scale.value = jnp.asarray(rng.uniform(.5, 1.5, c), jnp.float32)
        bn.bias.value = jnp.asarray(rng.normal(0, .2, c), jnp.float32)
        bn.use_running_average = False
        mods.append(pfn)
    mid = JaxScatter(16, VOXEL, PC_RANGE)
    t_pfn = PillarFeatureNet(in_channels=4, feat_channels=(16,),
                             max_num_points_in_voxel=8, voxel_size=VOXEL,
                             point_cloud_range=PC_RANGE, legacy=False)
    load_jax_params(t_pfn, flat_state(mods[2]))
    return (vox, mods[0], mods[1], mid,
            (HardVoxelizer(VOXEL, PC_RANGE, 8, [max_voxels, max_voxels]),
             t_pfn.train(), PointPillarsScatter(16, VOXEL, PC_RANGE)))


@pytest.mark.parametrize("max_voxels", [512, 40])
def test_train_canvas_matches_jax(max_voxels):
    vox, pfn_xla, pfn_int, mid, port = build_train_pair(max_voxels)
    pts = make_points(7 + max_voxels)
    w = np.random.default_rng(9).normal(0, 1, (2, 20, 32, 16)).astype(
        np.float32)

    def loss(fn, pfn):
        canvas, occ = fn(pfn)
        return jnp.sum(canvas * w), (canvas, occ)

    refs = []
    for pfn, fn in (
            (pfn_int, lambda p: _fused_pillar_canvas_pallas_train(
                vox, p, mid, jnp.asarray(pts), True, interpret=True)),
            (pfn_xla, lambda p: jax_canvas(vox, p, mid, jnp.asarray(pts),
                                           training=True,
                                           with_occupancy=True))):
        (_, (canvas, occ)), grads = nnx.value_and_grad(
            functools.partial(loss, fn), has_aux=True)(pfn)
        refs.append((canvas, occ, flat_state(pfn, (nnx.BatchStat,)),
                     flat_state(grads, (nnx.Param,))))

    t_pfn = port[1]
    canvas, occ = fused_pillar_canvas(*port, torch.from_numpy(pts), True,
                                      with_occupancy=True)
    assert canvas.requires_grad
    (canvas * torch.from_numpy(w)).sum().backward()
    got_stats = {k: v.numpy() for k, v in t_pfn.state_dict().items()
                 if "running" in k}
    got_grads = {k: p.grad.numpy() for k, p in t_pfn.named_parameters()}
    assert 0 < occ.sum(dim=(1, 2)).max() <= max_voxels
    for (ref_c, ref_o, ref_stats, ref_grads), (tol_c, tol_s, tol_g) in zip(
            refs, ((1e-4, 1e-5, 1e-4), (2e-3, 1e-5, 5e-3))):
        np.testing.assert_allclose(canvas.detach().numpy(),
                                   np.asarray(ref_c), rtol=tol_c,
                                   atol=tol_c)
        np.testing.assert_array_equal(occ.detach().numpy(), np.asarray(ref_o))
        want_stats = {k: v.numpy()
                      for k, v in to_torch_names(t_pfn, ref_stats).items()}
        assert set(want_stats) == set(got_stats)
        for k, v in want_stats.items():
            np.testing.assert_allclose(got_stats[k], v, rtol=tol_s,
                                       atol=tol_s)
        want_grads = {k: v.numpy()
                      for k, v in to_torch_names(t_pfn, ref_grads).items()}
        assert set(want_grads) == set(got_grads)
        for k, v in want_grads.items():
            np.testing.assert_allclose(got_grads[k], v, rtol=tol_g,
                                       atol=tol_g)
