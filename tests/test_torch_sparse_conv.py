"""Port parity of the sparse-voxel building blocks (paddle3d_tpu_torch)
against the JAX package on the CPU: the sparse 3-D conv's plain version
(K8's oracle) against the gather formulation of ops/sparse.py and the Pallas
kernel in interpret mode, downsample_coords, the fused voxelize + mean and
its segmented scans, and the dense row-major segment sum (K7's plain
version) against the Pallas kernel in interpret mode, with the density rule
that picks K7 on the card.

A prebuilt neighbour map (the map kernel's plain version) changes nothing:
the plain conv with one equals the plain conv without one bit for bit, and
the middle encoders, which build one map a key set and hand it on, equal
the route where every conv builds its own.

Tolerances: the sparse conv 1e-5 of the output's largest value (f32 sums of
<= 27 * Cin products in another order: tap by tap here, one dot there);
the Pallas kernel 2e-2, its own test's bf16 tolerance; downsample_coords
and the voxel coords bit-exact; the voxel means 1e-6 relative (the same
doubling scan); K7 1e-5 (the same rows per cell in another order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flax import nnx

from paddle3d_tpu.models.layers.sparse_layers import \
    MaskedBatchNorm as JaxMaskedBN
from paddle3d_tpu.models.voxel_encoders.voxel_encoder import \
    VoxelMean as JaxVoxelMean
from paddle3d_tpu.ops import segmented as jseg
from paddle3d_tpu.ops import sparse as jsparse
from paddle3d_tpu.ops.pallas.sorted_scatter import _sorted_segment_sum_bs
from paddle3d_tpu.ops.pallas.sparse_conv import sparse_conv3d_win
from paddle3d_tpu.ops.voxelize import voxel_mean_batch as jax_voxel_mean
from paddle3d_tpu_torch.models.layers.sparse_layers import (MaskedBatchNorm,
                                                            SparseConv3D)
from paddle3d_tpu_torch.models.voxel_encoders import VoxelMean
from paddle3d_tpu_torch.ops import segmented, sorted_scatter, sparse
from paddle3d_tpu_torch.ops import sparse_conv as sparse_conv_mod
from paddle3d_tpu_torch.ops.sparse_conv import (neighbour_map, sparse_conv3d,
                                                sparse_conv3d_map,
                                                sparse_conv3d_plain)
from paddle3d_tpu_torch.ops.voxelize import voxel_mean_batch

GRID = (7, 24, 20)          # (D, H, W); odd D as at the extra conv's input


def make_set(seed, b=2, v=300, cin=6, grid=GRID):
    """Sorted unique coords per scan with a masked tail, as the voxelizer
    and downsample_coords emit them; padding keys are the layers' distinct
    sentinels D*H*W + 7 + row."""
    rng = np.random.default_rng(seed)
    d, h, w = grid
    coords = np.stack([rng.integers(0, d, (b, v)), rng.integers(0, h, (b, v)),
                       rng.integers(0, w, (b, v))], -1)
    lin = coords[..., 0] * (h * w) + coords[..., 1] * w + coords[..., 2]
    out_c = np.zeros((b, v, 3), np.int32)
    mask = np.zeros((b, v), bool)
    for i in range(b):
        uk, idx = np.unique(lin[i], return_index=True)
        n = len(uk) - 10 * i                # a shorter second scan
        out_c[i, :n] = coords[i, idx[:n]]
        mask[i, :n] = True
    feats = rng.normal(size=(b, v, cin)).astype(np.float32)
    feats[~mask] = 0.0
    keys = SparseConv3D._lin_keys(torch.from_numpy(out_c),
                                  torch.from_numpy(mask), grid)
    return keys, out_c, mask, feats


def epilogue(rng, cout, fused):
    if not fused:
        return None, None, False
    return (rng.uniform(.5, 1.5, cout).astype(np.float32),
            rng.normal(0, .5, cout).astype(np.float32), True)


CASES = {   # name: (kernel_size, stride, out_capacity)
    "subm": (3, 1, None),
    "strided": (3, 2, 128),
    "z_stride": (3, (2, 1, 1), 200),
    "k1": (1, 1, None),
}


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_gather_reference(case, fused):
    """K8's plain version against ops/sparse.py's gather + one matmul, with
    and without the fused scale / shift / relu epilogue."""
    ksize, stride, cap = CASES[case]
    keys, coords, mask, feats = make_set(1)
    rng = np.random.default_rng(2)
    cin, cout = feats.shape[-1], 16
    w = (rng.normal(size=(ksize ** 3 * cin, cout)) * .2).astype(np.float32)
    scale, shift, relu = epilogue(rng, cout, fused)
    d, h, w_ = GRID

    def ref_one(f, c, m):
        if stride == 1:
            oc, om = c, m
        else:
            oc, om = jsparse.downsample_coords(c, m, GRID, stride, cap)
        g = jsparse.sparse_gather_neighbors(f, c, m, oc, om, ksize, GRID,
                                            stride=stride)
        out = jnp.dot(g.reshape(g.shape[0], -1), w)
        if fused:
            out = jnp.maximum(out * scale + shift, 0.)
        return out * om[:, None], oc, om

    ref, oc, om = jax.vmap(ref_one)(jnp.asarray(feats), jnp.asarray(coords),
                                    jnp.asarray(mask))
    if stride == 1:
        qbase = keys
    else:
        got_c, got_m = sparse.downsample_coords(
            torch.from_numpy(coords), torch.from_numpy(mask), GRID, stride,
            cap)
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(oc))
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(om))
        sv = torch.tensor(stride if isinstance(stride, tuple) else
                          (stride,) * 3, dtype=torch.int32)
        qbase = SparseConv3D._lin_keys(got_c * sv, got_m, GRID)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    got = sparse_conv3d(qbase, keys, torch.from_numpy(feats),
                        torch.from_numpy(w), d, h, w_, ksize, scale=t(scale),
                        shift=t(shift), relu=relu)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got.numpy() - ref).max()
    assert err <= 1e-5 * np.abs(ref).max(), err
    # padding rows stay exactly zero (the sentinel invariant downstream)
    assert not got.numpy()[~np.asarray(om)].any()


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_with_prebuilt_map_equals_without(case, fused):
    """sparse_conv3d_plain (and sparse_conv3d on the CPU) given the
    neighbour map of its keys equals it building its own, bit for bit; the
    map entry takes neighbour_map on the CPU, int32 [B, Vq, K^3]; a map of
    the wrong shape is refused."""
    ksize, stride, cap = CASES[case]
    keys, coords, mask, feats = make_set(6)
    rng = np.random.default_rng(7)
    cin, cout = feats.shape[-1], 32
    w = torch.from_numpy((rng.normal(size=(ksize ** 3 * cin, cout)) * .2)
                         .astype(np.float32))
    scale, shift, relu = epilogue(rng, cout, fused)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    d, h, w_ = GRID
    qbase = keys
    if stride != 1:
        oc, om = sparse.downsample_coords(torch.from_numpy(coords),
                                          torch.from_numpy(mask), GRID,
                                          stride, cap)
        sv = torch.tensor(stride if isinstance(stride, tuple) else
                          (stride,) * 3, dtype=torch.int32)
        qbase = SparseConv3D._lin_keys(oc * sv, om, GRID)
    nbr = sparse_conv3d_map(qbase, keys, d, h, w_, ksize)
    assert nbr.dtype == torch.int32
    assert tuple(nbr.shape) == (2, qbase.shape[1], ksize ** 3)
    assert torch.equal(nbr, neighbour_map(qbase, keys, d, h, w_, ksize))
    args = (qbase, keys, torch.from_numpy(feats), w, d, h, w_, ksize)
    kw = dict(scale=t(scale), shift=t(shift), relu=relu)
    ref = sparse_conv3d_plain(*args, **kw)
    assert ref.abs().max() > 0
    torch.testing.assert_close(sparse_conv3d_plain(*args, **kw, nbr=nbr),
                               ref, rtol=0, atol=0)
    torch.testing.assert_close(sparse_conv3d(*args, **kw, nbr=nbr), ref,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="nbr"):
        sparse_conv3d_plain(*args, **kw, nbr=nbr[:, 1:])


def _encoder_inputs(seed, b=2, v=400, cin=5, grid=(17, 20, 20)):
    """Sorted unique voxel coords per scan with a masked tail, and their
    features (zero on padding rows)."""
    rng = np.random.default_rng(seed)
    d, h, w = grid
    coords = np.zeros((b, v, 3), np.int32)
    mask = np.zeros((b, v), bool)
    for i in range(b):
        lin = np.unique(rng.integers(0, d * h * w, 2 * v))[:v - 30 * (i + 1)]
        coords[i, :len(lin)] = np.stack(
            [lin // (h * w), lin // w % h, lin % w], -1)
        mask[i, :len(lin)] = True
    feats = rng.normal(size=(b, v, cin)).astype(np.float32)
    feats[~mask] = 0.0
    return (torch.from_numpy(feats), torch.from_numpy(coords),
            torch.from_numpy(mask))


@pytest.mark.parametrize("kind,maps", [("SparseResNet3D", 8),
                                       ("SparseNet3D", 7)])
def test_stage_map_reuse_matches_per_conv_maps(kind, maps, monkeypatch):
    """The middle encoders in eval build one neighbour map a key set (the
    submanifold convs of a stage share one; each strided conv builds its
    own): 8 builds a SparseResNet3D forward over its 21 convs, 7 a
    SparseNet3D forward over its 8. The BEV and every stage's features
    equal, bit for bit, the route where each conv builds its own map."""
    from paddle3d_tpu_torch.models.middle_encoders import sparse_resnet
    cin = 5 if kind == "SparseResNet3D" else 4
    enc = getattr(sparse_resnet, kind)(
        in_channels=cin, voxel_size=(0.4, 0.4, 0.25),
        point_cloud_range=(0, 0, -2, 8, 8, 2),
        generator=torch.Generator().manual_seed(0)).eval()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, MaskedBatchNorm):
                n = m.weight.shape[0]
                m.weight.uniform_(.5, 1.5, generator=gen)
                m.bias.normal_(0, .2, generator=gen)
                m.running_mean.normal_(0, .2, generator=gen)
                m.running_var.uniform_(.5, 1.5, generator=gen)
                assert m.running_var.shape == (n,)
    assert enc.grid == (17, 20, 20)
    feats, coords, mask = _encoder_inputs(2, cin=cin)
    built, convs = [], []
    map_fn, conv_fn = sparse_conv_mod.sparse_conv3d_map, \
        sparse_conv_mod.sparse_conv3d

    def map_rec(*a):
        built.append(a)
        return map_fn(*a)

    def conv_rec(*a, **k):
        convs.append(k["nbr"])
        return conv_fn(*a, **k)

    monkeypatch.setattr(sparse_conv_mod, "sparse_conv3d_map", map_rec)
    monkeypatch.setattr(sparse_conv_mod, "sparse_conv3d", conv_rec)
    with torch.no_grad():
        bev, stages = enc(feats, coords, mask, return_stages=True)
    assert len(built) == maps
    assert len(convs) == (21 if kind == "SparseResNet3D" else 8)
    assert len({id(n) for n in convs}) == maps

    def own_map(*a, nbr=None, **k):       # every conv builds its own map
        return conv_fn(*a, **k)

    monkeypatch.setattr(sparse_conv_mod, "sparse_conv3d", own_map)
    with torch.no_grad():
        ref_bev, ref_stages = enc(feats, coords, mask, return_stages=True)
    assert bev.abs().max() > 0
    torch.testing.assert_close(bev, ref_bev, rtol=0, atol=0)
    for (st, s), (ref, r) in zip(stages, ref_stages):
        assert s == r
        torch.testing.assert_close(st.features, ref.features, rtol=0,
                                   atol=0)


@pytest.mark.parametrize("stride", [1, 2, (2, 1, 1)])
def test_gather_path_matches_jax(stride):
    """ops/sparse.py per sample, as the JAX package's gather path calls
    it: the neighbour gather (and for stride 1 the submanifold conv)
    against the JAX functions, exact (a gather) and 1e-5 (one dot)."""
    _, coords, mask, feats = make_set(9, b=1, v=200)
    c, m, f = coords[0], mask[0], feats[0]
    if stride == 1:
        oc, om = c, m
    else:
        oc, om = (np.array(a) for a in jsparse.downsample_coords(
            jnp.asarray(c), jnp.asarray(m), GRID, stride, 150))
    t = torch.from_numpy
    ref = jsparse.sparse_gather_neighbors(
        jnp.asarray(f), jnp.asarray(c), jnp.asarray(m), jnp.asarray(oc),
        jnp.asarray(om), 3, GRID, stride=stride)
    got = sparse.sparse_gather_neighbors(t(f), t(c), t(m), t(oc), t(om), 3,
                                         GRID, stride=stride)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert np.asarray(ref).any()
    if stride == 1:
        w = np.random.default_rng(3).normal(size=(27 * 6, 16)).astype(
            np.float32)
        ref = jsparse.subm_conv3d_gather(jnp.asarray(f), jnp.asarray(c),
                                         jnp.asarray(m), jnp.asarray(w),
                                         GRID)
        got = sparse.subm_conv3d_gather(t(f), t(c), t(m), t(w), GRID)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


def test_voxel_mean_and_masked_bn_match_jax():
    """VoxelMean's buffer forward and MaskedBatchNorm's eval form (and its
    folded affine) against the JAX layers."""
    rng = np.random.default_rng(4)
    voxels = rng.normal(size=(2, 30, 10, 5)).astype(np.float32)
    num = rng.integers(0, 11, (2, 30)).astype(np.int32)
    ref = JaxVoxelMean(in_channels=4)(jnp.asarray(voxels), jnp.asarray(num),
                                      None)
    got = VoxelMean(in_channels=4)(torch.from_numpy(voxels),
                                   torch.from_numpy(num))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    jbn = JaxMaskedBN(16, rngs=nnx.Rngs(0))
    bn = MaskedBatchNorm(16).eval()
    for jname, tname, val in (
            ("scale", "weight", rng.uniform(.5, 1.5, 16)),
            ("bias", "bias", rng.normal(0, .5, 16)),
            ("mean", "running_mean", rng.normal(0, .5, 16)),
            ("var", "running_var", rng.uniform(.5, 2., 16))):
        getattr(jbn, jname).value = jnp.asarray(val, jnp.float32)
        getattr(bn, tname).data = torch.tensor(val, dtype=torch.float32)
    jbn.use_running_average = True
    x = rng.normal(size=(2, 40, 16)).astype(np.float32)
    m = rng.uniform(size=(2, 40)) < .7
    ref = jbn(jnp.asarray(x), jnp.asarray(m))
    got = bn(torch.from_numpy(x), torch.from_numpy(m))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    s, b = bn.fold_affine()
    js, jb = jbn.fold_affine()
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(b.detach().numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-6)


def test_plain_equals_kernel_formula_with_sentinels():
    """The plain version is what the kernel computes: misses, padding and
    out-of-grid taps add nothing, so on features that are one-hot per row
    every output is a sum of exactly the weights its hits name."""
    keys, coords, mask, _ = make_set(3, b=1, v=60)
    d, h, w = GRID
    v = keys.shape[1]
    feats = torch.zeros((1, v, v))
    feats[0, torch.arange(v), torch.arange(v)] = 1.0
    feats[0, ~torch.from_numpy(mask[0])] = 0.0
    weights = torch.arange(27 * v, dtype=torch.float32)[:, None].repeat(1, 16)
    out = sparse_conv3d_plain(keys, keys, feats, weights, d, h, w, 3)
    nbr = neighbour_map(keys, keys, d, h, w, 3)[0]          # [V, 27]
    taps = torch.arange(27)[None].expand(v, -1)
    want = torch.where(nbr >= 0, taps * v + nbr, 0).float().sum(dim=1)
    torch.testing.assert_close(out[0, :, 0],
                               want * torch.from_numpy(mask[0]), rtol=0,
                               atol=0)
    # the centre tap of every valid row hits itself, padding rows hit none
    assert (nbr[torch.from_numpy(mask[0]), 13] >= 0).all()
    assert (nbr[~torch.from_numpy(mask[0])] == -1).all()


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_plain_matches_pallas_interpret(fused):
    """One small submanifold case against the TPU kernel in interpret mode
    (bf16 one-hot matching there)."""
    keys, _, mask, feats = make_set(4, b=2, v=150)
    rng = np.random.default_rng(5)
    cout = 16
    w = (rng.normal(size=(27 * feats.shape[-1], cout)) * .2).astype(
        np.float32)
    scale, shift, relu = epilogue(rng, cout, fused)
    d, h, w_ = GRID
    j = (lambda a: None if a is None else jnp.asarray(a))
    ref = sparse_conv3d_win(jnp.asarray(keys.numpy()), jnp.asarray(
        keys.numpy()), jnp.asarray(feats), jnp.asarray(w), d, h, w_,
        kernel_size=3, interpret=True, scale=j(scale), shift=j(shift),
        relu=relu)
    t = (lambda a: None if a is None else torch.from_numpy(a))
    got = sparse_conv3d(keys, keys, torch.from_numpy(feats),
                        torch.from_numpy(w), d, h, w_, 3, scale=t(scale),
                        shift=t(shift), relu=relu)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-2,
                               atol=2e-2)
    assert not got.numpy()[~mask].any()


@pytest.mark.parametrize("stride,cap", [(2, 40), (2, 500), ((2, 1, 1), 400)])
def test_downsample_coords_at_capacity(stride, cap):
    """The strided output set bit for bit, with the capacity cutting the
    highest keys, and the z-only stride on an odd depth: D = 7 -> 3, so the
    top layer z = 6 lands on z = 3 >= 3, out of the output grid; a key
    equal to the internal sentinel od*oh*ow + 1 counts as empty."""
    _, coords, mask, _ = make_set(6, b=2, v=300)
    coords[0, :3] = [[6, 0, 1], [6, 0, 1], [6, 5, 5]]
    mask[0, :3] = True
    d, h, w = GRID
    ref = jax.vmap(lambda c, m: jsparse.downsample_coords(
        c, m, GRID, stride, cap))(jnp.asarray(coords), jnp.asarray(mask))
    got = sparse.downsample_coords(torch.from_numpy(coords),
                                   torch.from_numpy(mask), GRID, stride, cap)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if stride == (2, 1, 1):
        oc = got[0][0][got[1][0]]
        sentinel = 3 * h * w + 1                     # z=3, y=0, x=1
        keys = oc[:, 0] * h * w + oc[:, 1] * w + oc[:, 2]
        assert sentinel not in keys.tolist()         # dropped as empty
        assert (oc[:, 0] == 3).any()                 # z=3 kept, >= D
    if cap == 40:
        assert got[1].all()                          # every stage full


def make_points(seed, b=2, n=3000):
    """Scans for the voxel tests: clusters (voxels over the point cap),
    ground returns, out-of-range and NaN-padded rows."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([0, -4, -2, 0, 0], [8, 4, 2, 1, .45], (b, n, 5))
    k = n // 3
    pts[:, :k, :3] = rng.uniform([1, -3, -1], [7, 3, 1], (b, 1, 3)) + \
        rng.normal(0, .1, (b, k, 3))
    pts[:, k:k + 50, 0] = 9.0                        # out of range
    pts[:, -20:] = np.nan
    return pts.astype(np.float32)


@pytest.mark.parametrize("max_voxels,cm", [(5000, 5), (600, 4)])
def test_voxel_mean_matches_jax(max_voxels, cm):
    """The fused voxelize + mean: coords, counts and mask exact, means
    1e-6 relative; (600, 4) cuts voxels at the cap and reads 4 of 5
    channels."""
    pts = make_points(0)
    vsize, rng_ = (0.25, 0.25, 0.5), (0., -4., -2., 8., 4., 2.)
    ref = jax_voxel_mean(jnp.asarray(pts), vsize, rng_, 10, max_voxels, cm)
    got = voxel_mean_batch(torch.from_numpy(pts), vsize, rng_, 10,
                           max_voxels, cm)
    feats, coords, num, mask = (np.asarray(r) for r in ref)
    assert got[0].shape == feats.shape
    np.testing.assert_array_equal(got[1].numpy(), coords)
    np.testing.assert_array_equal(got[2].numpy(), num)
    np.testing.assert_array_equal(got[3].numpy(), mask)
    np.testing.assert_allclose(got[0].numpy(), feats, rtol=1e-6, atol=1e-6)
    assert (num <= 10).all()
    if max_voxels == 600:
        assert mask.all()                            # the voxel cap fired
    else:
        assert (num[mask] == 10).any()               # the point cap fired
    assert (coords[~mask] == -1).all() and not got[0].numpy()[~mask].any()


@pytest.mark.parametrize("n,max_len", [(700, 10), (1500, 33)])
def test_segmented_scans_match_jax(n, max_len):
    rng = np.random.default_rng(n)
    keys = np.sort(rng.integers(0, n // 8, (2, n)), axis=1).astype(np.int32)
    vals = rng.normal(size=(2, n, 3)).astype(np.float32)
    ref = jax.vmap(functools.partial(jseg.seg_prefix_sum_bounded,
                                     max_len=max_len))(jnp.asarray(vals),
                                                       jnp.asarray(keys))
    got = segmented.seg_prefix_sum_bounded(torch.from_numpy(vals),
                                           torch.from_numpy(keys), max_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    heads = (rng.uniform(size=(2, n)) < .3).astype(np.int32)
    ref = jax.vmap(jseg.blocked_cumsum)(jnp.asarray(heads))
    got = segmented.blocked_cumsum(torch.from_numpy(heads))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("split,c,case", [
    pytest.param(False, 9, "random", id="False"),
    pytest.param(True, 9, "random", id="True"),
    pytest.param(False, 9, "long_run", id="long-run"),
    pytest.param(True, 3, "random", id="c3-split"),
    pytest.param(True, 65, "random", id="c65-split"),
])
def test_dense_plain_matches_pallas_interpret(split, c, case):
    """K7's plain version (the row-major sum) against the dense TPU kernel
    on a dense tiny scan: 3,000 rows over 256 cells, duplicates, a sentinel
    tail and keys past the table; 'long_run' puts rows 200 .. 2,699 of each
    scan in one cell; c = 3 and 65 with the split form."""
    rng = np.random.default_rng(8 if case == "random" and c == 9 else c + 1)
    b, n, cells = 2, 3000, 256
    keys = np.sort(rng.integers(0, cells + 20, (b, n)), axis=1)
    if case == "long_run":
        keys[:, 200:2700] = keys[:, 200:201]
    keys[:, -100:] = 2**31 - 1
    keys = np.sort(keys, axis=1).astype(np.int32)
    rows = rng.normal(0, 1, (b, n, c)).astype(np.float32)
    assert sorted_scatter.is_dense_scan(n, cells)
    ref = _sorted_segment_sum_bs(jnp.asarray(keys), jnp.asarray(rows), cells,
                                 interpret=True, split_last=split)
    kt, rt = torch.from_numpy(keys), torch.from_numpy(rows)
    if split:
        got = sorted_scatter.sorted_segment_sum_split(kt, rt, cells)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                       atol=1e-5)
    else:
        got = sorted_scatter.sorted_segment_sum(kt, rt, cells)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("n,cells,kernel", [
    (20000, 2 * 180 * 180, "sorted_segment_sum_dense"),   # voxel _dense_bev
    (20000, 496 * 432, "sorted_segment_sum"),             # KITTI pillars
    (250000, 512 * 512, "sorted_segment_sum_dense"),      # nuScenes pillars
    (400, 2 * 32 * 32, "sorted_segment_sum"),             # a test-size BEV
])
def test_density_dispatch(n, cells, kernel):
    """The JAX package's rule at full width: the dense BEV of
    CenterPoint-voxels nuScenes (20,000 rows over 64,800 cells in 75 blocks
    of 864, 267 rows a block > 256) goes to K7; sparse scans keep K2."""
    assert sorted_scatter.kernel_for(n, cells) == kernel
    if cells == 64800:
        assert sorted_scatter.pick_cells_per_block(cells) == 864
