"""Port parity of the PointNet++ primitives and modules: the plain PyTorch
versions of the ball query and farthest-point sampling (which the CUDA
kernels are held against on the card) against the JAX package's XLA forms
and its Pallas kernels in interpret mode, index for index; `nms_bev`; and
PointMLP / SAModuleMSG / VoteLayer with the JAX weights carried across.
Identical numpy inputs from a seed go through both.

Tolerances: indices and counts equal; features within 1e-4 of the tensor's
largest value (f32 matmuls and BatchNorm in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from paddle3d_tpu.models.common.pointnet2_modules import \
    PointMLP as JaxPointMLP
from paddle3d_tpu.models.common.pointnet2_modules import \
    SAModuleMSG as JaxSAModuleMSG
from paddle3d_tpu.models.common.pointnet2_modules import \
    VoteLayer as JaxVoteLayer
from paddle3d_tpu.ops import pointnet2 as jax_pn2
from paddle3d_tpu.ops.iou3d_nms import nms_bev as jax_nms_bev
from paddle3d_tpu.ops.pallas.ball_query import \
    ball_query_batched as jax_ball_query_batched
from paddle3d_tpu.ops.pallas.fps import \
    farthest_point_sample_batched as jax_fps_batched
from paddle3d_tpu_torch.models.common import PointMLP, SAModuleMSG, VoteLayer
from paddle3d_tpu_torch.ops import _build, pointnet2
from paddle3d_tpu_torch.ops.ball_query import ball_query_batched
from paddle3d_tpu_torch.ops.fps import farthest_point_sample_batched
from paddle3d_tpu_torch.ops.iou3d_nms import nms_bev
from paddle3d_tpu_torch.utils.convert import load_jax_params


def flat_state(module):
    """nnx parameters and running stats as {dotted path: numpy array}."""
    return {".".join(map(str, k)): np.asarray(getattr(v, "value", v))
            for kind in (nnx.Param, nnx.BatchStat)
            for k, v in nnx.state(module, kind).flat_state()}


def randomise_bn(module, seed):
    rng = np.random.default_rng(seed)
    for _, m in module.iter_modules():
        if isinstance(m, nnx.BatchNorm):
            c = m.mean.value.shape
            m.mean.value = jnp.asarray(rng.normal(0, .2, c), jnp.float32)
            m.var.value = jnp.asarray(rng.uniform(.5, 2., c), jnp.float32)
            m.scale.value = jnp.asarray(rng.uniform(.5, 1.5, c), jnp.float32)
            m.bias.value = jnp.asarray(rng.normal(0, .2, c), jnp.float32)
    module.eval()


def clustered(rng, b, n, valid, spread=1.5, box=20.):
    """[b, n, 3] points around 8 centres a scan, the first valid[i] of scan
    i valid."""
    pts = np.zeros((b, n, 3), np.float32)
    for i in range(b):
        centers = rng.uniform(-box, box, size=(8, 3)).astype(np.float32)
        pts[i] = centers[rng.integers(0, 8, size=n)] + \
            rng.normal(0, spread, size=(n, 3))
    mask = np.arange(n)[None, :] < np.asarray(valid)[:, None]
    return pts, mask


def _close(got, ref, tol=1e-4):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (err, tol)


# ------------------------------------------------------------- ball query
@pytest.mark.parametrize("m,n,nsample,radius", [
    (200, 700, 16, 1.2),       # neither a multiple of the TPU tiles
    (64, 2048, 32, 0.8),
    (513, 1000, 8, 2.5),       # far more hits than nsample
    (37, 130, 4, 1.5),
], ids=["ragged", "tiles", "crowded", "tiny"])
def test_ball_query_matches_jax(m, n, nsample, radius):
    """The plain version against the vmapped XLA form and the Pallas kernel
    in interpret mode: masked supports (one scan a third valid), empty
    balls (queries from other clusters), full balls."""
    rng = np.random.default_rng(0)
    xyz, mask = clustered(rng, 3, n, [n, n - 57, max(n // 3, 1)],
                          spread=0.7)
    # queries beside support points (the first of them on one, d2 = 0),
    # some beside masked ones, some far away
    pick = rng.integers(0, n, (3, m))
    q = np.take_along_axis(xyz, pick[..., None], 1) + \
        rng.normal(0, 0.3, (3, m, 3)).astype(np.float32)
    q[:, :8] = xyz[:, :8]
    q[:, 8:12] = 500.
    idx, cnt = ball_query_batched(radius, nsample, torch.from_numpy(xyz),
                                  torch.from_numpy(q), torch.from_numpy(mask))
    assert idx.dtype == torch.int32 and cnt.dtype == torch.int32
    assert idx.shape == (3, m, nsample) and cnt.shape == (3, m)
    args = (jnp.asarray(xyz), jnp.asarray(q), jnp.asarray(mask))
    for kw in (dict(force_xla=True), dict(interpret=True)):
        ref_idx, ref_cnt = jax_ball_query_batched(radius, nsample, *args,
                                                  **kw)
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref_cnt))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    c = cnt.numpy()
    assert (c == 0).any() and (c == nsample).any() and \
        ((c > 0) & (c < nsample)).any()


def test_ball_query_surface_and_chunks(monkeypatch):
    """A point exactly on the ball's surface counts (d2 <= r2), a masked
    point inside the ball does not, an empty ball gives idx 0 and count 0.
    r2 is radius * radius as a double, rounded once to f32, as the Pallas
    kernel has it (the XLA form traces the radius and squares it in f32:
    at radius 0.8 a point 0.8 away is inside for it and outside here).
    Queries in chunks give the same as in one pass."""
    xyz = np.zeros((1, 6, 3), np.float32)
    xyz[0, :, 0] = [0.5, 0.50000006, 0.3, 0.1, -0.5, 0.2]
    mask = np.array([[True, True, True, False, True, True]])
    q = np.zeros((1, 2, 3), np.float32)
    q[0, 1] = 100.
    t = torch.from_numpy
    idx, cnt = ball_query_batched(0.5, 5, t(xyz), t(q), t(mask))
    args = (jnp.asarray(xyz), jnp.asarray(q), jnp.asarray(mask))
    for kw in (dict(force_xla=True), dict(interpret=True)):
        ref_idx, ref_cnt = jax_ball_query_batched(0.5, 5, *args, **kw)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref_cnt))
    assert cnt.tolist() == [[4, 0]]
    assert idx.tolist() == [[[0, 2, 4, 5, 0], [0] * 5]]
    xyz[0, :, 0] = [0.8, 0.79999995, 0.3, 0.1, -0.8, 0.2]
    idx, cnt = ball_query_batched(0.8, 5, t(xyz), t(q), t(mask))
    ref_idx, ref_cnt = jax_ball_query_batched(
        0.8, 5, jnp.asarray(xyz), *args[1:], interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref_cnt))
    assert np.float32(0.8) * np.float32(0.8) > np.float32(0.8 * 0.8)
    assert idx[0, 0].tolist() == [1, 2, 5, 1, 1]
    rng = np.random.default_rng(5)
    pts, pmask = clustered(rng, 2, 300, [300, 200])
    args = (1.5, 8, t(pts), t(pts[:, :90]), t(pmask))
    whole = pointnet2.ball_query(*args)
    monkeypatch.setattr(pointnet2, "_CHUNK_ELEMS", 2 * 300 * 7)
    parts = pointnet2.ball_query(*args)
    for a, b in zip(whole, parts):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _surface_lattice(radius):
    """Supports in chunks of 32 around a query at the origin: chunks whose
    box touches the ball exactly at the rounded r2 (a lattice point on the
    surface at the chunk's first or last lane, the other 31 outside with
    that point the box's nearest), each followed by a chunk just beyond the
    ball, then a chunk inside the ball with every point masked. -> (xyz
    [1, N, 3], mask [1, N], queries [1, 3, 3], touching chunk ids, beyond
    chunk ids)."""
    g = torch.arange(-8, 9, dtype=torch.float32) * 0.25
    lat = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(
        -1, 3)
    r2 = torch.tensor(radius * radius, dtype=torch.float32)
    d2 = (lat[:, 0] * lat[:, 0] + lat[:, 1] * lat[:, 1]) + \
        lat[:, 2] * lat[:, 2]
    order = torch.argsort(d2, stable=True)
    lat, d2 = lat[order], d2[order]
    surf, out = lat[d2 == r2], lat[d2 > r2]
    far = lat[lat[:, 0] > radius]
    chunks = []
    for i, s in enumerate(surf[:12]):
        dom = (((out * s) > 0) | (s == 0)) & (out.abs() >= s.abs())
        rest = out[dom.all(dim=1)][:31]
        chunks += [torch.cat([s[None], rest] if i % 2 == 0 else
                             [rest, s[None]]), far[32 * i:32 * i + 32]]
    chunks.append(lat[d2 < r2][:32])
    xyz = torch.cat(chunks)[None]
    mask = torch.ones(xyz.shape[:2], dtype=torch.bool)
    mask[0, -32:] = False
    q = torch.zeros((1, 3, 3))
    q[0, 1] = 0.125
    q[0, 2, 0] = 0.3
    n_pairs = (len(chunks) - 1) // 2
    return xyz, mask, q, 2 * np.arange(n_pairs), 2 * np.arange(n_pairs) + 1


@pytest.mark.parametrize("kind,radius", [
    ("shuffled", 0.8), ("key", 0.8), ("key", 1.6), ("lattice", 0.75),
    ("lattice", 1.25), ("lattice", 1.0606601717798212)])
def test_ball_query_cull_skips_no_hit(kind, radius):
    """The CUDA ball query's two culls, in their plain form
    (`ball_query.cull_plain`): no point of a chunk skipped by its box, and
    no point left unmarked by the box of a block's queries, passes the
    plain ball test of a query concerned; chunks whose box touches the ball
    at the rounded r2 are visited, chunks beyond it and a masked chunk
    skipped. The walk over what the culls leave gives the indices and
    counts of the JAX package's Pallas kernel in interpret mode (its r2 is
    rounded as the port's; the XLA form squares the radius in f32)."""
    from paddle3d_tpu_torch.ops import ball_query
    nsample, g, size = 16, ball_query.BLOCK_QUERIES, ball_query.CHUNK
    if kind == "lattice":
        xyz, mask, q, touching, beyond = _surface_lattice(radius)
    else:
        rng = np.random.default_rng(3)
        pts, pmask = clustered(rng, 2, 2000, [2000, 1500], spread=1.0,
                               box=6.)
        xyz, mask = torch.from_numpy(pts), torch.from_numpy(pmask)
        if kind == "key":   # voxel-key order (z, y, x cells of 0.2 m)
            c = torch.floor(xyz / 0.2).to(torch.int64)
            c = c - c.amin(dim=1, keepdim=True)
            order = torch.argsort((c[..., 2] * 4096 + c[..., 1]) * 4096 +
                                  c[..., 0], dim=1, stable=True)
            xyz = torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3))
            mask = torch.gather(mask, 1, order)
        q = xyz[:, ::7][:, :250] + torch.from_numpy(
            rng.normal(0, 0.2, (2, 250, 3)).astype(np.float32))
    b, n, _ = xyz.shape
    m = q.shape[1]
    visit, keep = ball_query.cull_plain(radius, xyz, q, mask)
    n_chunks = -(-n // size)
    assert visit.shape == (b, m, n_chunks) and keep.shape == (b, -(-m // g),
                                                              n)
    d = q[:, :, None, :] - xyz[:, None, :, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + \
        d[..., 2] * d[..., 2]
    inb = (d2 <= torch.tensor(radius * radius, dtype=torch.float32)) & \
        mask[:, None, :]
    chunk_of = torch.arange(n) // size
    assert not (inb & ~visit[:, :, chunk_of]).any()
    marked = keep.repeat_interleave(g, dim=1)[:, :m]
    assert not (inb & ~marked).any()
    assert (~visit).any() and (~keep & mask[:, None, :]).any()
    if kind == "lattice":
        assert visit[0, 0, touching].all() and not visit[0, 0, beyond].any()
        assert not visit[:, :, -1].any()
        assert int(inb[0, 0].sum()) == len(touching)
    # the walk over what the culls leave, against the JAX reference
    left = inb & visit[:, :, chunk_of] & marked
    rank = torch.cumsum(left, dim=2) - 1
    cnt = left.sum(dim=2).clamp(max=nsample)
    first = torch.where(left & (rank < nsample), torch.arange(n), n)
    idx = torch.sort(first, dim=2).values[..., :nsample]
    idx = torch.where(idx < n, idx, torch.where(
        cnt[..., None] > 0, idx[..., :1], 0))
    ref_idx, ref_cnt = jax_ball_query_batched(
        radius, nsample, jnp.asarray(xyz.numpy()), jnp.asarray(q.numpy()),
        jnp.asarray(mask.numpy()), interpret=True)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref_cnt))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))


# -------------------------------------------------------------------- FPS
@pytest.mark.parametrize("n,npoint,valid", [
    (1200, 128, (1200, 777)),
    (1100, 256, (1100, 100)),    # fewer valid points than npoint: repeats
], ids=["masked", "short_scan"])
def test_fps_matches_jax(n, npoint, valid):
    """The plain version against the XLA fori_loop form and the Pallas
    kernel in interpret mode."""
    rng = np.random.default_rng(3)
    pts, mask = clustered(rng, 2, n, valid, spread=2.0, box=30.)
    idx = farthest_point_sample_batched(torch.from_numpy(pts),
                                        torch.from_numpy(mask), npoint)
    assert idx.dtype == torch.int32 and idx.shape == (2, npoint)
    args = (jnp.asarray(pts), jnp.asarray(mask), npoint)
    for kw in (dict(force_xla=True), dict(interpret=True)):
        np.testing.assert_array_equal(
            idx.numpy(), np.asarray(jax_fps_batched(*args, **kw)))
    got = idx.numpy()
    assert (got < np.asarray(valid)[:, None]).all()
    if valid[1] < npoint:
        # all valid points picked once, then the first valid point again
        assert len(set(got[1, :valid[1]])) == valid[1]
        assert (got[1, valid[1]:] == got[1, 0]).all()


def test_fps_ties_and_no_valid_point():
    """Duplicate points tie at equal distance and the lowest index wins; a
    late first valid point starts the scan; a scan with no valid point
    gives index 0 throughout, as the XLA form (jnp.argmax of an all-False
    mask) does."""
    rng = np.random.default_rng(7)
    base = rng.integers(-3, 4, size=(40, 3)).astype(np.float32)
    pts = np.stack([np.concatenate([base, base, base]),     # duplicates
                    rng.normal(0, 1, (120, 3)).astype(np.float32),
                    rng.normal(0, 1, (120, 3)).astype(np.float32)])
    mask = np.ones((3, 120), bool)
    mask[0, :5] = False
    mask[1] = False
    mask[2, :77] = False
    idx = farthest_point_sample_batched(torch.from_numpy(pts),
                                        torch.from_numpy(mask), 60)
    ref = jax_fps_batched(jnp.asarray(pts), jnp.asarray(mask), 60,
                          force_xla=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref))
    assert idx[0, 0] == 5 and idx[2, 0] == 77
    assert (idx[1] == 0).all()
    assert (idx[0] < 45).all()         # a duplicate's first copy wins


def test_gather_group_knn_match_jax():
    """gather_operation, grouping_operation, knn_query / three_nn and
    three_interpolate against the vmapped JAX functions."""
    rng = np.random.default_rng(11)
    pts, mask = clustered(rng, 2, 200, [200, 150])
    feats = rng.normal(size=(2, 200, 5)).astype(np.float32)
    idx = rng.integers(0, 200, (2, 30)).astype(np.int32)
    gidx = rng.integers(0, 200, (2, 30, 4)).astype(np.int32)
    t = torch.from_numpy
    np.testing.assert_array_equal(
        pointnet2.gather_operation(t(feats), t(idx)).numpy(),
        np.asarray(jax.vmap(jax_pn2.gather_operation)(feats, idx)))
    np.testing.assert_array_equal(
        pointnet2.grouping_operation(t(feats), t(gidx)).numpy(),
        np.asarray(jax.vmap(jax_pn2.grouping_operation)(feats, gidx)))
    q = pts[:, :30] + 0.01
    d2, nn_idx = pointnet2.three_nn(t(q), t(pts), t(mask))
    ref_d2, ref_idx = jax.vmap(jax_pn2.three_nn)(q, pts, mask)
    np.testing.assert_array_equal(nn_idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(ref_d2), rtol=1e-5,
                               atol=1e-6)
    w = pointnet2.interpolation_weights(d2)
    np.testing.assert_allclose(
        pointnet2.three_interpolate(t(feats), nn_idx, w).numpy(),
        np.asarray(jax.vmap(jax_pn2.three_interpolate)(
            feats, ref_idx, jax_pn2.interpolation_weights(ref_d2))),
        rtol=1e-5, atol=1e-5)


def test_first_argmax_and_topk_keep_index_order():
    x = torch.tensor([[1., 3., 3., 2.], [5., 5., 5., 5.],
                      [0., float("nan"), 7., float("nan")]])
    assert pointnet2.first_argmax(x).tolist() == [1, 0, 1]
    np.testing.assert_array_equal(
        pointnet2.first_argmax(x).numpy(),
        np.asarray(jnp.argmax(jnp.asarray(x.numpy()), axis=-1)))
    vals, idx = pointnet2.topk_stable(x[:2], 3)
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(x[:2].numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))


# -------------------------------------------------------------------- NMS
@pytest.mark.parametrize("n,pre,post", [(700, 640, 48), (200, 1024, 32)],
                         ids=["blocked", "one_shot"])
def test_nms_bev_matches_jax(n, pre, post):
    """nms_bev on identical boxes and scores: non-finite scores and scores
    under the threshold are dropped, score ties keep index order, both
    suppress branches; kept indices and count exact."""
    rng = np.random.default_rng(n)
    centers = rng.uniform(0, 40, (12, 2))
    boxes = np.zeros((2, n, 5), np.float32)
    boxes[..., :2] = centers[rng.integers(0, 12, (2, n))] + \
        rng.normal(0, 0.8, (2, n, 2))
    boxes[..., 2:4] = rng.uniform([1.4, 3.2], [2.0, 4.4], (2, n, 2))
    boxes[..., 4] = rng.uniform(-np.pi, np.pi, (2, n))
    scores = rng.uniform(0, 1, (2, n)).astype(np.float32)
    scores[:, ::9] = 0.5                           # ties
    scores[:, 5::31] = -np.inf
    scores[:, 7::37] = np.nan
    keep, count = nms_bev(torch.from_numpy(boxes), torch.from_numpy(scores),
                          0.3, pre_max_size=pre, post_max_size=post,
                          score_threshold=0.1)
    assert keep.shape == (2, post) and keep.dtype == torch.int32
    for i in range(2):
        ref_keep, ref_count = jax_nms_bev(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.3,
            pre_max_size=pre, post_max_size=post, score_threshold=0.1)
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(ref_keep))
        assert int(count[i]) == int(ref_count) > 0
    kept = keep[keep >= 0].long()
    assert (torch.from_numpy(scores).reshape(-1)[
        kept + (keep >= 0).nonzero()[:, 0] * n] > 0.1).all()


# ---------------------------------------------------------------- modules
def test_point_mlp_matches_jax():
    """PointMLP (LinearBN1DReLU's forward over any leading dims), eval BN
    with randomised statistics."""
    jmlp = JaxPointMLP([7, 16, 32], rngs=nnx.Rngs(0))
    randomise_bn(jmlp, 1)
    mlp = PointMLP([7, 16, 32])
    load_jax_params(mlp, flat_state(jmlp))
    x = np.random.default_rng(2).normal(size=(2, 9, 5, 7)).astype(np.float32)
    with torch.no_grad():
        got = mlp.eval()(torch.from_numpy(x))
    assert got.shape == (2, 9, 5, 32)
    _close(got.numpy(), jmlp(jnp.asarray(x)))
    with torch.no_grad():                          # two leading dims too
        _close(mlp(torch.from_numpy(x[:, 0])).numpy(),
               jmlp(jnp.asarray(x[:, 0])))


def sa_inputs(seed, b=2, n=400, c=6):
    rng = np.random.default_rng(seed)
    pts, mask = clustered(rng, b, n, [n, 40], spread=1.0, box=6.)
    feats = rng.normal(size=(b, n, c)).astype(np.float32)
    feats[~mask] = 0.
    pts[~mask] = 0.
    return pts, feats, mask


@pytest.mark.parametrize("sample_type,with_scores", [
    ("d-fps", False), ("ctr_aware", True), ("ctr_aware", False)],
    ids=["fps", "ctr_aware", "ctr_aware_without_scores"])
def test_sa_module_matches_jax(sample_type, with_scores):
    """SAModuleMSG, two scales, aggregation and confidence heads: sampled
    points equal, features and confidences close; the second scan has
    fewer valid points than the layer samples. A ctr_aware layer with no
    incoming scores samples by farthest point; with scores, by confidence
    top-k with ties in index order."""
    kw = dict(npoint=48, radii=(1.0, 2.5), nsamples=(8, 12),
              mlps=[[8, 16], [8, 24]], in_channels=6,
              sample_type=sample_type, aggregation_mlp=[32],
              confidence_mlp=[16], num_classes=3)
    jmod = JaxSAModuleMSG(rngs=nnx.Rngs(4), **kw)
    randomise_bn(jmod, 5)
    mod = SAModuleMSG(**kw)
    load_jax_params(mod, flat_state(jmod))
    pts, feats, mask = sa_inputs(6)
    scores = None
    if with_scores:
        scores = np.random.default_rng(8).normal(
            size=(2, 400, 3)).astype(np.float32).round(1)      # ties
    ref = jmod(jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(mask),
               None if scores is None else jnp.asarray(scores))
    with torch.no_grad():
        got = mod.eval()(torch.from_numpy(pts), torch.from_numpy(feats),
                         torch.from_numpy(mask),
                         None if scores is None else torch.from_numpy(scores))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert got[1].shape == (2, 48, 32) and got[3].shape == (2, 48, 3)
    _close(got[1].numpy(), ref[1])
    _close(got[3].numpy(), ref[3])
    if with_scores:      # 40 valid points of 48 picks: masked picks, zeroed
        assert np.asarray(ref[2])[1].sum() == 40
        assert not got[1].numpy()[1][~np.asarray(ref[2])[1]].any()
    assert np.abs(np.asarray(ref[1])).max() > 0


def test_vote_layer_matches_jax():
    jmod = JaxVoteLayer([16], 12, (3.0, 3.0, 2.0), rngs=nnx.Rngs(2))
    randomise_bn(jmod, 3)
    jmod.ctr_reg.kernel.value = jmod.ctr_reg.kernel.value * 20.   # clamps
    mod = VoteLayer([16], 12, (3.0, 3.0, 2.0))
    load_jax_params(mod, flat_state(jmod))
    rng = np.random.default_rng(4)
    xyz = rng.normal(size=(2, 30, 3)).astype(np.float32)
    feats = rng.normal(size=(2, 30, 12)).astype(np.float32)
    mask = np.ones((2, 30), bool)
    ref = jmod(jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(mask))
    with torch.no_grad():
        got = mod.eval()(torch.from_numpy(xyz), torch.from_numpy(feats),
                         torch.from_numpy(mask))
    for g, r in zip(got, ref):
        _close(g.numpy(), r)
    assert (np.abs(np.asarray(ref[2])) == np.array([3., 3., 2.])).any()
    assert "max_range" not in mod.state_dict()


def test_cpu_tensors_take_no_kernel(monkeypatch):
    """On a CPU tensor both wrappers take their plain versions: the kernel
    library is never asked for and no launch is counted."""
    def no_build():
        raise AssertionError("kernel library requested for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_build)
    before = dict(_build.LAUNCHES)
    assert {"ball_query", "farthest_point_sample"} <= set(before)
    pts, mask = clustered(np.random.default_rng(0), 1, 64, [50])
    t = torch.from_numpy
    ball_query_batched(1.0, 4, t(pts), t(pts[:, :8]), t(mask))
    farthest_point_sample_batched(t(pts), t(mask), 8)
    assert _build.LAUNCHES == before
