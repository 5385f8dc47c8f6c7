"""Port parity of CADDN, the second camera model: the port's ResNet, HRNet,
OCRNet head, BaseBEVBackbone, frustum geometry, frustum-to-BEV pool and the
tiny config end to end (serving and one train step) on the CPU against the
JAX package, with inputs made from a seed by numpy.

The JAX models are built abstractly (nnx.eval_shape: no initialiser runs,
so no per-shape XLA compile) and filled from a seed by numpy (seeded_state:
kernels uniform ±1/sqrt(fan_in), BN scale, bias, mean and variance near
their defaults); utils/convert.load_jax_params carries that state across.

Tolerances and why:
  * _bin_depths, _depth_to_bin, the frustum's rank and valid: exact,
    against the JAX functions under jit, as the model runs them (the port
    computes in the arithmetic XLA compiles them to: its linspace, each
    coordinate the pairwise sum of four products that XLA's dot computes,
    a division by a constant as a product with its reciprocal; a
    left-to-right sum moved 100 of 2.8 million full-width rows under the
    KITTI camera into the next cell, a true division 84);
  * feature maps (ResNet, HRNet, OCR features, BEV net): 1e-5 of the
    largest value; cuDNN-free CPU convolutions and XLA's sum in other
    orders (measured up to 1.2e-6);
  * the pools: 1e-5 of the largest value; JAX sorts unstably and adds by
    an XLA scatter, the port sorts stably and adds by index_add_: the
    rows of a cell are summed in another order;
  * test_forward: labels equal, scores 1e-5, boxes 1e-4 of the largest
    value (the decode on heads that differ by ~1e-6);
  * the train step in f64 on both sides (in f32 a relu input within
    rounding of 0 moves gradients by far more, in either framework):
    losses within 1e-8 of their value, gradients 1e-7 of each tensor's
    largest value (measured 4.7e-8). Two steps of either side stay in f32:
    the port's target generator splats its gaussian heatmaps in f32 (the
    JAX one in f64 under x64), which moves the heatmap loss's gradients
    (the hm tower, the BEV net, the image branch) by ~1e-8; the reg, dim,
    height and rot towers agree to 1e-13. The pool's depth weights travel
    as f32 on both sides (the JAX package sorts them as f32).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import nnx

import chip_smoke
from paddle3d_tpu.apis.config import Config as JaxConfig
from paddle3d_tpu.models.backbones import hrnet as jax_hrnet
from paddle3d_tpu.ops import scatter as jax_scatter
from paddle3d_tpu_torch.apis import Config
from paddle3d_tpu_torch.models.backbones import hrnet
from paddle3d_tpu_torch.models.detection import CADDN
from paddle3d_tpu_torch.ops import scatter, sorted_scatter
from paddle3d_tpu_torch.utils.convert import load_jax_params, to_torch_names

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "caddn")
TINY = os.path.join(CFG, "caddn_synthetic_tiny.yml")
OCR_HRNET = os.path.join(CFG, "caddn_ocrnet_hrnetw18_kitti.yml")
RESNET101 = os.path.join(CFG, "caddn_resnet101_kitti.yml")
SMOKE_HRNET = os.path.join(REPO, "configs", "smoke",
                           "smoke_hrnet18_no_dcn_kitti.yml")
H, W = 64, 96                   # the tiny config's image_size
FH, FW = H // 16, W // 16       # its feature map (ResNet-18, stride 16)


def seeded_state(abstract, seed):
    """Fill an nnx.eval_shape'd module from numpy: -> (module, {dotted
    path: array})."""
    rng = np.random.default_rng(seed)
    graphdef, state = nnx.split(abstract)

    def fill(path, v):
        # the leaf's name: the last dict key of the path (.value follows)
        leaf = [k.key for k in path if hasattr(k, "key")][-1]
        shape = v.shape
        u = rng.random(shape, dtype=np.float32)
        if leaf == "kernel":
            bound = 1 / np.sqrt(np.prod(shape[:-1]))
            a = (2 * u - 1) * bound
        elif leaf in ("scale", "var"):
            a = u + 0.5
        else:                                   # bias, mean
            a = (u - 0.5) / 5
        return jnp.asarray(a.astype(v.dtype))

    state = jax.tree_util.tree_map_with_path(fill, state)
    module = nnx.merge(graphdef, state)
    return module, flat_state(module)


def flat_state(module):
    return {".".join(map(str, k)): np.asarray(v[...])
            for kind in (nnx.Param, nnx.BatchStat)
            for k, v in nnx.state(module, kind).flat_state()}


def jax_model(path, seed=0):
    return seeded_state(nnx.eval_shape(lambda: JaxConfig(path=path).model),
                        seed)


def close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (err, tol)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def serve_batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return {"data": rng.uniform(0, 255, (b, H, W, 3)).astype(np.float32),
            "img2lidars": np.stack([
                chip_smoke.caddn_camera(H, W, chip_smoke.CADDN_TINY_FOCAL,
                                        yaw=0.1 * i) for i in range(b)])}


def train_batch(seed=1):
    batch = serve_batch(seed)
    rng = np.random.default_rng(seed + 10)
    boxes = np.zeros((2, 3, 7), np.float32)
    boxes[..., :2] = rng.uniform([3, -5], [14, 5], (2, 3, 2))
    boxes[..., 2] = -1.6
    boxes[..., 3:6] = [3.9, 1.6, 1.5]
    boxes[..., 6] = rng.uniform(-3, 3, (2, 3))
    boxes[1, 0, 6] = 4.0                        # wraps through limit_period
    labels = np.zeros((2, 3), np.int64)
    labels[1, 2] = -1
    depth = rng.uniform(1.0, 17.0, (2, FH, FW)).astype(np.float32)
    depth[0, 0, :2] = [0.5, 18.0]               # outside: the last bin
    batch.update(gt_boxes=boxes, gt_labels=labels, depth_map=depth)
    return batch


def to_torch(batch, dtype=torch.float32):
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.to(dtype) if t.is_floating_point() else t
    return out


def to_jax(batch, dtype=jnp.float32):
    return {k: jnp.asarray(v).astype(dtype) if v.dtype == np.float32
            else jnp.asarray(v.astype(np.int32)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def tiny():
    """The tiny config on both sides (ResNet-18 at base 8, 8 LID bins, a
    32 x 32 BEV of 16 channels, one CenterHead task), the seeded JAX state
    carried across; both in eval mode."""
    jm, state = jax_model(TINY)
    jm.eval()
    model = Config(path=TINY, device="cpu").model
    load_jax_params(model, state)
    return jm, state, model.eval()


@pytest.fixture(scope="module")
def full():
    """caddn_ocrnet_hrnetw18_kitti.yml on both sides at full width, the
    seeded JAX state carried across; both in eval mode."""
    jm, state = jax_model(OCR_HRNET, seed=1)
    jm.eval()
    model = Config(path=OCR_HRNET, device="cpu").model
    load_jax_params(model, state)
    return jm, state, model.eval()


# ---------------------------------------------------------------- layers
def test_fuse_layer_resizes_nearest_exact():
    """A three-stream FuseLayer at odd sizes (9 x 13, 5 x 7, 3 x 4):
    jax.image.resize's "nearest" is torch's "nearest-exact"; torch's
    "nearest" would pick other source cells."""
    jm, state = seeded_state(nnx.eval_shape(lambda: jax_hrnet.FuseLayer(
        [4, 8, 16], rngs=nnx.Rngs(0))), 2)
    jm.eval()
    pm = hrnet.FuseLayer([4, 8, 16], generator=torch.Generator())
    load_jax_params(pm, state)
    pm.eval()
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(2, hh, ww, c)).astype(np.float32)
          for hh, ww, c in ((9, 13, 4), (5, 7, 8), (3, 4, 16))]
    ref = nnx.jit(lambda m, v: m(v))(jm, [jnp.asarray(x) for x in xs])
    with torch.no_grad():
        got = pm([nchw(x) for x in xs])
        up = pm.projs[0][2](nchw(xs[2]))
    for g, r in zip(got, ref):
        close(nhwc(g), np.asarray(r), 1e-5)
    exact = F.interpolate(up, size=(9, 13), mode="nearest-exact")
    assert not torch.equal(F.interpolate(up, size=(9, 13), mode="nearest"),
                           exact)


def test_hrnet_w18_matches_jax_at_odd_sizes(full):
    """HRNet-W18 at 72 x 104: its streams are 18 x 26, 9 x 13, 5 x 7 and
    3 x 4, so both the fuse layers' nearest resizes and the bilinear
    concat resample by ratios that are not whole."""
    jm, _, model = full
    img = np.random.default_rng(4).uniform(0, 1, (2, 72, 104, 3)).astype(
        np.float32)
    ref = nnx.jit(lambda m, x: m.backbone(x))(jm, jnp.asarray(img))
    with torch.no_grad():
        got = model.backbone(nchw(img))
    assert tuple(got.shape) == (2, 270, 18, 26)
    close(nhwc(got), np.asarray(ref), 1e-5)


def test_ocrnet_features_match_jax(full):
    """OCRNetHead.features (the aux head's 19 soft regions, the region
    gather, the object attention, the projection) on a 270-channel map."""
    jm, _, model = full
    x = np.random.default_rng(5).normal(size=(2, 18, 26, 270)).astype(
        np.float32)
    ref = nnx.jit(lambda m, v: m.class_head.features(v))(jm, jnp.asarray(x))
    with torch.no_grad():
        got = model.class_head.features(nchw(x))
    assert tuple(got.shape) == (2, 512, 18, 26)
    close(nhwc(got), np.asarray(ref), 1e-5)


def test_deeplabv3_head_matches_jax():
    """DeepLabV3Head (ASPP with dilated branches and the image-pool branch,
    then a 3 x 3 ConvBNReLU; logits and the pre-logit features) at small
    widths."""
    from paddle3d_tpu.models.heads import class_heads as jax_heads
    from paddle3d_tpu_torch.models.heads import DeepLabV3Head
    kw = dict(num_classes=3, backbone_channels=16, aspp_ratios=(1, 2, 3),
              aspp_out_channels=8)
    jm, state = seeded_state(nnx.eval_shape(lambda: jax_heads.DeepLabV3Head(
        rngs=nnx.Rngs(0), **kw)), 8)
    jm.eval()
    pm = DeepLabV3Head(**kw)
    load_jax_params(pm, state)
    x = np.random.default_rng(9).normal(size=(2, 9, 13, 16)).astype(
        np.float32)
    ref = nnx.jit(lambda m, v: (m.features([v]), m([v])))(jm, jnp.asarray(x))
    with torch.no_grad():
        got = (pm.eval().features([nchw(x)]), pm([nchw(x)]))
    for g, r in zip(got, ref):
        close(nhwc(g), np.asarray(r), 1e-5)


def test_base_bev_backbone_matches_jax(full):
    """The config's BaseBEVBackbone ([5, 5] blocks at strides [1, 2],
    deconvs to [256, 256]) on a 16 x 20 map of 64 channels."""
    jm, _, model = full
    x = np.random.default_rng(6).normal(size=(2, 16, 20, 64)).astype(
        np.float32)
    ref = nnx.jit(lambda m, v: m.bev_backbone(v))(jm, jnp.asarray(x))
    with torch.no_grad():
        got = model.bev_backbone(nchw(x))
    assert tuple(got.shape) == (2, 512, 16, 20)
    close(nhwc(got), np.asarray(ref), 1e-5)


def test_resnet18_base8_matches_jax(tiny):
    """The tiny config's ResNet-18 at base 8 (stage 2's output, stride
    16) on random images."""
    jm, _, model = tiny
    img = np.random.default_rng(7).uniform(0, 1, (2, H, W, 3)).astype(
        np.float32)
    ref = nnx.jit(lambda m, x: m.backbone(x))(jm, jnp.asarray(img))
    with torch.no_grad():
        got = model.backbone(nchw(img))
    assert len(got) == len(ref) == 1
    close(nhwc(got[0]), np.asarray(ref[0]), 1e-5)


# ------------------------------------------------------------------ pools
def pool_case(seed, b, n, npix, cells, c, share):
    """Rows of a frustum pool: ranks over `cells` (a share of them
    invalid, some ranks repeated many times), pixel ids and weights."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(b, npix, c)).astype(np.float32)
    pix = rng.integers(0, npix, (b, n)).astype(np.int32)
    dep = rng.uniform(0, 1, (b, n)).astype(np.float32)
    ranks = rng.integers(0, cells, (b, n)).astype(np.int32)
    ranks[:, ::7] = cells // 2                  # a long segment
    valid = rng.uniform(0, 1, (b, n)) < share
    return table, pix, dep, ranks, valid


@pytest.mark.parametrize("case,want", [
    ((8, 2, 192, 24, 1024, 16, 0.6), "sorted_segment_sum"),
    ((9, 2, 4000, 300, 512, 64, 0.7), "sorted_segment_sum_dense")],
    ids=["sparse_k2", "dense_k7"])
def test_bev_pool_sorted_matches_jax(case, want):
    """bev_pool_sorted against the JAX package's at a sparse shape (the
    tiny config's 192 rows onto 32 x 32 cells: K2 on the card) and a
    dense one (4,000 rows onto 512 cells: K7), values and gradients (the
    VJP: the table gather, K5 on the card)."""
    table, pix, dep, ranks, valid = pool_case(*case)
    cells = case[4]
    assert sorted_scatter.kernel_for(case[2], cells) == want
    ref, vjp = jax.vjp(lambda t, d: jax_scatter.bev_pool_sorted(
        t, jnp.asarray(pix), d, jnp.asarray(ranks), jnp.asarray(valid),
        cells), jnp.asarray(table), jnp.asarray(dep))
    cot = np.random.default_rng(case[0] + 1).normal(
        size=ref.shape).astype(np.float32)
    ref_t, ref_d = vjp(jnp.asarray(cot))
    t, d = torch.from_numpy(table).requires_grad_(), \
        torch.from_numpy(dep).requires_grad_()
    got = scatter.bev_pool_sorted(t, torch.from_numpy(pix), d,
                                  torch.from_numpy(ranks),
                                  torch.from_numpy(valid), cells)
    got.backward(torch.from_numpy(cot))
    close(got.detach().numpy(), np.asarray(ref), 1e-5)
    close(t.grad.numpy(), np.asarray(ref_t), 1e-5)
    close(d.grad.numpy(), np.asarray(ref_d), 1e-5)


def test_pool_routes_at_caddn_shapes():
    """The wrapper's route (the JAX package's density rule) at CADDN's
    pools: full width, 80 x 96 x 312 = 2,396,160 rows a frame onto
    376 x 280 cells, is dense (K7); the tiny config's 8 x 4 x 6 = 192
    rows onto 32 x 32 sparse (K2)."""
    assert sorted_scatter.kernel_for(80 * 96 * 312, 376 * 280) == \
        "sorted_segment_sum_dense"
    assert sorted_scatter.kernel_for(8 * FH * FW, 32 * 32) == \
        "sorted_segment_sum"


def test_bev_pool_and_pillar_scatter_match_jax():
    """The plain scatter-add bev_pool (invalid rows and a long segment)
    and pillar_scatter (valid voxels sorted by cell, then padding)."""
    table, pix, dep, ranks, valid = pool_case(10, 1, 3000, 1, 256, 8, 0.7)
    feats = np.random.default_rng(11).normal(size=(3000, 8)).astype(
        np.float32)
    ref = jax_scatter.bev_pool(jnp.asarray(feats), jnp.asarray(ranks[0]),
                               jnp.asarray(valid[0]), 256)
    got = scatter.bev_pool(torch.from_numpy(feats),
                           torch.from_numpy(ranks[0]),
                           torch.from_numpy(valid[0]), 256)
    close(got.numpy(), np.asarray(ref), 1e-5)

    rng = np.random.default_rng(12)
    b, v, ny, nx = 2, 50, 12, 10
    coords = np.zeros((b, v, 3), np.int32)
    mask = np.zeros((b, v), bool)
    for i, count in enumerate((40, 25)):
        cell = np.sort(rng.choice(ny * nx, count, replace=False))
        coords[i, :count, 1], coords[i, :count, 2] = cell // nx, cell % nx
        mask[i, :count] = True
    vf = rng.normal(size=(b, v, 5)).astype(np.float32)
    ref = jax_scatter.pillar_scatter(jnp.asarray(vf), jnp.asarray(coords),
                                     jnp.asarray(mask), ny, nx)
    got = scatter.pillar_scatter(torch.from_numpy(vf),
                                 torch.from_numpy(coords),
                                 torch.from_numpy(mask), ny, nx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------- frustum
@pytest.mark.parametrize("mode", ["LID", "UD"])
def test_bin_depths_and_depth_to_bin_match_jax(full, mode):
    """Bin centres bit for bit; depths to bins index for index, with
    depths outside the range (the last bin) and on the bin edges; against
    the JAX functions under jit, as the model runs them (eager and jitted
    JAX round 24 of the full-width config's 80 uniform bins differently)."""
    jm, _, model = full
    old = jm.depth_mode, model.depth_mode
    jm.depth_mode = model.depth_mode = mode
    try:
        ref = np.asarray(jax.jit(jm._bin_depths)())
        got = model._bin_depths().numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      ref.view(np.int32))
        x = np.concatenate([
            np.random.default_rng(13).uniform(1, 48, 200000),
            ref, [1.0, 2.0, 46.8, 47.0]]).astype(np.float32)
        np.testing.assert_array_equal(
            model._depth_to_bin(torch.from_numpy(x)).numpy(),
            np.asarray(jax.jit(jm._depth_to_bin)(jnp.asarray(x))))
    finally:
        jm.depth_mode, model.depth_mode = old


def jax_frustum(jm, img2lidars, h, w):
    """The jitted JAX _frustum_to_bev's (rank, valid) as its
    bev_pool_sorted call receives them, [B, D*h*w]."""
    def run(l2i):
        seen = {}

        def record(feat_tab, pix, depth_w, ranks, valid, num_cells):
            seen.update(ranks=ranks, valid=valid)
            return jnp.zeros((feat_tab.shape[0], num_cells,
                              feat_tab.shape[-1]))

        real = jax_scatter.bev_pool_sorted
        jax_scatter.bev_pool_sorted = record
        try:
            b, d = l2i.shape[0], jm.depth_bins
            jm._frustum_to_bev(jnp.zeros((b, h, w, 2)),
                               jnp.zeros((b, h, w, d)), l2i)
        finally:
            jax_scatter.bev_pool_sorted = real
        return seen["ranks"], seen["valid"]
    return tuple(map(np.asarray, jax.jit(run)(jnp.asarray(img2lidars))))


@pytest.mark.parametrize("which", ["tiny_camera", "kitti_camera"])
def test_frustum_rank_and_valid_index_equal(tiny, full, which):
    """rank and valid index for index against the JAX frustum: the tiny
    config's 8 x 4 x 6 frustum under the test cameras (their LID depths
    put x on voxel faces: 3.0 m is a face of the 0.5 m grid), and one
    frame of the full-width frustum (80 x 96 x 312) under chip_smoke's
    KITTI camera, more than half of whose rows land in the grid."""
    if which == "tiny_camera":
        jm, _, model = tiny
        img2lidars, h, w = serve_batch()["img2lidars"], FH, FW
    else:
        jm, _, model = full
        img2lidars = chip_smoke.caddn_camera(384, 1248)[None]
        h, w = 96, 312
    ref_rank, v = jax_frustum(jm, img2lidars, h, w)
    rank, valid = model.frustum_ranks(torch.from_numpy(img2lidars), h, w)
    b = img2lidars.shape[0]
    np.testing.assert_array_equal(valid.reshape(b, -1).numpy(), v)
    np.testing.assert_array_equal(rank.reshape(b, -1).numpy()[v],
                                  ref_rank[v])
    assert 0.3 < v.mean() < 1.0
    if which == "kitti_camera":
        assert v.mean() > 0.5


def test_chip_smoke_caddn_batch_is_mostly_in_grid(full):
    """chip_smoke.py's CADDN serving batch (its KITTI camera) puts more
    than half of the full-width frustum's rows in the grid, on cells with
    up to thousands of rows: a dense pool for K7. tools/bench_camera.py's
    CADDN img2lidars (:84-93, its y row scaled by u·z) puts under 1 %
    there."""
    model = full[2]
    batch = chip_smoke.caddn_serve_batch("cpu", 1)
    assert tuple(batch["data"].shape) == (1, 384, 1248, 3)
    stats = chip_smoke.frustum_stats(model, batch["img2lidars"])
    assert stats["share"] > 0.5 and stats["longest"] > 1000
    h, w = 384, 1248
    bench = np.zeros((1, 4, 4), np.float32)
    bench[0, 0, 2] = 1.0
    bench[0, 1, 0], bench[0, 1, 3] = -0.05, 0.05 * w / 2
    bench[0, 2, 1], bench[0, 2, 3] = -0.05, 0.05 * h / 2 - 1.6
    bench[0, 3, 3] = 1.0
    assert chip_smoke.frustum_stats(model, torch.from_numpy(bench))[
        "share"] < 0.01


# ------------------------------------------------------------------ model
def test_tiny_test_forward_matches_jax(tiny):
    jm, _, model = tiny
    batch = serve_batch()
    ref = jax.device_get(nnx.jit(lambda m, b: m.test_forward(b))(
        jm, to_jax(batch)))
    got = model.test_forward(to_torch(batch))
    assert set(got) == set(ref)
    assert tuple(got["box3d_lidar"].shape) == (2, 8, 7)
    np.testing.assert_array_equal(got["label_preds"].numpy(),
                                  ref["label_preds"])
    close(got["scores"].numpy(), ref["scores"], 1e-5)
    close(got["box3d_lidar"].numpy(), ref["box3d_lidar"], 1e-4)
    assert (ref["scores"] > 0).all()
    assert len(np.unique(ref["scores"])) > 8     # no ties to reorder


def test_tiny_train_forward_matches_jax_in_f64(tiny):
    """train_forward (the frustum pool, the BEV net, the CenterPoint
    targets and losses, the depth-bin loss with depths outside the range)
    in train mode: losses and every gradient against the JAX step's, both
    in f64."""
    _, state, _ = tiny
    batch = train_batch()
    jm, _ = jax_model(TINY)
    jm.train()
    with jax.enable_x64():
        graphdef, st = nnx.split(jm)
        jm64 = nnx.merge(graphdef, jax.tree.map(
            lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32
            else x, st))

        @nnx.jit
        def grads_of(m, b):
            def loss_fn(m):
                losses = m.train_forward(b)
                return losses["loss"], losses
            return nnx.grad(loss_fn, has_aux=True)(m)

        grads, want = jax.device_get(grads_of(jm64, to_jax(batch,
                                                           jnp.float64)))
    model = Config(path=TINY, device="cpu").model
    load_jax_params(model, state)
    model.double().train()
    got = model.train_forward(to_torch(batch, torch.float64))
    got["loss"].backward()
    assert set(got) == set(want) == {"loss", "hm_loss_0", "loc_loss_0",
                                     "loss_depth"}
    for key in want:
        close(got[key].item(), want[key], 1e-8)
    ref = to_torch_names(model, {
        ".".join(map(str, k)): np.asarray(v[...])
        for k, v in nnx.state(grads, nnx.Param).flat_state()})
    assert set(ref) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        if p.grad is None:          # ResNet stage 3, whose output is unused
            assert name.startswith("backbone.stages.3."), name
            assert not ref[name].numpy().any(), name
        else:
            close(p.grad.numpy(), ref[name].numpy(), 1e-7)


# --------------------------------------------------------------- configs
@pytest.mark.parametrize("path", [OCR_HRNET, RESNET101, SMOKE_HRNET],
                         ids=["caddn_ocrnet_hrnetw18", "caddn_resnet101",
                              "smoke_hrnet18"])
def test_full_width_config_builds_with_jax_state(path, full):
    """The config at full width in the port: the JAX model's parameter
    count, and its whole state (parameters and running stats) carried
    across; CADDN's geometry and heads as the JAX model has them."""
    if path == OCR_HRNET:
        jm, state, model = full
    else:
        jm, state = jax_model(path, seed=2)
        model = Config(path=path, device="cpu").model
        load_jax_params(model, state)
    assert sum(p.numel() for p in model.parameters()) == sum(
        v[...].size for _, v in nnx.state(jm, nnx.Param).flat_state())
    # load_jax_params filled every parameter and running stat; two spot
    # checks of the values in torch's layout
    got = model.state_dict()
    first = next(k for k in state if k.endswith("kernel"))
    last_var = [k for k in state if k.endswith(".var")][-1]
    for name, ref in to_torch_names(model, {
            k: state[k] for k in (first, last_var)}).items():
        assert torch.equal(got[name], ref), name
    if isinstance(model, CADDN):
        assert model.grid_size == jm.grid_size == [280, 376, 25]
        assert model.depth_bins == 80 and not model.anchor_mode
        assert model.bbox_head.num_classes == [3]
        assert model.test_cfg == jm.test_cfg


def test_caddn_refuses_train_mode_serving(tiny):
    _, _, model = tiny
    model.train()
    try:
        with pytest.raises(RuntimeError, match="eval"):
            model.test_forward(to_torch(serve_batch()))
    finally:
        model.eval()


ANCHOR_HEAD = """_base_: {base}
model:
  bbox_head:
    _inherited_: false
    type: Anchor3DHead
    num_classes: 1
    feature_channels: 16
    point_cloud_range: [0.0, -8.0, -3.0, 16.0, 8.0, 1.0]
    voxel_size: [0.5, 0.5, 4.0]
    output_stride_factor: 1
    num_proposals: 8
    nms_pre: 64
    anchor_configs:
      - sizes: [1.6, 3.9, 1.56]
        anchor_strides: [0.5, 0.5, 0.0]
        anchor_offsets: [0.25, -7.75, -1.78]
        rotations: [0.0, 1.57]
        matched_threshold: 0.6
        unmatched_threshold: 0.45
"""


def test_anchor_mode_matches_jax(tmp_path):
    """The anchor mode (a head without tasks_cfg: the reference YAML's
    AnchorHeadSingle shim): the tiny config with an Anchor3DHead, the
    port's head serving it unchanged; test_forward's proposals (labels
    equal, scores 1e-5, boxes 1e-4) and train_forward's losses (1e-5) in
    f32."""
    path = tmp_path / "caddn_anchor.yml"
    path.write_text(ANCHOR_HEAD.format(base=TINY))
    jm, state = jax_model(str(path), seed=3)
    # the head keeps its anchors as plain arrays, which eval_shape left
    # abstract: made again from its numpy generator
    head, gen = jm.bbox_head, jm.bbox_head.anchor_generator
    head._anchors = jnp.asarray(gen.anchors)
    head._matched = jnp.asarray(gen.matched_thresholds)
    head._unmatched = jnp.asarray(gen.unmatched_thresholds)
    model = Config(path=str(path), device="cpu").model
    load_jax_params(model, state)
    assert jm.anchor_mode and model.anchor_mode
    jm.eval()
    batch = serve_batch(seed=4)
    ref = jax.device_get(nnx.jit(lambda m, b: m.test_forward(b))(
        jm, to_jax(batch)))
    got = model.eval().test_forward(to_torch(batch))
    np.testing.assert_array_equal(got["label_preds"].numpy(),
                                  ref["label_preds"])
    close(got["scores"].numpy(), ref["scores"], 1e-5)
    close(got["box3d_lidar"].numpy(), ref["box3d_lidar"], 1e-4)
    assert (ref["label_preds"] == 0).sum() > 2

    batch = train_batch(seed=5)
    jm.train()
    want = jax.device_get(nnx.jit(lambda m, b: m.train_forward(b))(
        jm, to_jax(batch)))
    with torch.no_grad():
        got = model.train().train_forward(to_torch(batch))
    assert set(got) == set(want) == {"loss", "loss_rpn_cls", "loss_rpn_reg",
                                     "loss_depth"}
    for key in want:
        close(got[key].item(), want[key], 1e-5)


REFERENCE_SURFACE = """model:
  type: CADDN
  backbone_3d: {type: ResNet, depth: 18, base_channels: 8, out_indices: [2]}
  bbox_head:
    type: CenterHead
    in_channels: 32
    share_conv_channel: 16
    code_weights: [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
    common_heads: {reg: [2, 2], height: [1, 2], dim: [3, 2], rot: [2, 2]}
    tasks: [{num_class: 1, class_names: [Car]}]
  f2v_cfg: {pc_range: [0.0, -8.0, -3.0, 16.0, 8.0, 1.0],
            voxel_size: [0.5, 0.5, 4.0]}
  disc_cfg: {mode: UD, num_bins: 6, depth_min: 1.0, depth_max: 13.0}
  ffe_cfg: {channel_reduce_cfg: {in_channels: 32, out_channels: 16},
            downsample_factor: 16, ddn_loss: {weight: 2.0}}
  bev_cfg: {input_channels: 16, num_filters: [16, 32], layer_nums: [1, 1],
            layer_strides: [1, 2], num_upsample_filters: [16, 16],
            upsample_strides: [1, 2]}
  post_process_cfg: {score_thresh: 0.2, nms_config: {nms_pre_maxsize: 64,
                     nms_post_maxsize: 8, nms_thresh: 0.1}}
  image_size: [64, 96]
"""


def test_reference_yaml_surface_translates_as_jax(tmp_path):
    """The reference YAML's blocks (backbone_3d, f2v_cfg, disc_cfg,
    ffe_cfg, bev_cfg, post_process_cfg) translate as in the JAX package:
    the same geometry, bins, widths, loss weight and test_cfg, and the
    same module tree (the bev_cfg net's state carried across)."""
    path = tmp_path / "caddn_reference.yml"
    path.write_text(REFERENCE_SURFACE)
    jm, state = jax_model(str(path), seed=6)
    model = Config(path=str(path), device="cpu").model
    load_jax_params(model, state)
    for attr in ("pc_range", "voxel_size", "grid_size", "depth_mode",
                 "depth_bins", "depth_range", "feat_channels", "downsample",
                 "depth_loss_weight", "test_cfg", "anchor_mode"):
        assert getattr(model, attr) == getattr(jm, attr), attr
    assert model.depth_mode == "UD" and model.depth_bins == 6
    assert model.test_cfg["nms"]["nms_post_max_size"] == 8
    assert type(model.bev_backbone).__name__ == "_BEVNet"
