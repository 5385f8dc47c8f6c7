"""Port parity of SMOKE, the first camera model: the port's layers, DLA
backbone, head, decode, loss, targets and schedule on the CPU against the
JAX package, with inputs made from a seed by numpy and the JAX weights
carried across with load_jax_params.

Tolerances and why:
  * heatmap_nms, gather_topk_feat, Gt2SmokeTarget, the decode's indices
    and labels: exact (max pools and copies; the same numpy code);
  * feature maps and head outputs: 1e-4 of the largest value (measured
    6e-5 at the tiny DLA's output; one _UpConv is held to 2e-5). flax's
    GroupNorm takes the variance as E[x^2] - E[x]^2 (use_fast_variance),
    torch in two passes, and the convolutions sum in another order;
  * decoded boxes and 2-D boxes 1e-4 of the largest value (3e-3 absolute
    on camera coordinates of tens of metres), scores 1e-5, alphas 5e-4
    (1.5e-3 rad): the decode's arithmetic on heads that differ by 1e-5;
    an alpha is the arctan of sin / (cos + 1e-7), whose slope grows as
    cos nears 0;
  * the train step in f64 on both sides, losses and gradients within 1e-8
    of their largest value (measured 1.5e-13): in f32 a GroupNorm's input
    within rounding of its group mean, or a relu input within rounding of
    0, moves gradients by up to 5e-3 in either framework. The conv biases
    that feed a GroupNorm of one channel a group have a gradient of 0 but
    for rounding, on both sides (held under 1e-12 of the largest).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from paddle3d_tpu.apis.config import Config as JaxConfig
from paddle3d_tpu.models.backbones import dla as jax_dla
from paddle3d_tpu.models.layers import layer_libs as jax_layers
from paddle3d_tpu.models.optimizers.optimizers import \
    PiecewiseDecay as JaxPiecewiseDecay
from paddle3d_tpu.sample import Sample as JaxSample
from paddle3d_tpu.transforms.target_generator import \
    Gt2SmokeTarget as JaxGt2SmokeTarget
from paddle3d_tpu_torch.apis import Config
from paddle3d_tpu_torch.models.backbones import dla
from paddle3d_tpu_torch.models.detection import SMOKE
from paddle3d_tpu_torch.models.layers import layer_libs
from paddle3d_tpu_torch.models.optimizers import PiecewiseDecay
from paddle3d_tpu_torch.ops import _build, gather
from paddle3d_tpu_torch.sample import Sample
from paddle3d_tpu_torch.transforms import Gt2SmokeTarget
from paddle3d_tpu_torch.utils.convert import load_jax_params, to_torch_names

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "smoke", "smoke_synthetic_tiny.yml")
KITTI = os.path.join(REPO, "configs", "smoke",
                     "smoke_dla34_no_dcn_kitti.yml")
H, W = 96, 128                     # the tiny config's input_size
K_CAM = np.array([[60., 0, W / 2], [0, 60., H / 2], [0, 0, 1]], np.float32)
# cars in front (one near the left edge), one behind the camera (skipped by
# the targets), one far to the side (its 2-D box clipped to the map's edge)
# and a narrow object far ahead; (x, y, z, h, w, l, ry)
BOXES = np.array([[-1.0, 1.5, 15.0, 1.5, 1.6, 3.9, 0.3],
                  [2.0, 1.4, 20.0, 1.5, 1.6, 3.9, -0.5],
                  [-6.0, 1.6, 12.0, 1.5, 1.7, 4.2, 1.2],
                  [0.0, 1.5, -5.0, 1.5, 1.6, 3.9, 0.0],
                  [40.0, 1.5, 10.0, 1.5, 1.6, 3.9, 0.0],
                  [1.0, 1.5, 30.0, 1.7, 0.6, 0.8, 2.0]], np.float32)
# the decode's head outputs get this contrast (the tiny config's random
# heatmap is flat at sigmoid(-2.19): near-equal scores would order
# differently in the two frameworks)
CLS_GAIN = 8.0


def flat_state(module):
    """nnx parameters and running stats as {dotted path: numpy array}."""
    return {".".join(map(str, k)): np.asarray(v[...])
            for kind in (nnx.Param, nnx.BatchStat)
            for k, v in nnx.state(module, kind).flat_state()}


def bits(a):
    return np.ascontiguousarray(a).view(np.int32)


def close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (err, tol)


def samples(sample_cls, seed, n=2, boxes=BOXES):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        s = sample_cls(path=None, modality="image")
        s.data = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
        s.meta.camera_intrinsic = K_CAM.copy()
        s.bboxes_3d = boxes[i % 2:].copy()
        s.labels = np.zeros(len(s.bboxes_3d), np.int64)
        out.append(s)
    return out


def make_batch(mode, seed=0, n=2):
    """A batch made by the JAX package's Gt2SmokeTarget (as
    tests/models/test_smoke.py makes one): -> (numpy batch)."""
    gen = JaxGt2SmokeTarget(mode=mode, num_classes=1, flip_prob=0.0,
                            max_objs=8, input_size=(W, H),
                            output_stride=(4, 4))
    made = [gen(s) for s in samples(JaxSample, seed, n)]
    return {"data": np.stack([s.data for s in made]),
            "target": {k: np.stack([s.target[k] for s in made])
                       for k in made[0].target}}


def to_jax(batch, dtype=None):
    def cast(v):
        v = jnp.asarray(v)
        return v.astype(dtype) if dtype and v.dtype == jnp.float32 else v
    return {"data": cast(batch["data"]),
            "target": {k: cast(v) for k, v in batch["target"].items()}}


def to_torch(batch, dtype=torch.float32):
    def cast(v):
        t = torch.from_numpy(np.ascontiguousarray(v))
        return t.to(dtype) if t.dtype == torch.float32 else t
    return {"data": cast(batch["data"]),
            "target": {k: cast(v) for k, v in batch["target"].items()}}


@pytest.fixture(scope="module")
def models():
    """The tiny config on both sides, the JAX weights carried across, the
    class head's last kernel scaled by CLS_GAIN."""
    jax_model = JaxConfig(path=TINY).model
    conv = jax_model.head.cls_conv2
    conv.kernel.value = conv.kernel.value * CLS_GAIN
    model = Config(path=TINY, device="cpu").model
    load_jax_params(model, flat_state(jax_model))
    return jax_model, model.eval()


# ------------------------------------------------------------------ layers
def test_heatmap_nms_bit_for_bit():
    """Local maxima kept, the rest zeroed, bit for bit: quantised values
    make plateaus (every cell of one keeps its value), a flat block, maxima
    on the borders (-inf padding)."""
    rng = np.random.default_rng(0)
    hm = np.round(rng.uniform(0, 1, (2, 24, 32, 3)) * 4).astype(
        np.float32) / 4
    hm[0, :5, :5, 0] = 0.5
    hm[1, -1, -1, 2] = 1.0
    hm[1, 0, 7, 1] = 1.0
    ref = np.asarray(jax_layers.heatmap_nms(jnp.asarray(hm)))
    got = layer_libs.heatmap_nms(torch.from_numpy(hm)).numpy()
    np.testing.assert_array_equal(bits(got), bits(ref))
    assert (got == 0).any() and (got[0, :5, :5, 0] != 0).any()


def test_gather_topk_feat_is_the_row_gather():
    rng = np.random.default_rng(1)
    feat = rng.normal(size=(2, 40, 5)).astype(np.float32)
    idx = rng.integers(-40, 40, (2, 9)).astype(np.int64)
    ref = np.asarray(jax_layers.gather_topk_feat(jnp.asarray(feat),
                                                 jnp.asarray(idx)))
    got = layer_libs.gather_topk_feat(torch.from_numpy(feat),
                                      torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_upconv_matches_jax(factor):
    """IDAUp's projection, factor-f transposed conv and node: the port's
    bilinear init equals the JAX init carried across; with a random
    (asymmetric) upsampling kernel the outputs agree, so the kernel flip
    and the SAME padding f // 2 are right."""
    jm = jax_dla._UpConv(6, 8, factor, "gn", rngs=nnx.Rngs(0))
    pm = dla._UpConv(6, 8, factor, "gn")
    init = to_torch_names(pm, {"up.kernel": np.asarray(jm.up.kernel[...])})
    np.testing.assert_array_equal(pm.up.weight.detach().numpy(),
                                  init["up.weight"].numpy())
    rng = np.random.default_rng(factor)
    jm.up.kernel.value = jnp.asarray(rng.normal(
        size=jm.up.kernel[...].shape).astype(np.float32))
    load_jax_params(pm, flat_state(jm))
    x = rng.normal(size=(2, 5, 7, 6)).astype(np.float32)
    ref = np.asarray(jm.node(jm.upsample(jm.project(jnp.asarray(x)))))
    with torch.no_grad():
        got = pm.node(pm.upsample(pm.project(torch.from_numpy(x).permute(
            0, 3, 1, 2)))).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 5 * factor, 7 * factor, 8)
    close(got, ref, 2e-5)


def test_dla_and_head_match_jax(models):
    """The tiny DLA's output map, then SMOKEPredictor's heatmap and
    regression on the JAX map (NHWC views on the port's side)."""
    jax_model, model = models
    img = np.random.default_rng(2).uniform(0, 255, (2, H, W, 3)).astype(
        np.float32)
    feats = jax.jit(lambda g, s, x: nnx.merge(g, s).backbone(x))(
        *nnx.split(jax_model), jnp.asarray(img / 255.0))
    hm, reg = jax.device_get(jax_model.head(feats))
    feats = np.asarray(feats)
    with torch.no_grad():
        got = model.backbone(torch.from_numpy(img).permute(0, 3, 1, 2) /
                             255.0)
        ghm, greg = model.head(torch.from_numpy(feats).permute(0, 3, 1, 2))
    assert tuple(got.shape) == (2, 8, H // 4, W // 4)
    close(got.permute(0, 2, 3, 1).numpy(), feats, 1e-4)
    assert tuple(ghm.shape) == hm.shape and tuple(greg.shape) == reg.shape
    close(ghm.numpy(), hm, 1e-4)
    close(greg.numpy(), reg, 1e-4)


# ------------------------------------------------------------------- model
def jax_test_forward(jax_model, batch):
    return jax.device_get(nnx.jit(lambda m, b: m.test_forward(b))(
        jax_model, to_jax(batch)))


def check_outputs(got, ref, k=8):
    assert set(got) == set(ref)
    assert tuple(got["box3d_cam"].shape) == (2, k, 7)
    np.testing.assert_array_equal(got["label_preds"].numpy(),
                                  ref["label_preds"])
    close(got["scores"].numpy(), ref["scores"], 1e-5)
    for key, tol in (("box3d_cam", 1e-4), ("bbox_2d", 1e-4),
                     ("alphas", 5e-4)):
        close(got[key].numpy(), ref[key], tol)


def test_test_forward_matches_jax(models):
    """The tiny SMOKE end to end on random images: outputs key for key."""
    jax_model, model = models
    batch = make_batch("val")
    ref = jax_test_forward(jax_model, batch)
    with torch.no_grad():
        got = model.test_forward(to_torch(batch))
    check_outputs(got, ref)
    assert (ref["scores"] >= 0).all()


def test_decode_ties_follow_top_k(models, monkeypatch):
    """A heatmap with fewer maxima than K: two distinct peaks of equal
    score, one more, then a plateau of equal scores (the head's clamp at
    1e-4) from which the top K take the first cells in index order, as
    jax.lax.top_k does; those slots are padded (-1 score and label) and
    their boxes decoded from the tied indices. Scan 2 is one plateau:
    every cell a maximum."""
    jax_model, model = models
    rng = np.random.default_rng(3)
    h, w = H // 4, W // 4
    hm = np.full((2, h, w, 1), 1e-4, np.float32)
    hm[0, 5, 7, 0] = hm[0, 12, 20, 0] = 0.9
    hm[0, 18, 3, 0] = 0.6
    hm[0, 5, 8, 0] = 0.3                  # beside a peak: zeroed by the NMS
    hm[1] = 0.25
    reg = rng.normal(size=(2, h, w, 10)).astype(np.float32)
    reg[..., 6:8] /= np.linalg.norm(reg[..., 6:8], axis=-1, keepdims=True)
    monkeypatch.setattr(type(jax_model.head), "__call__",
                        lambda self, feats: (jnp.asarray(hm),
                                             jnp.asarray(reg)))
    batch = make_batch("val")
    ref = jax_test_forward(jax_model, batch)
    maps = (torch.from_numpy(np.ascontiguousarray(hm.transpose(0, 3, 1, 2))
                             ).permute(0, 2, 3, 1),
            torch.from_numpy(np.ascontiguousarray(reg.transpose(0, 3, 1, 2))
                             ).permute(0, 2, 3, 1))
    monkeypatch.setattr(model.head, "forward", lambda feats: maps)
    with torch.no_grad():
        got = model.test_forward(to_torch(batch))
    check_outputs(got, ref)
    np.testing.assert_array_equal(ref["label_preds"][0],
                                  [0, 0, 0] + [-1] * 5)
    assert (ref["label_preds"][1] == 0).all()


def test_decode_gathers_the_nchw_view_through_k14(models, monkeypatch):
    """The decode's one row gather goes through ops/gather.gather_rows with
    the regression map read in place ([B, H*W, R] with channel stride H*W)
    and int32 indices; on the CPU no kernel library is asked for and no
    counter moves."""
    _, model = models
    calls = []
    real = gather.gather_rows

    def record(src, idx):
        calls.append((src.shape, src.stride(), idx.dtype))
        return real(src, idx)

    def no_build():
        raise AssertionError("kernel library requested for a CPU tensor")

    monkeypatch.setattr(gather, "gather_rows", record)
    monkeypatch.setattr(_build, "library", no_build)
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        model.test_forward(to_torch(make_batch("val")))
    hw = (H // 4) * (W // 4)
    assert calls == [((2, hw, 10), (10 * hw, 1, hw), torch.int32)]
    assert _build.LAUNCHES == before


def test_train_forward_matches_jax_in_f64(models):
    """train_forward (images / 255, backbone, head, focal and
    disentangled-L1 losses) with targets from the JAX Gt2SmokeTarget:
    losses and every gradient against the JAX step's, both in f64."""
    jax_model, _ = models
    batch = make_batch("train")
    assert batch["target"]["reg_mask"].sum() == 9     # 5 and 4 objects
    state0 = flat_state(jax_model)
    with jax.enable_x64():
        graphdef, state = nnx.split(jax_model)
        jm = nnx.merge(graphdef, jax.tree.map(
            lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32
            else x, state))

        @nnx.jit
        def grads_of(m, b):
            def loss_fn(m):
                losses = m.train_forward(b)
                return losses["loss"], losses
            return nnx.grad(loss_fn, has_aux=True)(m)

        grads, want = jax.device_get(grads_of(jm, to_jax(batch,
                                                         jnp.float64)))
    model = Config(path=TINY, device="cpu").model
    load_jax_params(model, state0)
    model.double().train()
    got = model.train_forward(to_torch(batch, torch.float64))
    got["loss"].backward()
    for key in ("loss", "hm_loss", "reg_loss"):
        close(got[key].item(), want[key], 1e-8)
    ref = to_torch_names(model, {
        ".".join(map(str, k)): np.asarray(v[...])
        for k, v in nnx.state(grads, nnx.Param).flat_state()})
    top = max(np.abs(r.numpy()).max() for r in ref.values())
    for name, p in model.named_parameters():
        if name in ("head.cls_conv1.bias", "head.reg_conv1.bias"):
            # each feeds a GroupNorm of one channel a group, which takes
            # its mean away: zero but for rounding, on both sides
            assert np.abs(p.grad.numpy()).max() <= 1e-12 * top
            assert np.abs(ref[name].numpy()).max() <= 1e-12 * top
        else:
            close(p.grad.numpy(), ref[name].numpy(), 1e-8)


# ---------------------------------------------------------------- targets
@pytest.mark.parametrize("mode", ["train", "val"])
@pytest.mark.parametrize("flip_prob", [0.0, 1.0])
def test_gt2smoke_target_matches_jax(mode, flip_prob):
    """The port's numpy Gt2SmokeTarget against the JAX one, array for
    array: cars in view, one behind the camera and one far to the side
    (skipped), six boxes for max_objs 4 (the rest dropped), unflipped and
    flipped."""
    kw = dict(mode=mode, num_classes=2, flip_prob=flip_prob, max_objs=4,
              input_size=(W, H), output_stride=(4, 4))
    boxes = BOXES.copy()
    jax_gen, gen = JaxGt2SmokeTarget(**kw), Gt2SmokeTarget(**kw)
    for js, s in zip(samples(JaxSample, 4, boxes=boxes),
                     samples(Sample, 4, boxes=boxes)):
        s.labels = js.labels = np.array([0, 1, 0, 1, 0, 1][:len(
            s.bboxes_3d)], np.int64)
        s.rng = np.random.RandomState(0)    # the port's flip draws from it
        js, s = jax_gen(js), gen(s)
        np.testing.assert_array_equal(s.data, js.data)
        assert s.data.dtype == np.float32
        assert set(s.target) == set(js.target)
        for key, value in js.target.items():
            assert s.target[key].dtype == value.dtype, key
            np.testing.assert_array_equal(s.target[key], value, key)
        if mode == "train":
            assert 0 < s.target["reg_mask"].sum() < 4


def test_gt2smoke_target_refuses_other_sizes():
    """Once refused, an image not at input_size is now resized to it (the
    BILINEAR resize, byte for byte Pillow's), as the JAX transform does:
    the same image, K and targets."""
    js, s = samples(JaxSample, 5, n=1)[0], samples(Sample, 5, n=1)[0]
    img = np.random.default_rng(5).integers(0, 255, (H, W + 4, 3),
                                            dtype=np.uint8)
    js.data, s.data = img.copy(), img.copy()
    kw = dict(mode="val", num_classes=1, input_size=(W, H))
    js, s = JaxGt2SmokeTarget(**kw)(js), Gt2SmokeTarget(**kw)(s)
    assert s.data.shape == (H, W, 3)
    np.testing.assert_array_equal(s.data, js.data)
    for key, value in js.target.items():
        np.testing.assert_array_equal(s.target[key], value, key)


# ----------------------------------------------------- schedule and config
def test_piecewise_decay_matches_optax():
    """The KITTI config's schedule at b - 1, b and b + 1 of each boundary:
    the scale applies from the boundary step on."""
    boundaries, values = [36000, 55000], [1.25e-4, 1.25e-5, 1.25e-6]
    ref = JaxPiecewiseDecay(boundaries, values)
    sched = PiecewiseDecay(boundaries, values)
    for b in boundaries:
        for step in (b - 1, b, b + 1):
            assert sched.learning_rate * sched.factor(step) == pytest.approx(
                float(ref(step)), rel=1e-6)
    assert sched.factor(0) == 1.0
    assert sched.learning_rate * sched.factor(55000) == pytest.approx(1.25e-6)


def test_kitti_config_at_full_width():
    """The KITTI config on the CPU at full width (DLA-34, 3 classes,
    256-channel heads): the JAX model's parameter count and whole state
    carried across; its Adam and PiecewiseDecay built over the model."""
    cfg = Config(path=KITTI, device="cpu")
    model = cfg.model
    assert isinstance(model, SMOKE) and model.max_detection == 50
    jax_state = flat_state(JaxConfig(path=KITTI).model)
    assert sum(p.numel() for p in model.parameters()) == sum(
        v.size for v in jax_state.values())
    load_jax_params(model, jax_state)
    assert cfg.optimizer.param_groups[0]["lr"] == pytest.approx(1.25e-4)
    assert cfg.lr_scheduler.lr_lambdas[0](36000) == pytest.approx(0.1)
