"""Port parity of BEVFormer, the fifth camera model: the deformable
attention op against both JAX forms, the temporal self-attention, the
spatial cross-attention, the ego-motion alignment of the previous BEV,
the heads' decode over BEV tokens and a tiny BEVFormer end to end (two
frames of serving with prev_bev and can_bus, one train step with a history
queue) on the CPU against the JAX package, with inputs made from a seed by
numpy, and the full-width config's state.

The JAX models are built abstractly (nnx.eval_shape) and filled from a
seed by numpy (tests/test_torch_petr.py's seeded_state: the sampling
offsets' kernels random too, where the JAX package starts them at zero, so
that the samples move off their reference points); utils/convert
.load_jax_params carries the state across (the bare bev_embedding, the
CAN-bus MLP's LayerNorm inside an nnx.Sequential, the per-layer branches
in nnx.Lists). The cameras are chip_smoke.bevformer_rig's:
tools/bench_camera.py's ring for [0, 1] image coordinates.

Tolerances and why:
  * ms_deform_attn: 1e-12 of the largest value in f64 against both JAX
    forms (the gather-and-lerp path and the dense tent-weight matmul the
    JAX package takes for levels of at most 4,096 cells), 1e-6 in f32 (the
    tent path's sums run in another order);
  * the attentions, the alignment, the decode: 1e-5 of the largest value
    (f32 matmuls summed in other orders, XLA's fast-variance LayerNorm);
  * test_forward: labels equal, scores 1e-5, boxes 1e-4, bev_feature 1e-5
    of the largest value;
  * the train step in f64 on both sides, so that no Hungarian cost lies
    within rounding of another: every layer's assignment equal. The
    decoder's attention softmax runs in f32 on both sides, as
    jax.nn.dot_product_attention runs it (tests/test_torch_petr.py), so:
    losses 1e-7 relative, grads 1e-5 of the larger of their tensor's
    largest value and 1e-3 of the step's largest grad, running stats
    1e-12.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

import chip_smoke
from paddle3d_tpu.apis.config import Config as JaxConfig
from paddle3d_tpu.models.heads import BEVFormerHead as JaxBEVFormerHead
from paddle3d_tpu.models.heads import PETRHead as JaxPETRHead
from paddle3d_tpu.models.transformers import attentions as jax_attn
from paddle3d_tpu.ops.ms_deform_attn import \
    ms_deform_attn as jax_ms_deform_attn
from paddle3d_tpu_torch.apis import Config
from paddle3d_tpu_torch.models.detection import BEVFormer
from paddle3d_tpu_torch.models.heads import BEVFormerHead, PETRHead
from paddle3d_tpu_torch.models.transformers import (SpatialCrossAttention,
                                                    TemporalSelfAttention)
from paddle3d_tpu_torch.ops.ms_deform_attn import ms_deform_attn
from paddle3d_tpu_torch.utils.convert import load_jax_params
from tests.test_torch_petr import (abstract_shapes, check_state_names, close,
                                   flat_state, jax_model, seeded_state,
                                   to_jax, to_torch, train_step_case)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL = os.path.join(REPO, "configs", "bevformer",
                    "bevformer_tiny_r50_fpn_nuscenes.yml")
PC = [-10., -10., -3., 10., 10., 3.]
HW, CAMS = (64, 64), 2          # the tiny model's images and cameras
CLS_GAIN = 8.0
HEAD = dict(num_classes=2, in_channels=32, embed_dims=32, num_query=16,
            num_heads=4, num_layers=2, depth_num=4, pc_range=PC,
            position_range=PC)


@pytest.fixture(scope="module")
def tiny_yml(tmp_path_factory):
    """tests/models/test_bevformer.py's tiny BEVFormer with box refinement
    as a config: ResNet-18 at base 8 to C5 (no neck), an 8 x 8 BEV of 32
    channels, 2 encoder layers, a 2-layer BEVFormerHead of 16 queries."""
    path = tmp_path_factory.mktemp("cfg") / "bevformer_tiny.yml"
    path.write_text(yaml.safe_dump({"model": {
        "type": "BEVFormer", "bev_h": 8, "bev_w": 8, "embed_dims": 32,
        "num_heads": 4, "encoder_layers": 2, "pc_range": PC,
        "backbone": {"type": "ResNet", "depth": 18, "base_channels": 8,
                     "out_indices": [3]},
        "neck": None,
        "head": dict(type="BEVFormerHead", with_box_refine=True, **HEAD)}}))
    return str(path)


@pytest.fixture(scope="module")
def tiny(tiny_yml):
    """The tiny config on both sides, the seeded JAX state carried across,
    each class branch's last kernel scaled by CLS_GAIN first (its random
    scores sit within ~1e-6 of each other, and such near-ties order
    differently in the two frameworks); both in eval mode."""
    jm, _ = jax_model(tiny_yml)
    for branch in jm.head.cls_branches:
        kernel = branch.layers[2].kernel
        kernel[...] = kernel[...] * CLS_GAIN
    state = flat_state(jm)
    jm.eval()
    model = Config(path=tiny_yml, device="cpu").model
    load_jax_params(model, state)
    return jm, state, model.eval()


def can_bus(b, dx=1.5, dy=0.4, yaw=0.3, dyaw=0.12):
    out = np.zeros((b, 18), np.float32)
    out[:, 0], out[:, 1], out[:, -2], out[:, -1] = dx, dy, yaw, dyaw
    out[:, 2:16] = np.random.default_rng(7).normal(size=(b, 14)) * 0.1
    return out


def serve_batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return {"img": rng.uniform(0, 255, (b, CAMS) + HW + (3,)).astype(
                np.float32),
            "lidar2imgs": np.broadcast_to(chip_smoke.bevformer_rig(
                HW, CAMS), (b, CAMS, 4, 4)).copy()}


def train_batch(seed=1, b=2):
    batch = serve_batch(seed, b)
    rng = np.random.default_rng(seed + 10)
    batch["img_queue"] = rng.uniform(0, 255, (b, 1) + batch["img"].shape[
        1:]).astype(np.float32)
    batch["lidar2imgs_queue"] = batch["lidar2imgs"][:, None].copy()
    batch["can_bus"] = can_bus(b)
    batch["can_bus_queue"] = can_bus(b, 0.8, -0.2, 0.18, 0.05)[:, None]
    boxes = np.zeros((b, 4, 9), np.float32)
    boxes[..., 0] = rng.uniform(2, 9, (b, 4))
    boxes[..., 1] = rng.uniform(-3, 3, (b, 4))
    boxes[..., 2] = rng.uniform(-2, -1, (b, 4))
    boxes[..., 3:6] = rng.uniform([1.5, 3.5, 1.4], [2.0, 4.5, 1.8], (b, 4, 3))
    boxes[..., 6] = rng.uniform(-3, 3, (b, 4))
    boxes[..., 7:] = rng.normal(0, 1, (b, 4, 2))
    labels = rng.integers(0, 2, (b, 4))
    labels[1, 3] = -1                           # a padded slot
    boxes[1, 3] = 0
    batch.update(gt_boxes=boxes, gt_labels=labels)
    return batch


# --------------------------------------------------------------- the op
def msda_case(dtype):
    """Two levels (5 x 7 and 3 x 4), 2 samples of 11 queries, 2 heads of 4
    channels, 3 points; locations in [-0.2, 1.2] (out-of-range taps)."""
    rng = np.random.default_rng(1)
    shapes = ((5, 7), (3, 4))
    s = sum(h * w for h, w in shapes)
    value = rng.normal(size=(2, s, 2, 4)).astype(dtype)
    locs = rng.uniform(-0.2, 1.2, (2, 11, 2, 2, 3, 2)).astype(dtype)
    weights = rng.uniform(0, 1, (2, 11, 2, 2, 3)).astype(dtype)
    weights /= weights.sum(axis=(3, 4), keepdims=True)
    return shapes, value, locs, weights


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_ms_deform_attn_matches_both_jax_forms(dtype):
    """The batched op against the JAX package's per-sample op on its
    gather path (force_gather) and its tent-weight matmul path, with taps
    outside the maps, in f64 and f32."""
    np_dt = np.float64 if dtype == "f64" else np.float32
    shapes, value, locs, weights = msda_case(np_dt)
    with jax.enable_x64(dtype == "f64"):
        refs = [np.stack([np.asarray(jax_ms_deform_attn(
            jnp.asarray(value[i]), shapes, jnp.asarray(locs[i]),
            jnp.asarray(weights[i]), force_gather=fg)) for i in range(2)])
            for fg in (True, False)]
    got = ms_deform_attn(torch.from_numpy(value), shapes,
                         torch.from_numpy(locs),
                         torch.from_numpy(weights)).numpy()
    assert got.shape == (2, 11, 8) and got.dtype == np_dt
    tol = 1e-12 if dtype == "f64" else 1e-6
    for ref in refs:
        close(got, ref, tol)
    outside = (locs < 0) | (locs > 1)
    assert outside.any() and not outside.all()


def test_ms_deform_attn_gradient_matches_jax():
    """The gradient of a weighted sum of the output in the values and the
    sampling locations, against jax.grad of the gather path, f64."""
    shapes, value, locs, weights = msda_case(np.float64)
    cot = np.random.default_rng(2).normal(size=(2, 11, 8))
    with jax.enable_x64():
        def f(v, l):
            return sum(jnp.sum(jax_ms_deform_attn(
                v[i], shapes, l[i], jnp.asarray(weights[i]),
                force_gather=True) * cot[i]) for i in range(2))
        gv, gl = jax.grad(f, argnums=(0, 1))(jnp.asarray(value),
                                            jnp.asarray(locs))
    v, loc = (torch.from_numpy(x).requires_grad_() for x in (value, locs))
    (ms_deform_attn(v, shapes, loc, torch.from_numpy(weights)) *
     torch.from_numpy(cot)).sum().backward()
    close(v.grad.numpy(), np.asarray(gv), 1e-12)
    close(loc.grad.numpy(), np.asarray(gl), 1e-12)


# ----------------------------------------------------------- attentions
@pytest.mark.parametrize("shifted", [False, True], ids=["no_shift", "shift"])
def test_temporal_self_attention_matches_jax(shifted):
    """TSA at 32 channels, 4 heads, on an 8 x 8 BEV of 2 samples: the
    current and the previous BEV's samples averaged, the ego shift moving
    the previous branch's grid only."""
    jm, state = seeded_state(nnx.eval_shape(
        lambda: jax_attn.TemporalSelfAttention(32, 4, rngs=nnx.Rngs(0))), 3)
    pm = TemporalSelfAttention(32, 4)
    load_jax_params(pm, state)
    rng = np.random.default_rng(4)
    q, prev = (rng.normal(size=(2, 64, 32)).astype(np.float32)
               for _ in range(2))
    ref_pts = rng.uniform(0, 1, (2, 64, 2)).astype(np.float32)
    shift = (rng.normal(0, 0.1, (2, 2)).astype(np.float32) if shifted
             else None)
    want = jm(jnp.asarray(q), reference_points=jnp.asarray(ref_pts),
              spatial_shapes=((8, 8),), prev_bev=jnp.asarray(prev),
              shift=None if shift is None else jnp.asarray(shift))
    t = torch.from_numpy
    with torch.no_grad():
        got = pm(t(q), reference_points=t(ref_pts), spatial_shapes=((8, 8),),
                 prev_bev=t(prev), shift=None if shift is None else t(shift))
    close(got.numpy(), np.asarray(want), 1e-5)


def test_spatial_cross_attention_matches_jax():
    """SCA at 32 channels, 4 heads over two cameras' 4 x 6 tokens under
    the rig (cameras facing +x and -x): some BEV queries seen by both
    cameras' pillar points, some by one, some by none (their output is
    the projection's bias alone)."""
    jm, state = seeded_state(nnx.eval_shape(
        lambda: jax_attn.SpatialCrossAttention(32, 4, pc_range=PC,
                                               rngs=nnx.Rngs(0))), 5)
    pm = SpatialCrossAttention(32, 4, pc_range=PC)
    load_jax_params(pm, state)
    rng = np.random.default_rng(6)
    q = rng.normal(size=(2, 64, 32)).astype(np.float32)
    value = rng.normal(size=(2, CAMS, 24, 32)).astype(np.float32)
    ys, xs = np.meshgrid((np.arange(8) + 0.5) / 8, (np.arange(8) + 0.5) / 8,
                         indexing="ij")
    bev_ref = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    l2i = np.broadcast_to(chip_smoke.bevformer_rig((32, 48), CAMS),
                          (2, CAMS, 4, 4)).copy()
    want = jm(jnp.asarray(q), jnp.asarray(value), jnp.asarray(bev_ref),
              jnp.asarray(l2i), ((4, 6),))
    t = torch.from_numpy
    with torch.no_grad():
        got = pm(t(q), t(value), t(bev_ref), t(l2i), ((4, 6),))
        _, hit = pm.project(t(bev_ref), t(l2i))
    close(got.numpy(), np.asarray(want), 1e-5)
    seen = hit.sum(dim=1)[0]
    assert (seen == 0).any() and (seen == 1).any()


def test_rotate_prev_bev_and_can_bus_shift_match_jax(tiny):
    """_rotate_prev_bev (indices clipped, fractions clipped, the whole
    sample zeroed outside the map) at yaw deltas of 0, 0.3 and pi / 2, and
    _can_bus_shift, against the JAX model's."""
    jm, _, model = tiny
    rng = np.random.default_rng(8)
    bev = rng.normal(size=(3, 64, 5)).astype(np.float32)
    angles = np.array([0.0, 0.3, np.pi / 2], np.float32)
    want = jax.jit(jm._rotate_prev_bev)(jnp.asarray(bev), jnp.asarray(
        angles))
    got = model._rotate_prev_bev(torch.from_numpy(bev),
                                 torch.from_numpy(angles))
    close(got.numpy(), np.asarray(want), 1e-5)
    np.testing.assert_array_equal(got[0].numpy(), bev[0])
    cb = can_bus(3)
    cb[1, :2] = [-2.0, 3.0]
    cb[2, :2] = 0.0
    want = jm._can_bus_shift(jnp.asarray(cb))
    got = model._can_bus_shift(torch.from_numpy(cb))
    close(got.numpy(), np.asarray(want), 1e-6)


# ---------------------------------------------------------------- heads
@pytest.mark.parametrize("head", ["petr", "bevformer_refine"])
def test_decode_over_tokens_matches_jax(head):
    """The decode over 64 BEV tokens of 32 channels: PETRHead's (its
    decoder with no key position embedding) and BEVFormerHead's (a branch
    pair a layer, the reference points refined and detached between
    layers): every layer's class and box outputs."""
    if head == "petr":
        def build(rngs):
            return JaxPETRHead(rngs=rngs, **HEAD)
        pm = PETRHead(**HEAD)
    else:
        def build(rngs):
            return JaxBEVFormerHead(with_box_refine=True, rngs=rngs, **HEAD)
        pm = BEVFormerHead(with_box_refine=True, **HEAD)
    jm, state = seeded_state(nnx.eval_shape(lambda: build(nnx.Rngs(0))), 9)
    load_jax_params(pm, state)
    tokens = np.random.default_rng(10).normal(size=(2, 64, 32)).astype(
        np.float32)
    want = jm.decode_over_tokens(jnp.asarray(tokens), (8, 8))
    with torch.no_grad():
        got = pm.decode_over_tokens(torch.from_numpy(tokens), (8, 8))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        close(g.numpy(), np.asarray(w), 1e-5)
    if head != "petr":          # the refinement moves the layers' boxes
        assert not np.allclose(np.asarray(want[1][0]), np.asarray(want[1][1]))


# ------------------------------------------------------------------ model
def test_tiny_test_forward_two_frames_matches_jax(tiny):
    """Two frames of serving: the first alone, the second with the first's
    bev_feature as prev_bev and a can_bus (the rotation and the shift
    run); labels, scores, boxes and both BEVs."""
    jm, _, model = tiny
    infer = nnx.jit(lambda m, b: m.test_forward(b))
    first = serve_batch(0)
    ref1 = jax.device_get(infer(jm, to_jax(first)))
    got1 = model.test_forward(to_torch(first))
    second = serve_batch(1)
    second["can_bus"] = can_bus(2)
    ref2 = jax.device_get(infer(jm, to_jax(second) | {
        "prev_bev": jnp.asarray(ref1["bev_feature"])}))
    got2 = model.test_forward(to_torch(second) | {
        "prev_bev": got1["bev_feature"]})
    for got, ref in ((got1, ref1), (got2, ref2)):
        assert set(got) == set(ref)
        assert tuple(got["box3d_lidar"].shape) == (2, 32, 9)
        assert tuple(got["bev_feature"].shape) == (2, 64, 32)
        np.testing.assert_array_equal(got["label_preds"].numpy(),
                                      ref["label_preds"])
        close(got["scores"].numpy(), ref["scores"], 1e-5)
        close(got["box3d_lidar"].numpy(), ref["box3d_lidar"], 1e-4)
        close(got["bev_feature"].numpy(), ref["bev_feature"], 1e-5)
        assert len(np.unique(ref["scores"])) == ref["scores"].size
    assert not np.allclose(ref1["bev_feature"], ref2["bev_feature"])


def test_tiny_train_step_with_history_matches_jax_in_f64(tiny_yml,
                                                         monkeypatch):
    """train_forward with a one-frame history queue (encoded without
    gradient, its BN running stats updated first) and can_bus, in train
    mode, both sides in f64: every Hungarian assignment, the losses, every
    gradient and the running stats."""
    batch = train_batch()
    solves, got, want, model, ref, after = train_step_case(
        tiny_yml, batch, monkeypatch)
    assert len(solves["port"]) == len(solves["jax"]) == 2 * 2  # L x B
    for a, b in zip(solves["port"], solves["jax"]):
        np.testing.assert_array_equal(a, b)
    assert sum((a >= 0).sum() for a in solves["port"]) == 2 * 7
    assert set(got) == set(want) == {"loss", "loss_cls", "loss_bbox"}
    for k in want:
        close(got[k].item(), want[k], 1e-7)
    assert set(ref) == {n for n, _ in model.named_parameters()}
    largest = max(v.abs().max().item() for v in ref.values())
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        err = (g - ref[name]).abs().max().item()
        assert err <= 1e-5 * max(ref[name].abs().max().item(),
                                 1e-3 * largest), name
    sd = model.state_dict()
    for name, v in after.items():
        close(sd[name].numpy(), v.numpy(), 1e-12)


def test_bevformer_refuses_train_mode_serving(tiny):
    _, _, model = tiny
    model.train()
    try:
        with pytest.raises(RuntimeError, match="eval"):
            model.test_forward(to_torch(serve_batch()))
    finally:
        model.eval()
    # postprocess_to_samples, once refused (item 5), is PETR's,
    # as in the JAX package: no meta, no sample
    assert BEVFormer.postprocess_to_samples(
        {"box3d_lidar": np.zeros((0, 4, 9)), "scores": np.zeros((0, 4)),
         "label_preds": np.zeros((0, 4))}, []) == []


# --------------------------------------------------------------- configs
def test_full_config_builds_with_jax_state():
    """configs/bevformer/bevformer_tiny_r50_fpn_nuscenes.yml through both
    packages' Config (the port's on the meta device): the state's names
    and shapes, load_jax_params filling every parameter and running stat
    from the JAX state's paths (the bare bev_embedding, the CAN-bus MLP's
    LayerNorm, the per-layer branches), the BEV grid and the head."""
    jm = nnx.eval_shape(lambda: JaxConfig(path=FULL).model)
    with torch.device("meta"):
        model = Config(path=FULL, device="meta").model
    shapes = abstract_shapes(jm)
    check_state_names(model, shapes)
    load_jax_params(model, {k: np.zeros(s, np.float32)
                            for k, s in shapes.items()})
    assert "bev_embedding" in shapes and \
        "can_bus_mlp.layers.4.scale" in shapes
    assert (model.bev_h, model.bev_w, model.embed_dims, len(model.encoder)) \
        == (jm.bev_h, jm.bev_w, jm.embed_dims, len(jm.encoder)) == (
            50, 50, 256, 3)
    head = model.head
    assert isinstance(head, BEVFormerHead) and head.with_box_refine
    assert (head.num_query, head.num_layers, len(head.cls_branches)) == (
        900, 6, 6)
