"""Port parity of CAPE and CAPE-T, the seventh and eighth camera models: the
camera-frame inputs (the key and query position embeddings in each
camera's frame, the visibility masks), the gated stream fusion, the tiny
configs end to end (serving with and without lidar2cams, one CAPE-T train
step with query denoising and the previous stream's auxiliary loss) on
the CPU against the JAX package, with inputs made from a seed by numpy,
and the three full configs' state.

The JAX models are built abstractly (nnx.eval_shape) and filled from a
seed by numpy (tests/test_torch_petr.py's seeded_state); utils/convert
.load_jax_params carries the state across. The cameras are
chip_smoke.cape_rig's: tools/bench_camera.py's ring for [0, 1] image
coordinates (petr_rig's img2lidars) with the lidar2cams that agree with
them; CAPE-T's previous frame is PETR_EGO m behind.

Tolerances and why:
  * the visibility masks: equal (index-valued: a camera z against 0.1);
  * position embeddings, the fusion, the head's outputs: 1e-5 of the
    largest value (matmuls summed in other orders, XLA's fast-variance
    LayerNorm, the 4 x 4 products and the ego inverse rounded otherwise);
  * test_forward: labels equal, scores 1e-5, boxes 1e-4 of the largest
    value, as for PETR (tests/test_torch_petr.py);
  * the CAPE-T train step in f64 on both sides, every Hungarian
    assignment equal; the attention's softmax runs in f32 on both sides
    (jax.nn.dot_product_attention's form), so losses 1e-7 relative and
    grads 1e-5 of the larger of their tensor's largest value and 1e-3 of
    the step's largest grad, as PETR's step is held.
"""
import functools
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
from paddle3d_tpu.models.heads import cape_head as jax_cape
from paddle3d_tpu.models.heads import target_assigners as jax_ta
from paddle3d_tpu_torch.apis import Config
from paddle3d_tpu_torch.models.heads import CAPEHead
from paddle3d_tpu_torch.models.heads import cape_head, target_assigners
from paddle3d_tpu_torch.utils.convert import load_jax_params
from tests.test_torch_petr import (abstract_shapes, check_state_names, close,
                                   jax_model, n_params, seeded_state, to_jax,
                                   to_torch, train_step_case)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "cape")
TINY_PETR = os.path.join(REPO, "configs", "petr", "petr_synthetic_tiny.yml")
CONFIGS = ["cape_r50_1408x512", "cape_t_r50_704x256", "cape_t_v99_800x320"]
H, W, CAMS = 32, 48, 3          # the tiny configs' images and cameras


@pytest.fixture(scope="module")
def ymls(tmp_path_factory):
    """The tiny PETR config with a CAPEHead (CAPE), and as CAPE-T: version
    2 by the head's with_time, the previous stream's aux loss, query
    denoising (3 groups with negatives)."""
    tmp = tmp_path_factory.mktemp("cfg")
    cape, cape_t = tmp / "cape_tiny.yml", tmp / "cape_t_tiny.yml"
    cape.write_text(yaml.safe_dump({
        "_base_": TINY_PETR, "model": {"head": {"type": "CAPEHead"}}}))
    cape_t.write_text(yaml.safe_dump({
        "_base_": str(cape),
        "model": {"version": None,
                  "dn_config": {"groups": 3, "box_noise_scale": 0.4,
                                "label_noise_ratio": 0.4, "negative": True},
                  "head": {"with_time": True, "with_prev_aux_loss": True,
                           "prev_aux_loss_weight": 0.1}}}))
    return {"cape": str(cape), "cape_t": str(cape_t)}


def serve_batch(seed=0, b=2, frames=1, cams=CAMS):
    rng = np.random.default_rng(seed)
    n = cams * frames
    i2l, l2c = chip_smoke.cape_rig((H, W), cams, frames)
    return {"img": rng.uniform(0, 255, (b, n, H, W, 3)).astype(np.float32),
            "img2lidars": np.broadcast_to(i2l, (b, n, 4, 4)).copy(),
            "lidar2cams": np.broadcast_to(l2c, (b, n, 4, 4)).copy()}


def train_batch(seed=1, frames=2):
    batch = serve_batch(seed, frames=frames)
    rng = np.random.default_rng(seed + 10)
    boxes = np.zeros((2, 4, 9), np.float32)
    boxes[..., :2] = rng.uniform(-8, 8, (2, 4, 2))
    boxes[..., 2] = rng.uniform(-2, 0, (2, 4))
    boxes[..., 3:6] = rng.uniform([1.5, 3.5, 1.4], [2.0, 4.5, 1.8],
                                  (2, 4, 3))
    boxes[..., 6] = rng.uniform(-3, 3, (2, 4))
    boxes[..., 7:] = rng.normal(0, 1, (2, 4, 2))
    labels = rng.integers(0, 3, (2, 4))
    labels[1, 3] = -1                           # a padded slot
    boxes[1, 3] = 0
    batch.update(gt_boxes=boxes, gt_labels=labels)
    return batch


@functools.lru_cache(maxsize=None)
def tiny(path):
    """A tiny config on both sides, the seeded JAX state carried across;
    both in eval mode."""
    jm, state = jax_model(path)
    jm.eval()
    model = Config(path=path, device="cpu").model
    load_jax_params(model, state)
    return jm, state, model.eval()


# ---------------------------------------------------------------- configs
def test_tiny_configs_build_with_jax_state_names(ymls):
    """Both tiny configs through both packages' Config: the state's names
    and shapes (the fusion modules of CAPE-T too), the version (2 from
    the head's with_time) and the head's settings."""
    for key, version in (("cape", 1), ("cape_t", 2)):
        jm = nnx.eval_shape(lambda: JaxConfig(path=ymls[key]).model)
        with torch.device("meta"):
            model = Config(path=ymls[key], device="meta").model
        check_state_names(model, abstract_shapes(jm))
        assert model.version == jm.version == version
        head, ref = model.head, jm.head
        assert isinstance(head, CAPEHead) and head.wants_lidar2cams
        assert (head.with_time, head.with_prev_aux_loss,
                head.prev_aux_loss_weight, head.default_time_lag) == (
                    ref.with_time, ref.with_prev_aux_loss,
                    ref.prev_aux_loss_weight, ref.default_time_lag)
        assert hasattr(head, "mlp_fusion") == (key == "cape_t")


@functools.lru_cache(maxsize=None)
def meta_model(name):
    with torch.device("meta"):
        return Config(path=os.path.join(CFG, name + ".yml"),
                      device="meta").model


@pytest.mark.parametrize("name", CONFIGS)
def test_full_config_builds_with_jax_state(name):
    """The three CAPE configs through both packages' Config (the port's on
    the meta device): the state's names and shapes, load_jax_params
    filling every parameter and running stat from the JAX state's paths,
    the version, the head's settings and the parts."""
    path = os.path.join(CFG, name + ".yml")
    jm = nnx.eval_shape(lambda: JaxConfig(path=path).model)
    model = meta_model(name)
    shapes = abstract_shapes(jm)
    check_state_names(model, shapes)
    load_jax_params(model, {k: np.zeros(s, np.float32)
                            for k, s in shapes.items()})
    head = model.head
    assert model.version == jm.version == (1 if name.startswith("cape_r")
                                           else 2)
    assert (head.num_query, head.num_layers, head.depth_num,
            head.embed_dims, head.with_time, head.with_prev_aux_loss) == (
                jm.head.num_query, jm.head.num_layers, jm.head.depth_num,
                jm.head.embed_dims, jm.head.with_time,
                jm.head.with_prev_aux_loss)
    assert (model.dn_cfg is None) == (jm.dn_cfg is None) == (
        name == "cape_r50_1408x512")
    backbone = type(model.backbone).__name__
    assert backbone == ("VoVNet" if "v99" in name else "ResNet")
    if head.with_time:
        assert len(head.mlp_fusion) == head.num_layers == 6
        assert n_params(head.mlp_fusion) == 6 * (4 * 257 * 256 +
                                                 513 * 256 + 2 * 256 +
                                                 10 * 256 + 2 * 256)


# ------------------------------------------------------------------ head
def test_camera_frame_inputs_match_jax(ymls):
    """_camera_frame_inputs of the tiny CAPE head over three cameras and
    24 matching + 8 DN queries: the visibility masks equal (both values
    occur), the tokens, the camera-frame key and query embeddings and the
    lidar-frame query embedding within 1e-5."""
    jm, _, model = tiny(ymls["cape"])
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(2, CAMS, 2, 3, 16)).astype(np.float32)
    dn_ref = rng.uniform(0, 1, (2, 8, 3)).astype(np.float32)
    batch = serve_batch(4)
    ref = nnx.jit(lambda m, f, a, b, d: m._camera_frame_inputs(
        f, a, b, d))(jm.head, jnp.asarray(feats),
                     jnp.asarray(batch["img2lidars"]),
                     jnp.asarray(batch["lidar2cams"]), jnp.asarray(dn_ref))
    with torch.no_grad():
        got = model.head._camera_frame_inputs(
            torch.from_numpy(feats).permute(0, 1, 4, 2, 3),
            torch.from_numpy(batch["img2lidars"]),
            torch.from_numpy(batch["lidar2cams"]), torch.from_numpy(dn_ref))
    tokens, key_pos, q_pos_cam, visible, q_pos_global, refp = got
    np.testing.assert_array_equal(visible.numpy(), np.asarray(ref[3]))
    assert 0.2 < visible.mean() < 0.8
    assert tuple(visible.shape) == (2, CAMS, 32)
    for g, r in ((tokens, ref[0]), (key_pos, ref[1]), (q_pos_cam, ref[2]),
                 (q_pos_global, ref[4]), (refp, ref[5])):
        assert tuple(g.shape) == r.shape
        close(g.numpy(), np.asarray(r), 1e-5)


def test_mlp_fusion_matches_jax():
    """_MLPFusion (its ego-rotation gate) at 32 channels on two streams of
    7 queries and a rotation about a tilted axis."""
    jm, state = seeded_state(nnx.eval_shape(lambda: jax_cape._MLPFusion(
        32, rngs=nnx.Rngs(0))), 5)
    pm = cape_head._MLPFusion(32, torch.Generator().manual_seed(0))
    load_jax_params(pm, state)
    rng = np.random.default_rng(6)
    cur, prev = (rng.normal(size=(2, 7, 32)).astype(np.float32)
                 for _ in range(2))
    rot = np.stack([chip_smoke._small_rotation(rng, 0.3)
                    for _ in range(2)]).astype(np.float32)
    ref = jm(jnp.asarray(cur), jnp.asarray(prev), jnp.asarray(rot))
    with torch.no_grad():
        got = pm(*(torch.from_numpy(x) for x in (cur, prev, rot)))
    for g, r in zip(got, ref):
        close(g.numpy(), np.asarray(r), 1e-5)


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("case", ["cape", "cape_no_lidar2cams", "cape_t"])
def test_tiny_test_forward_matches_jax(case, ymls):
    """The tiny configs' test_forward: CAPE over three cameras, CAPE
    without lidar2cams (PETR's global decode), CAPE-T over two frames of
    three cameras (the streams fused after each layer, velocities over the
    default time lag)."""
    jm, _, model = tiny(ymls["cape_t" if case == "cape_t" else "cape"])
    batch = serve_batch(frames=2 if case == "cape_t" else 1)
    if case == "cape_no_lidar2cams":
        del batch["lidar2cams"]
    ref = jax.device_get(nnx.jit(lambda m, b: m.test_forward(b))(
        jm, to_jax(batch)))
    got = model.test_forward(to_torch(batch))
    assert set(got) == set(ref)
    assert tuple(got["box3d_lidar"].shape) == (2, 72, 9)
    np.testing.assert_array_equal(got["label_preds"].numpy(),
                                  ref["label_preds"])
    close(got["scores"].numpy(), ref["scores"], 1e-5)
    close(got["box3d_lidar"].numpy(), ref["box3d_lidar"], 1e-4)
    assert len(np.unique(ref["scores"])) == ref["scores"].size  # no ties


def test_camera_frame_decode_differs_from_the_global_one(ymls):
    """The per-camera decode is not PETR's: the same batch with and
    without lidar2cams gives other scores; and CAPE-T's velocities scale
    with the time lag."""
    _, _, model = tiny(ymls["cape"])
    batch = to_torch(serve_batch())
    with torch.no_grad():
        local = model.test_forward(batch)
        batch.pop("lidar2cams")
        glob = model.test_forward(batch)
    assert not torch.allclose(local["scores"], glob["scores"])
    _, _, temporal = tiny(ymls["cape_t"])
    head = temporal.head
    b = to_torch(serve_batch(frames=2))
    with torch.no_grad():
        feats = temporal._extract_feats(b["img"])
        half = head(feats, b["img2lidars"], b["lidar2cams"])[1]
        unit = head(feats, b["img2lidars"], b["lidar2cams"],
                    time_lag=1.0)[1]
    torch.testing.assert_close(half[..., 8:], 2 * unit[..., 8:], rtol=0,
                               atol=0)
    torch.testing.assert_close(half[..., :8], unit[..., :8], rtol=0, atol=0)


def test_cape_t_train_step_matches_jax_in_f64(ymls, monkeypatch):
    """The tiny CAPE-T's train_forward and its gradients in train mode,
    both sides in f64: two frames of three cameras, 3 DN groups with
    negatives behind the self-attention mask, the streams' fusion and the
    previous stream's aux loss. Every Hungarian assignment (the current
    stream's, then the previous one's, each layer and sample), the losses,
    every gradient and the running stats."""
    batch = train_batch()
    # each solve's cost, in the order train_step_case records the solves
    costs = {"jax": [], "port": []}

    def cost_recorder(side, solve):
        def rec(cost, valid):
            costs[side].append(np.array(cost))
            return solve(cost, valid)
        return rec
    monkeypatch.setattr(jax_ta, "_solve_host",
                        cost_recorder("jax", jax_ta._solve_host))
    monkeypatch.setattr(target_assigners, "_solve_host",
                        cost_recorder("port", target_assigners._solve_host))
    solves, got, want, model, ref, after = train_step_case(
        ymls["cape_t"], batch, monkeypatch)
    assert len(solves["port"]) == len(solves["jax"]) == 2 * 2 * 2
    # XLA may run the two losses' host solves in either order: pair each
    # of the port's solves (current stream, then previous) with the JAX
    # solve of the nearest cost
    for out, cost in zip(solves["port"], costs["port"]):
        errs = [np.abs(cost - c).max() for c in costs["jax"]]
        j = int(np.argmin(errs))
        assert errs[j] <= 1e-5 * np.abs(cost).max()
        np.testing.assert_array_equal(out, solves["jax"][j])
        assert sorted(errs)[1] > 1e-3          # one solve is the nearest
    keys = {"loss", "loss_cls", "loss_bbox", "loss_cls_dn", "loss_bbox_dn",
            "loss_cls_prev", "loss_bbox_prev"}
    assert set(got) == set(want) == keys
    for k in want:
        close(got[k].item(), want[k], 1e-7)
    assert set(ref) == {n for n, _ in model.named_parameters()}
    largest = max(v.abs().max().item() for v in ref.values())
    for name, p in model.named_parameters():
        err = (p.grad - ref[name]).abs().max().item()
        assert err <= 1e-5 * max(ref[name].abs().max().item(),
                                 1e-3 * largest), name
    assert model.head.mlp_fusion[0].ego.fc.weight.grad.abs().max() > 0
    assert model.head._prev_outputs is None
    sd = model.state_dict()
    for name, v in after.items():
        close(sd[name].numpy(), v.numpy(), 1e-12)


# ------------------------------------------------------------- the rig
def test_cape_rig_lift_is_the_camera_frame_frustum():
    """chip_smoke.cape_rig: lidar2cam @ img2lidar is the inverse of the
    unit-coordinate intrinsics, the same for both frames; a lidar point
    seen by a camera projects through the previous frame's cameras as the
    current ones would see it 0.5 m further along x."""
    i2l, l2c = chip_smoke.cape_rig(chip_smoke.PETR_HW, frames=2)
    _, ks = chip_smoke.bench_camera()._rig(None, 6)
    lift = l2c.astype(np.float64) @ i2l.astype(np.float64)
    # the 800-wide image's K for [0, 1] coordinates of a 320 x 800 image
    k_unit = np.diag([1 / 800, 1 / 320, 1.0]) @ ks[0]
    for c in range(12):
        np.testing.assert_allclose(lift[c][:3, :3] @ k_unit, np.eye(3),
                                   atol=1e-5)
        np.testing.assert_allclose(lift[c][:3, 3], 0, atol=1e-5)
        np.testing.assert_allclose(lift[c][3], [0, 0, 0, 1], atol=1e-6)
    p = np.array([20.0, 3.0, -1.0, 1.0])
    for c in range(6):
        np.testing.assert_allclose(l2c[6 + c] @ p,
                                   l2c[c] @ (p + [0.5, 0, 0, 0]), atol=1e-5)
