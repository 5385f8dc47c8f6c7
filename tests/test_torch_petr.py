"""Port parity of PETR and PETRv2, the third and fourth camera models: the
port's VoVNet-99-eSE, CPFPN, decoder layer, full-width PETRHead, Hungarian
match, query denoising, BEV segmentation head, the tiny config end to end
(serving, and one train step of v1 and of v2 with denoising) and AdamW with
CosineDecay, on the CPU against the JAX package, with inputs made from a
seed by numpy.

The JAX models are built abstractly (nnx.eval_shape) and filled from a
seed by numpy (seeded_state); utils/convert.load_jax_params carries the
state across (nnx.MultiHeadAttention's [in, heads, head_dim] kernels, the
LayerNorms' scale, the bare reference_points and time_embed parameters).
The cameras are chip_smoke.petr_rig's: tools/bench_camera.py's six-camera
ring with its intrinsics for [0, 1] image coordinates.

Tolerances and why:
  * feature maps (VoVNet, CPFPN): 1e-5 of the largest value; CPU
    convolutions summed in other orders;
  * the decoder layer and the head's class and box outputs: 1e-5 of the
    largest value; matmuls summed in other orders, XLA's fast-variance
    LayerNorm (E[x²] - E[x]²) against torch's two-pass one; the decoded
    scores 1e-5, boxes 1e-4 of the largest value, labels equal;
  * hungarian_match, dn_attn_mask, the DN queries' labels and masks:
    equal; the DN reference points 1e-7 (an f32 division);
  * the train steps in f64 on both sides (the model, batch and draws), so
    that no cost lies within rounding of another at the Hungarian solve
    (both sides round the cost to f32 before it, as the JAX package
    does): every layer's assignment equal. The attention's softmax runs
    in f32 on both sides, as jax.nn.dot_product_attention runs it, and
    XLA's and torch's f32 exp round differently (~1e-7 of a weight), so:
    losses 1e-7 relative (measured 2e-9), grads 1e-5 of the larger of
    their tensor's largest value and 1e-3 of the step's largest grad
    (measured 1e-6; the floor covers the grads no loss reaches, which are
    that rounding alone: the first self-attention's query and key, whose
    values are all zero, and the key biases and the position encoder's
    last bias, which the softmax takes away), running stats 1e-12;
  * AdamW and CosineDecay: parameters 1e-6 of optax's after five updates.
"""
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
import yaml
from flax import nnx

import chip_smoke
from paddle3d_tpu.apis.config import Config as JaxConfig
from paddle3d_tpu.models.backbones import vovnet as jax_vovnet
from paddle3d_tpu.models.heads import denoising as jax_dn
from paddle3d_tpu.models.heads import petr_head as jax_petr_head
from paddle3d_tpu.models.heads import petr_seg_head as jax_seg_head
from paddle3d_tpu.models.heads import target_assigners as jax_ta
from paddle3d_tpu.models.necks import fpn as jax_fpn
from paddle3d_tpu.models.optimizers.optimizers import \
    CosineDecay as JaxCosineDecay
from paddle3d_tpu.models.transformers import transformer_layers as jax_tl
from paddle3d_tpu_torch.apis import Config, make_train_step
from paddle3d_tpu_torch.models.backbones import VoVNet
from paddle3d_tpu_torch.models.detection import PETR
from paddle3d_tpu_torch.models.heads import (PETRHead, PETRSegHead,
                                             denoising, target_assigners)
from paddle3d_tpu_torch.models.necks import CPFPN
from paddle3d_tpu_torch.models.optimizers import CosineDecay
from paddle3d_tpu_torch.models.transformers import (BaseTransformerLayer,
                                                    MultiHeadAttention)
from paddle3d_tpu_torch.utils.convert import load_jax_params, to_torch_names

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "petr")
TINY = os.path.join(CFG, "petr_synthetic_tiny.yml")
CONFIGS = ["petr_vovnet_gridmask_p4_800x320",
           "petrv2_vovnet_gridmask_p4_800x320",
           "petrv2_dn_vovnet_gridmask_p4_800x320",
           "petrv2_BEVseg_800x320", "petr_synthetic_tiny"]
H, W, CAMS = 32, 48, 2          # the tiny config's images and cameras


def _leaf(path):
    return [k.key for k in path if hasattr(k, "key")]


def seeded_state(abstract, seed):
    """Fill an nnx.eval_shape'd module from numpy: kernels uniform
    ±1/sqrt(fan_in) (an attention projection's fan: its input features),
    norm scales and variances near 1, reference points uniform in [0, 1),
    the rest small; an Rngs' key and count concrete. -> (module, {dotted
    path: array})."""
    rng = np.random.default_rng(seed)
    graphdef, params, stats, rest = nnx.split(abstract, nnx.Param,
                                              nnx.BatchStat, ...)

    def fill(path, v):
        keys = _leaf(path)
        leaf, shape = keys[-1], v.shape
        u = rng.random(shape, dtype=np.float32)
        if leaf == "kernel":
            fan = shape[0] if (len(shape) == 3 and keys[-2] in (
                "query", "key", "value")) else np.prod(shape[:-1])
            a = (2 * u - 1) / np.sqrt(fan)
        elif leaf in ("scale", "var"):
            a = u + 0.5
        elif leaf == "reference_points":
            a = u
        else:                                   # bias, mean, time_embed
            a = (u - 0.5) / 5
        return jnp.asarray(a.astype(v.dtype))

    def concrete(v):
        if jax.dtypes.issubdtype(v.dtype, jax.dtypes.prng_key):
            return jax.random.key(0)
        return jnp.zeros(v.shape, v.dtype)

    params = jax.tree_util.tree_map_with_path(fill, params)
    stats = jax.tree_util.tree_map_with_path(fill, stats)
    rest = jax.tree.map(concrete, rest)
    module = nnx.merge(graphdef, params, stats, rest)
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


def views_nchw(x):
    """[B, N, h, w, C] numpy -> [B, N, C, h, w] torch."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 1, 4, 2, 3)


def serve_batch(seed=0, b=2, frames=1):
    rng = np.random.default_rng(seed)
    n = CAMS * frames
    cams = chip_smoke.petr_rig((H, W), CAMS, frames)[0]
    return {"img": rng.uniform(0, 255, (b, n, H, W, 3)).astype(np.float32),
            "img2lidars": np.broadcast_to(cams, (b, n, 4, 4)).copy()}


def train_batch(seed=1, frames=1):
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
    """The tiny config on both sides (ResNet-18 at base 8, CPFPN to 16
    channels, a 2-layer head of 32 channels and 24 queries over 8 LID
    bins), the seeded JAX state carried across; both in eval mode."""
    jm, state = jax_model(TINY)
    jm.eval()
    model = Config(path=TINY, device="cpu").model
    load_jax_params(model, state)
    return jm, state, model.eval()


# ---------------------------------------------------------------- configs
@functools.lru_cache(maxsize=None)
def meta_model(name):
    with torch.device("meta"):
        return Config(path=os.path.join(CFG, name + ".yml"),
                      device="meta").model


def n_params(module):
    return sum(p.numel() for p in module.parameters())


@pytest.fixture(scope="module")
def vovnet99():
    """VoVNet-99-eSE on both sides, the seeded JAX state carried across."""
    jm, state = seeded_state(nnx.eval_shape(lambda: jax_vovnet.VoVNet(
        spec_name="V-99-eSE", rngs=nnx.Rngs(0))), 3)
    pm = VoVNet(spec_name="V-99-eSE")
    load_jax_params(pm, state)
    return jm, state, pm


FULL_HEAD = dict(num_classes=10, in_channels=256, embed_dims=256,
                 num_query=900, num_heads=8, num_layers=6, depth_num=64,
                 depth_start=1.0,
                 position_range=[-61.2, -61.2, -10.0, 61.2, 61.2, 10.0],
                 pc_range=[-51.2, -51.2, -5.0, 51.2, 51.2, 3.0],
                 code_size=10,
                 code_weights=[1.0] * 8 + [0.2] * 2)


@pytest.fixture(scope="module")
def full_head():
    """The PETR configs' PETRHead at full width on both sides, the seeded
    JAX state carried across."""
    jm, state = seeded_state(nnx.eval_shape(
        lambda: jax_petr_head.PETRHead(rngs=nnx.Rngs(0), **FULL_HEAD)), 9)
    pm = PETRHead(**FULL_HEAD)
    load_jax_params(pm, state)
    return jm, state, pm


def abstract_shapes(module):
    return {".".join(map(str, k)): v.get_value().shape
            for kind in (nnx.Param, nnx.BatchStat)
            for k, v in nnx.state(module, kind).flat_state()}


def check_state_names(model, shapes):
    """The port model's parameter count is the JAX state's, and every torch
    parameter and running stat is named by a JAX state path with its
    shape."""
    assert n_params(model) == sum(
        int(np.prod(s)) for k, s in shapes.items()
        if k.split(".")[-1] not in ("mean", "var"))
    names = to_torch_names(model, {k: np.zeros(s, np.float32)
                                   for k, s in shapes.items()})
    assert set(names) == {k for k in model.state_dict()
                          if not k.endswith("num_batches_tracked")}


def test_tiny_config_builds_with_jax_state_names():
    """The tiny config through both packages' Config: the state's names
    and shapes, the version and the head's settings."""
    jm = nnx.eval_shape(lambda: JaxConfig(path=TINY).model)
    model = meta_model("petr_synthetic_tiny")
    check_state_names(model, abstract_shapes(jm))
    assert model.version == jm.version == 1 and model.seg_head is None
    mine, ref = model.head, jm.head
    assert (mine.num_query, mine.num_layers, mine.depth_num, mine.embed_dims,
            mine.num_classes, mine.code_size, mine.position_range,
            mine.pc_range) == (ref.num_query, ref.num_layers, ref.depth_num,
                               ref.embed_dims, ref.num_classes,
                               ref.code_size, ref.position_range,
                               ref.pc_range)


def test_bevseg_config_state_is_the_jax_parts(vovnet99, full_head):
    """PETRv2-BEVseg, which holds every part of the full-width configs,
    in the port on the meta device: its state is the JAX VoVNet-99's, a
    CPFPN 768 / 1024 -> 256's, the full-width head's, a 256-query seg
    head's and the time embedding, by name and shape."""
    seg_kw = {k: v for k, v in FULL_HEAD.items()
              if k not in ("num_classes", "num_query", "code_weights")}
    parts = {"backbone": vovnet99[0], "head": full_head[0],
             "neck": nnx.eval_shape(lambda: jax_fpn.CPFPN(
                 [768, 1024], 256, 2, rngs=nnx.Rngs(0))),
             "seg_head": nnx.eval_shape(lambda: jax_seg_head.PETRSegHead(
                 num_classes=3, bev_size=(256, 256), patch_size=16,
                 rngs=nnx.Rngs(0), **seg_kw))}
    shapes = {"time_embed": (2, 256)}
    for prefix, module in parts.items():
        shapes.update({prefix + "." + k: v
                       for k, v in abstract_shapes(module).items()})
    check_state_names(meta_model("petrv2_BEVseg_800x320"), shapes)


def test_full_width_configs_build():
    """The four full-width configs in the port on the meta device: v1; v2
    adds the two-frame time embedding alone; v2 + DN builds v2's model with
    the DN settings; v2-BEVseg adds the seg head (256 patch queries of 16 x
    16 x 3) to v2."""
    v1, v2, dn, seg = (meta_model(n) for n in CONFIGS[:4])
    assert (v1.version, v2.version, dn.version, seg.version) == (1, 2, 2, 2)
    assert n_params(v2) == n_params(v1) + 2 * 256 == n_params(dn)
    assert n_params(seg) == n_params(v2) + n_params(seg.seg_head)
    assert tuple(dn.dn_cfg) == (3, 0.4, 0.2, True) and v2.dn_cfg is None
    assert (seg.seg_head.num_query, seg.seg_head.patch_size) == (256, 16)
    assert type(v1.backbone).__name__ == "VoVNet" and v1.backbone.remat
    assert v1.head.num_query == 900 and v1.head.depth_num == 64


# ---------------------------------------------------------------- layers
def test_vovnet99_matches_jax(vovnet99):
    """VoVNet-99-eSE (every block shape of the PETR configs: 3 + 9 + 3
    identity blocks, the eSE gates, the stage pools) on one 64 x 96 image,
    eval mode: stage4 and stage5."""
    jm, _, pm = vovnet99
    jm.eval()
    img = np.random.default_rng(4).uniform(0, 1, (1, 64, 96, 3)).astype(
        np.float32)
    ref = nnx.jit(lambda m, x: m(x))(jm, jnp.asarray(img))
    with torch.no_grad():
        got = pm.eval()(nchw(img))
    assert [tuple(g.shape) for g in got] == [(1, 768, 4, 6), (1, 1024, 2, 3)]
    for g, r in zip(got, ref):
        close(nhwc(g), np.asarray(r), 1e-5)


def test_cpfpn_matches_jax_at_odd_sizes():
    """CPFPN at the tiny config's sizes (2 x 3 and 1 x 2: a resize by 2
    and 1.5): jax.image.resize's "nearest" is torch's "nearest-exact"."""
    jm, state = seeded_state(nnx.eval_shape(lambda: jax_fpn.CPFPN(
        [32, 64], 16, 2, rngs=nnx.Rngs(0))), 5)
    pm = CPFPN([32, 64], 16, 2)
    load_jax_params(pm, state)
    rng = np.random.default_rng(6)
    xs = [rng.normal(size=(2, 2, 3, 32)).astype(np.float32),
          rng.normal(size=(2, 1, 2, 64)).astype(np.float32)]
    ref = jm([jnp.asarray(x) for x in xs])
    with torch.no_grad():
        got = pm([nchw(x) for x in xs])
        up = pm.lateral_convs[1](nchw(xs[1]))
    for g, r in zip(got, ref):
        close(nhwc(g), np.asarray(r), 1e-5)
    assert not torch.equal(F.interpolate(up, size=(2, 3), mode="nearest"),
                           F.interpolate(up, size=(2, 3),
                                         mode="nearest-exact"))


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "dn_mask"])
def test_decoder_layer_matches_jax(masked):
    """One BaseTransformerLayer (self-attention, norm, cross-attention,
    norm, FFN, norm) at 32 channels and 4 heads, without and with the DN
    attention mask (5 matching queries, 2 groups of 4)."""
    def build(rngs):
        return jax_tl.BaseTransformerLayer(
            attns=[jax_tl.MultiHeadAttention(32, 4, rngs=rngs)
                   for _ in range(2)],
            embed_dims=32, feedforward_channels=128, rngs=rngs)
    jm, state = seeded_state(nnx.eval_shape(lambda: build(nnx.Rngs(0))), 7)
    pm = BaseTransformerLayer(
        attns=[MultiHeadAttention(32, 4) for _ in range(2)], embed_dims=32,
        feedforward_channels=128)
    load_jax_params(pm, state)
    rng = np.random.default_rng(8)
    q, qp = (rng.normal(size=(2, 13, 32)).astype(np.float32)
             for _ in range(2))
    k, kp = (rng.normal(size=(2, 30, 32)).astype(np.float32)
             for _ in range(2))
    mask = jax_dn.dn_attn_mask(5, 2, 4) if masked else None
    ref = jm(jnp.asarray(q), key=jnp.asarray(k), value=jnp.asarray(k),
             query_pos=jnp.asarray(qp), key_pos=jnp.asarray(kp),
             attn_masks=mask)
    t = torch.from_numpy
    with torch.no_grad():
        got = pm(t(q), key=t(k), value=t(k), query_pos=t(qp),
                 key_pos=t(kp), attn_masks=None if mask is None else
                 denoising.dn_attn_mask(5, 2, 4))
    close(got.numpy(), np.asarray(ref), 1e-5)
    if masked:
        # the mask changes the result: a matching query sees no DN query
        with torch.no_grad():
            free = pm(t(q), key=t(k), value=t(k), query_pos=t(qp),
                      key_pos=t(kp))
        assert not torch.allclose(free, got)


def test_full_width_head_matches_jax(full_head):
    """The PETR config's PETRHead at full width (256 channels, 900
    queries, 6 layers, 8 heads, 64 LID bins, 10 classes) over 6 cameras of
    2 x 3 tokens under the rig: every layer's class and box outputs, and
    the decode."""
    jm, _, pm = full_head
    rng = np.random.default_rng(10)
    feats = rng.normal(size=(1, 6, 2, 3, 256)).astype(np.float32)
    cams = chip_smoke.petr_rig(chip_smoke.PETR_HW)[0][None]
    ref = nnx.jit(lambda m, f, c: m(f, c))(jm, jnp.asarray(feats),
                                           jnp.asarray(cams))
    with torch.no_grad():
        got = pm(views_nchw(feats), torch.from_numpy(cams))
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        close(g.numpy(), np.asarray(r), 1e-5)
    # the decode on the same head outputs, with exact ties: query 700's
    # class logits copied from query 5's (a stable sort keeps the lower
    # index first, as jax.lax.top_k)
    cls, bbox = (np.array(r) for r in ref)
    cls[-1, :, 700] = cls[-1, :, 5]
    want = jax.device_get(jm.predict(jnp.asarray(cls), jnp.asarray(bbox)))
    pred = pm.predict(torch.from_numpy(cls), torch.from_numpy(bbox))
    assert tuple(pred["box3d_lidar"].shape) == (1, 300, 9)
    for k in ("label_preds", "scores"):
        np.testing.assert_array_equal(pred[k].numpy(), want[k])
    close(pred["box3d_lidar"].numpy(), want["box3d_lidar"], 1e-7)


def test_hungarian_match_equals_jax():
    """hungarian_match on the same f32 cost arrays: a batch with padded gt
    columns, a sample with no gt, more gt than... none, and costs with
    exact ties; indices equal to the JAX per-sample match."""
    rng = np.random.default_rng(11)
    cost = rng.normal(size=(3, 40, 6)).astype(np.float32)
    cost[2, :, :] = np.round(cost[2], 1)       # many equal costs
    valid = np.ones((3, 6), bool)
    valid[0, 4:] = False
    valid[1] = False
    got = target_assigners.hungarian_match(torch.from_numpy(cost),
                                           torch.from_numpy(valid))
    for s in range(3):
        ref = jax_ta.hungarian_match(jnp.asarray(cost[s]),
                                     jnp.asarray(valid[s]))
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(ref))
    assert (got[1] == -1).all() and (got[0] >= 0).sum() == 4


def jax_draws(key, b, g, num_classes, cfg):
    """The draws the JAX build_dn_queries makes from `key`, in its order
    (denoising.py:75, 88, 99-100), as the port's draws dict."""
    reps = cfg.groups * (2 if cfg.negative else 1)

    def draw(key):
        k_center, k_label, k_flip = jax.random.split(key, 3)
        return (jax.random.uniform(k_center, (b, reps, g, 3), minval=-1.,
                                   maxval=1.),
                jax.random.uniform(k_flip, (b, reps, g)) <
                cfg.label_noise_ratio,
                jax.random.randint(k_label, (b, reps, g), 0, num_classes))
    u, flip, lab = (np.array(v) for v in jax.jit(draw)(key))
    return {"u": torch.from_numpy(u), "flip": torch.from_numpy(flip),
            "labels": torch.from_numpy(lab.astype(np.int64))}


def test_dn_queries_mask_and_loss_match_jax():
    """build_dn_queries on the JAX draws (a padded gt slot, a zero draw
    for the negatives' sign), dn_attn_mask and dn_loss."""
    cfg = denoising.DenoisingConfig(groups=3, box_noise_scale=0.4,
                                    label_noise_ratio=0.4, negative=True)
    batch = train_batch(3)
    boxes, labels = batch["gt_boxes"], batch["gt_labels"]
    pc = [-10., -10., -3., 10., 10., 3.]
    key = jax.random.key(5)
    ref = jax.jit(lambda k, b, lab: jax_dn.build_dn_queries(
        k, b, lab, 3, pc, jax_dn.DenoisingConfig(*cfg)))(
            key, jnp.asarray(boxes), jnp.asarray(labels))
    draws = jax_draws(key, 2, 4, 3, cfg)
    got = denoising.build_dn_queries(torch.from_numpy(boxes),
                                     torch.from_numpy(labels), 3, pc, cfg,
                                     draws=draws)
    assert draws["flip"].any() and not draws["flip"].all()
    for k in ("labels", "pos", "valid", "gt_idx"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    close(got["ref"].numpy(), ref["ref"], 1e-7)
    assert (got["group_size"], got["groups"]) == (ref["group_size"],
                                                 ref["groups"])
    np.testing.assert_array_equal(
        denoising.dn_attn_mask(24, 3, 8).numpy(),
        np.asarray(jax_dn.dn_attn_mask(24, 3, 8)))
    rng = np.random.default_rng(12)
    dn_cls = rng.normal(size=(2, 2, 24, 3)).astype(np.float32)
    dn_box = rng.normal(size=(2, 2, 24, 10)).astype(np.float32)
    gt_enc = rng.normal(size=(2, 4, 10)).astype(np.float32)
    cw = [1.0] * 8 + [0.2] * 2
    want = jax.jit(lambda c, b, m, g: jax_dn.dn_loss(c, b, m, g, cw, 3))(
        jnp.asarray(dn_cls), jnp.asarray(dn_box),
        {k: v for k, v in ref.items() if k not in ("groups", "group_size")}
        | {"groups": 3, "group_size": 8}, jnp.asarray(gt_enc))
    out = denoising.dn_loss(torch.from_numpy(dn_cls),
                            torch.from_numpy(dn_box), got,
                            torch.from_numpy(gt_enc), cw, 3)
    for g, w in zip(out, want):
        close(g.item(), float(w), 1e-6)


def test_seg_head_forward_and_loss_match_jax():
    """PETRSegHead at bev_size 32 (4 patch queries of 16 x 16 x 3) over 2
    cameras of 2 x 3 tokens: logits, the balanced BCE and dice losses,
    and its unused PETRHead parts carried across."""
    kw = dict(num_classes=3, bev_size=(32, 32), patch_size=16,
              in_channels=16, embed_dims=32, num_heads=4, num_layers=2,
              depth_num=8, position_range=[-12., -12., -4., 12., 12., 4.],
              pc_range=[-10., -10., -3., 10., 10., 3.])
    jm, state = seeded_state(nnx.eval_shape(
        lambda: jax_seg_head.PETRSegHead(rngs=nnx.Rngs(0), **kw)), 13)
    pm = PETRSegHead(**kw)
    load_jax_params(pm, state)
    rng = np.random.default_rng(14)
    feats = rng.normal(size=(2, 2, 2, 3, 16)).astype(np.float32)
    cams = np.broadcast_to(chip_smoke.petr_rig((H, W), CAMS)[0],
                           (2, 2, 4, 4)).copy()
    gt = (rng.random((2, 32, 32, 3)) < 0.3).astype(np.float32)
    ref = nnx.jit(lambda m, f, c, g: (m(f, c), m.loss(m(f, c), g)))(
        jm, jnp.asarray(feats), jnp.asarray(cams), jnp.asarray(gt))
    with torch.no_grad():
        logits = pm(views_nchw(feats), torch.from_numpy(cams))
        losses = pm.loss(logits, torch.from_numpy(gt))
    assert tuple(logits.shape) == (2, 32, 32, 3)
    close(logits.numpy(), np.asarray(ref[0]), 1e-5)
    assert set(losses) == set(ref[1])
    for k in losses:
        close(losses[k].item(), float(ref[1][k]), 1e-6)
    # load_jax_params still refuses a state that leaves a parameter
    # unfilled: here the bare reference_points
    with pytest.raises(KeyError, match="reference_points"):
        load_jax_params(PETRSegHead(**kw), {
            k: v for k, v in state.items() if k != "reference_points"})


# ------------------------------------------------------------------ model
def test_tiny_test_forward_matches_jax(tiny):
    jm, _, model = tiny
    batch = serve_batch()
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


def test_petr_refuses_train_mode_serving(tiny):
    _, _, model = tiny
    model.train()
    try:
        with pytest.raises(RuntimeError, match="eval"):
            model.test_forward(to_torch(serve_batch()))
    finally:
        model.eval()
    # postprocess_to_samples, once refused (item 5), is ported: no meta,
    # no sample
    assert PETR.postprocess_to_samples(
        {"box3d_lidar": np.zeros((0, 4, 9)), "scores": np.zeros((0, 4)),
         "label_preds": np.zeros((0, 4))}, []) == []


@pytest.fixture(scope="module")
def dn_yml(tmp_path_factory):
    """The tiny config as PETRv2 with query denoising (3 groups with
    negatives), two frames of one camera each."""
    path = tmp_path_factory.mktemp("cfg") / "petrv2_dn_tiny.yml"
    path.write_text(yaml.safe_dump({
        "_base_": TINY,
        "model": {"version": 2,
                  "dn_config": {"groups": 3, "box_noise_scale": 0.4,
                                "label_noise_ratio": 0.4,
                                "negative": True}}}))
    return str(path)


def _f64(x):
    return x.astype(jnp.float64) if hasattr(x, "dtype") and \
        x.dtype == jnp.float32 else x


def train_step_case(path, batch, monkeypatch):
    """One train forward and backward of each side in f64 from the same
    seeded state: every Hungarian solve's assignment, the losses, the
    grads and the running stats after the step, of the JAX model and the
    port."""
    jm, state = jax_model(path, seed=21)
    jm.train()
    dn_key = jax.random.key(17)
    solves = {"jax": [], "port": []}

    def recorder(side, solve):
        def rec(cost, valid):
            out = solve(cost, valid)
            solves[side].append(np.array(out))
            return out
        return rec

    monkeypatch.setattr(jax_ta, "_solve_host",
                        recorder("jax", jax_ta._solve_host))
    monkeypatch.setattr(target_assigners, "_solve_host",
                        recorder("port", target_assigners._solve_host))
    # the JAX step draws its DN noise from a known key; the port is handed
    # the same draws
    build = jax_dn.build_dn_queries
    monkeypatch.setattr(jax_dn, "build_dn_queries",
                        lambda key, *a, **k: build(dn_key, *a, **k))
    with jax.enable_x64():
        graphdef, st = nnx.split(jm)
        jm64 = nnx.merge(graphdef, jax.tree.map(_f64, st))

        @nnx.jit
        def grads_of(m, b):
            def loss_fn(m):
                losses = m.train_forward(b)
                return losses["loss"], losses
            return nnx.grad(loss_fn, has_aux=True)(m)

        grads, want = jax.device_get(grads_of(jm64, to_jax(batch,
                                                           jnp.float64)))
        stats = flat_state(jm64)
        draws = None
        if getattr(jm, "dn_cfg", None) is not None:
            draws = jax_draws(dn_key, *batch["gt_labels"].shape,
                              jm.head.num_classes, jm.dn_cfg)
    model = Config(path=path, device="cpu").model
    load_jax_params(model, state)
    model.double().train()
    if draws is not None:
        model.dn_draws = lambda b, g: draws
    got = model.train_forward(to_torch(batch, torch.float64))
    got["loss"].backward()
    ref = to_torch_names(model, {
        ".".join(map(str, k)): np.asarray(v[...])
        for k, v in nnx.state(grads, nnx.Param).flat_state()})
    after = to_torch_names(model, {k: v for k, v in stats.items()
                                   if k.endswith((".mean", ".var"))})
    return solves, got, want, model, ref, after


@pytest.mark.parametrize("case", ["v1", "v2_dn"])
def test_tiny_train_step_matches_jax_in_f64(case, dn_yml, monkeypatch):
    """train_forward and its gradients, in train mode, both sides in f64:
    the tiny config (v1), and the tiny config as PETRv2 with query
    denoising (two frames, the time embedding, 3 DN groups with negatives
    behind the self-attention mask). The assignments first (every layer,
    every sample), then the losses, every gradient and the running
    stats."""
    path = TINY if case == "v1" else dn_yml
    batch = train_batch(frames=1 if case == "v1" else 2)
    if case == "v2_dn":                     # one camera a frame
        batch["img"] = batch["img"][:, [0, 2]]
        batch["img2lidars"] = batch["img2lidars"][:, [0, 2]]
    solves, got, want, model, ref, after = train_step_case(path, batch,
                                                           monkeypatch)
    assert len(solves["port"]) == len(solves["jax"]) == 2 * 2  # L x B
    for a, b in zip(solves["port"], solves["jax"]):
        np.testing.assert_array_equal(a, b)
    assert sum((a >= 0).sum() for a in solves["port"]) == 2 * 7
    keys = {"loss", "loss_cls", "loss_bbox"}
    if case == "v2_dn":
        keys |= {"loss_cls_dn", "loss_bbox_dn"}
    assert set(got) == set(want) == keys
    for k in want:
        close(got[k].item(), want[k], 1e-7)
    assert set(ref) == {n for n, _ in model.named_parameters()}
    largest = max(v.abs().max().item() for v in ref.values())
    for name, p in model.named_parameters():
        err = (p.grad - ref[name]).abs().max().item()
        assert err <= 1e-5 * max(ref[name].abs().max().item(),
                                 1e-3 * largest), name
    sd = model.state_dict()
    for name, v in after.items():
        close(sd[name].numpy(), v.numpy(), 1e-12)


# ------------------------------------------------------------- the rig
def test_petr_rig_is_bench_cameras_ring_for_unit_coordinates():
    """chip_smoke.petr_rig at 320 x 800: tools/bench_camera.py's ring
    (_rig and build_batch's lidar2img), its image coordinates divided by
    the image size; the previous frame's cameras 0.5 m behind."""
    bc = chip_smoke.bench_camera()
    batch = bc.build_batch("petr", None, type("Cfg", (), {"dic": {}})(),
                           np.random.default_rng(0))
    cams, l2i = chip_smoke.petr_rig(chip_smoke.PETR_HW, frames=2)
    pixel = np.linalg.inv(batch["img2lidars"][0])        # lidar -> pixels
    np.testing.assert_allclose(l2i, pixel, rtol=1e-6, atol=1e-9)
    p = np.array([20.0, 3.0, -1.0, 1.0])
    for c in range(6):
        unit = np.linalg.inv(cams[c].astype(np.float64)) @ p
        pix = pixel[c] @ p
        np.testing.assert_allclose(unit[:2] / unit[2],
                                   pix[:2] / pix[2] / [800, 320], rtol=1e-5)
        # the previous frame sees the current frame's point p where the
        # current cameras would see p + 0.5 m along x
        prev = np.linalg.inv(cams[6 + c].astype(np.float64)) @ p
        ahead = np.linalg.inv(cams[c].astype(np.float64)) @ (
            p + [0.5, 0, 0, 0])
        np.testing.assert_allclose(prev[:3], ahead[:3], rtol=1e-5)


def test_petr_gt_boxes_are_in_range_and_in_view():
    """chip_smoke.petr_gt: 8 boxes a frame inside the configs' pc_range,
    each centre in some camera's image, then two -1 padded slots."""
    boxes, labels = chip_smoke.petr_gt(np.random.default_rng(3), 2,
                                       chip_smoke.PETR_HW, 10)
    assert boxes.shape == (2, 10, 9) and labels.shape == (2, 10)
    assert (labels[:, :8] >= 0).all() and (labels[:, 8:] == -1).all()
    assert not boxes[:, 8:].any()
    real = boxes[:, :8]
    assert (np.abs(real[..., :2]) < 51.2).all()
    assert ((real[..., 2] > -5) & (real[..., 2] + real[..., 5] < 3)).all()
    l2i = chip_smoke.petr_rig(chip_smoke.PETR_HW)[1]
    ctr = np.concatenate([real[..., :2], real[..., 2:3] + real[..., 5:6] / 2,
                          np.ones_like(real[..., :1])], -1).reshape(-1, 4)
    p = np.einsum("cij,nj->nci", l2i, ctr)
    uv = p[..., :2] / p[..., 2:3]
    seen = (p[..., 2] > 0) & (uv >= 0).all(-1) & (uv < [800, 320]).all(-1)
    assert seen.any(axis=1).all()


# --------------------------------------------------------------- optimizer
def test_adamw_cosine_decay_match_optax():
    """AdamW (decay 0.01, clip 35) under a CosineDecay with eta_min over 4
    steps, five updates (the first above the clip, the last past
    total_step) on three tensors: the parameters against the JAX package's
    optax chain; the schedule at 0, 2 and past the end; the tiny config's
    optimizer and schedule as its YAML sets them."""
    from paddle3d_tpu.models.optimizers.optimizers import AdamW as JaxAdamW
    from paddle3d_tpu_torch.models.optimizers import AdamW
    ref = JaxCosineDecay(0.002, 4, eta_min=0.0001)
    sched = CosineDecay(0.002, 4, eta_min=0.0001)
    tx = JaxAdamW(ref, weight_decay=0.01, grad_clip_norm=35.0)
    rng = np.random.default_rng(4)
    params = {k: rng.normal(size=shape).astype(np.float32)
              for k, shape in (("a", (7, 5)), ("b", (11,)), ("c", (3, 4, 2)))}
    mine = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for k, v in params.items()}
    optimizer = AdamW(sched, weight_decay=0.01, grad_clip_norm=35.0)(
        list(mine.values()))
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, sched.factor)
    state = tx.init(params)
    update = jax.jit(tx.update)
    for scale in (30., 1e-2, 1e-3, 1e-2, 1e-1):
        grads = {k: rng.normal(0, scale, v.shape).astype(np.float32)
                 for k, v in params.items()}
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for k, p in mine.items():
            p.grad = torch.from_numpy(grads[k])
        optimizer.step()
        scheduler.step()
    for k, p in mine.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    for step in (0, 2, 4, 9):
        assert sched.learning_rate * sched.factor(step) == pytest.approx(
            float(ref(step)), rel=1e-6)
    assert sched.learning_rate * sched.factor(9) == pytest.approx(0.0001)
    assert math.isclose(sched.factor(0), 1.0)
    cfg = Config(path=TINY, device="cpu")
    opt = cfg.optimizer
    assert isinstance(opt, torch.optim.AdamW)
    assert opt.param_groups[0]["lr"] == pytest.approx(0.001)
    assert opt.param_groups[0]["weight_decay"] == 0.01
    for _ in range(6):
        cfg.lr_scheduler.step()
    assert opt.param_groups[0]["lr"] == pytest.approx(0.0005)
