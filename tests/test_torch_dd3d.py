"""Port parity of DD3D: the DLA-34 trunk with the "bn" norm (DLABase34),
FPN with extra convs on the input and the P6 / P7 top blocks, FPNC, SGD,
a tiny DD3D end to end (serving, and one train step) and the two KITTI
configs' state, on the CPU against the JAX package, with inputs made from
a seed by numpy.

The JAX models are built abstractly (nnx.eval_shape) and filled from a
seed by numpy (tests/test_torch_petr.py's seeded_state);
utils/convert.load_jax_params carries the state across (the DLA BN's
scale, bias and running stats, the GroupNorm towers, the heads, the bare
depth_scales parameter, the top blocks' convs). The tiny DD3D is
tests/models/test_dd3d.py's (ResNet-18 at base 8 to C3-C5, FPN to 16, a
one-conv tower, two classes, 16 detections a level).

Tolerances and why:
  * DLABase34 in eval mode (after .eval(): the running averages, as the
    JAX package's model.eval() gives them): 1e-5 of the largest value (CPU
    convolutions summed in other orders); in train mode in f64, 1e-10,
    the running stats 1e-10 (flax's fast variance E[x^2] - E[x]^2);
  * FPN, the top blocks and FPNC: 1e-5 of the largest value;
  * SGD with OneCycle: parameters 1e-6 of optax's after five updates;
  * test_forward: labels equal, scores 1e-5 and boxes 1e-4 of the largest
    value (GroupNorm's fast variance in flax, two passes in torch);
  * the train step in f64 on both sides: losses 1e-9 of their value,
    gradients 1e-8 of each tensor's largest value.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from paddle3d_tpu.apis.config import Config as JaxConfig
from paddle3d_tpu.models.backbones import ResNet as JaxResNet
from paddle3d_tpu.models.backbones import dla as jax_dla
from paddle3d_tpu.models.detection import DD3D as JaxDD3D
from paddle3d_tpu.models.necks import fpn as jax_fpn
from paddle3d_tpu.models.optimizers.optimizers import OneCycle as JaxOneCycle
from paddle3d_tpu.models.optimizers.optimizers import SGD as JaxSGD
from paddle3d_tpu_torch.apis import Config
from paddle3d_tpu_torch.models.backbones import DLABase34, ResNet
from paddle3d_tpu_torch.models.detection import DD3D
from paddle3d_tpu_torch.models.necks import (FPN, FPNC, LastLevelP6,
                                             LastLevelP6P7)
from paddle3d_tpu_torch.models.optimizers import SGD, OneCycle
from paddle3d_tpu_torch.utils.convert import load_jax_params, to_torch_names
from tests.test_torch_petr import (abstract_shapes, check_state_names, close,
                                   flat_state, nchw, nhwc, seeded_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "dd3d")
HW = (64, 96)
K = np.array([[60., 0, 48.], [0, 60., 32.], [0, 0, 1.]])


def as_dtype(module, dt):
    graphdef, st = nnx.split(module)
    return nnx.merge(graphdef, jax.tree.map(
        lambda x: x.astype(dt) if x.dtype == jnp.float32 else x, st))


# ------------------------------------------------------------------ DLA
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_dla_bn_trunk_matches_jax(mode):
    """DLABase34 with norm_type "frozen_bn" (read as "bn"): the three
    levels at strides 8, 16, 32 of a 2 x 64 x 96 batch, in train mode
    (batch statistics, the running stats updated; f64) and after .eval()
    (the running averages; f32)."""
    jm, state = seeded_state(nnx.eval_shape(lambda: jax_dla.DLABase34(
        norm_type="frozen_bn", rngs=nnx.Rngs(0))), 1)
    model = DLABase34(norm_type="frozen_bn")
    load_jax_params(model, state)
    x = np.random.default_rng(2).normal(size=(2,) + HW + (3,))
    train = mode == "train"
    getattr(jm, mode)()
    getattr(model, mode)()
    with jax.enable_x64(train):
        dt = jnp.float64 if train else jnp.float32
        jm = as_dtype(jm, dt)
        ref = [np.asarray(r) for r in nnx.jit(lambda m, x: m(x))(
            jm, jnp.asarray(x, dt))]
        stats = flat_state(jm)
    if train:
        model.double()
    got = model(nchw(x.astype(np.float64 if train else np.float32)))
    assert [tuple(g.shape) for g in got] == [(2, 128, 8, 12),
                                             (2, 256, 4, 6), (2, 512, 2, 3)]
    assert model.out_channels == [128, 256, 512]
    for g, r in zip(got, ref):
        close(nhwc(g), r, 1e-10 if train else 1e-5)
    if train:
        after = to_torch_names(model, {k: v for k, v in stats.items()
                                       if k.endswith((".mean", ".var"))})
        sd = model.state_dict()
        assert len(after) == 2 * sum(
            1 for m in model.modules()
            if isinstance(m, torch.nn.BatchNorm2d))
        for name, v in after.items():
            close(sd[name].numpy(), v.numpy(), 1e-10)


# ------------------------------------------------------------------ FPN
FPN_CASES = {
    # DD3D V-99's neck at its widths: two inputs, one extra conv on the
    # last input
    "on_input": dict(in_channels=[768, 1024], out_channels=256, num_outs=3,
                     add_extra_convs="on_input"),
    # DLA-34's three levels, the P6 / P7 top block on P5
    "p6p7": dict(in_channels=[128, 256, 512], out_channels=32,
                 top_block="p6p7"),
    # the top block on the last input ("res5")
    "p6_res": dict(in_channels=[16, 32], out_channels=8, top_block="p6"),
}


def fpn_inputs(chans, seed=3):
    rng = np.random.default_rng(seed)
    h, w = 10, 13            # odd: flax's SAME pads a stride-2 conv (1, 1)
    return [rng.normal(size=(2, h >> i, (w >> i) + 1, c)).astype(np.float32)
            for i, c in enumerate(chans)]


@pytest.mark.parametrize("case", list(FPN_CASES))
def test_fpn_extra_convs_and_top_blocks_match_jax(case):
    """FPN with add_extra_convs "on_input" (V-99's shape), with
    LastLevelP6P7 on P5 and with LastLevelP6 on the last input; odd and
    even map sizes (flax SAME padding of the stride-2 top blocks)."""
    kw = dict(FPN_CASES[case])
    top = kw.pop("top_block", None)
    cout = kw["out_channels"]

    def build(jax_side):
        mods = (jax_fpn.FPN, jax_fpn.LastLevelP6, jax_fpn.LastLevelP6P7) \
            if jax_side else (FPN, LastLevelP6, LastLevelP6P7)
        extra = {"rngs": nnx.Rngs(0)} if jax_side else {}
        block = None
        if top == "p6p7":
            block = mods[2](cout, cout, **extra)
        elif top == "p6":
            block = mods[1](kw["in_channels"][-1], cout, in_feature="res5",
                            **extra)
        return mods[0](top_block=block, **kw, **extra)
    jm, state = seeded_state(nnx.eval_shape(lambda: build(True)), 4)
    model = build(False)
    load_jax_params(model, state)
    xs = fpn_inputs(kw["in_channels"])
    ref = nnx.jit(lambda m, xs: m(xs))(jm, [jnp.asarray(x) for x in xs])
    got = model([nchw(x) for x in xs])
    assert len(got) == len(ref) == {"on_input": 3, "p6p7": 5,
                                    "p6_res": 3}[case]
    for g, r in zip(got, ref):
        close(nhwc(g), np.asarray(r), 1e-5)


def test_fpnc_matches_jax():
    """FPNC: three levels to 16 channels, the coarser two upsampled
    bilinearly to the finest, fused by a 3 x 3 conv to 24."""
    jm, state = seeded_state(nnx.eval_shape(lambda: jax_fpn.FPNC(
        [16, 32, 64], 16, fuse_channels=24, rngs=nnx.Rngs(0))), 5)
    model = FPNC([16, 32, 64], 16, fuse_channels=24)
    load_jax_params(model, state)
    rng = np.random.default_rng(6)
    xs = [rng.normal(size=(2, 12 >> i, 20 >> i, c)).astype(np.float32)
          for i, c in enumerate((16, 32, 64))]
    ref = nnx.jit(lambda m, xs: m(xs))(jm, [jnp.asarray(x) for x in xs])
    got = model([nchw(x) for x in xs])
    assert len(got) == 1 and tuple(got[0].shape) == (2, 24, 12, 20)
    assert model.out_channels == 24
    close(nhwc(got[0]), np.asarray(ref[0]), 1e-5)


def test_sgd_onecycle_match_optax():
    """SGD (clip 10) under OneCycle over 4 steps, five updates (the first
    above the clip) on two tensors, against the JAX package's optax
    chain; the DLA config's optimizer as its YAML sets it."""
    ref = JaxOneCycle(0.002, 4)
    sched = OneCycle(0.002, 4)
    tx = JaxSGD(ref, grad_clip_norm=10.0)
    rng = np.random.default_rng(7)
    params = {k: rng.normal(size=shape).astype(np.float32)
              for k, shape in (("a", (7, 5)), ("b", (11,)))}
    mine = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for k, v in params.items()}
    optimizer = SGD(sched, grad_clip_norm=10.0)(list(mine.values()))
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, sched.factor)
    state = tx.init(params)
    update = jax.jit(tx.update)
    for scale in (30., 1e-2, 1., 1e-1, 3.):
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
    with torch.device("meta"):
        cfg = Config(path=os.path.join(CFG, "dd3d_dla34_kitti.yml"),
                     device="meta")
        opt = cfg.optimizer
    assert type(opt) is torch.optim.SGD
    # the schedule's value at update 0: the peak over div_factor
    assert opt.param_groups[0]["lr"] == pytest.approx(float(
        JaxOneCycle(0.002, 25000)(0)))


# ---------------------------------------------------------------- model
def build_tiny(jax_side):
    """tests/models/test_dd3d.py's DD3D in either package."""
    if jax_side:
        kw = {"rngs": nnx.Rngs(0)}
        res, fpn, dd3d = JaxResNet, jax_fpn.FPN, JaxDD3D
    else:
        kw = {}
        res, fpn, dd3d = ResNet, FPN, DD3D
    return dd3d(res(depth=18, base_channels=8, out_indices=(1, 2, 3), **kw),
                fpn(in_channels=[16, 32, 64], out_channels=16, **kw),
                num_classes=2, in_channels=16, feat_channels=16,
                num_convs=1, strides=(8, 16, 32),
                size_ranges=((0, 32), (32, 64), (64, 1e8)),
                depth_ref=(15., 8.),
                dim_ref=DIM_REF, max_detection=16, score_threshold=0.1, **kw)


DIM_REF = ((3.88, 1.63, 1.53), (0.8, 1.7, 0.7))


@pytest.fixture(scope="module")
def tiny():
    jm, state = seeded_state(nnx.eval_shape(lambda: build_tiny(True)), 0)
    # a plain array attribute, not an nnx variable: eval_shape left its
    # shape only
    jm.dim_ref = jnp.asarray(DIM_REF, jnp.float32)
    model = build_tiny(False)
    load_jax_params(model, state)
    return jm, state, model


def dd3d_batch(seed=0, b=2):
    """Images in [0, 255]; three gt slots a frame (the third padded in
    frame 0, all three set in frame 1), two nested boxes sharing pixels, a
    truncated box past the image's left edge (large enough for the
    coarsest level's range), K_inv of a 60-pixel focal length."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (b,) + HW + (3,)).astype(np.float32)
    gt2d = np.zeros((b, 3, 4), np.float32)
    gt2d[0, :2] = [[10, 10, 40, 40], [50, 20, 90, 60]]
    gt2d[1] = [[-40, 4, 90, 60], [20, 16, 44, 40], [62, 8, 94, 30]]
    gt3d = np.zeros((b, 3, 7), np.float32)
    gt3d[..., :3] = rng.uniform([-3, 1, 8], [3, 2, 25], (b, 3, 3))
    gt3d[..., 3:6] = rng.uniform([1.4, 1.5, 3.5], [1.7, 1.8, 4.2], (b, 3, 3))
    gt3d[..., 6] = rng.uniform(-3, 3, (b, 3))
    labels = np.array([[0, 1, -1], [1, 0, 1]], np.int64)[:b]
    return {"data": img, "gt_boxes_2d": gt2d, "gt_boxes_cam": gt3d,
            "gt_labels": labels,
            "K_inv": np.broadcast_to(np.linalg.inv(K), (b, 3, 3)).astype(
                np.float32).copy()}


def to_jax(batch, dt=jnp.float32):
    return {k: jnp.asarray(v, dt) if v.dtype == np.float32 else
            jnp.asarray(v.astype(np.int32)) for k, v in batch.items()}


def to_torch(batch, dt=torch.float32):
    return {k: torch.from_numpy(v).to(dt) if v.dtype == np.float32 else
            torch.from_numpy(v) for k, v in batch.items()}


def test_tiny_test_forward_matches_jax(tiny):
    """test_forward (three levels' top 16 of h * w * 2 scores, the
    unprojection through K_inv, arctan2) against the JAX model's."""
    jm, _, model = tiny
    jm.eval()
    model.eval()
    # a threshold inside the seeded scores' range, so that some are cut
    jm.score_threshold = model.score_threshold = 0.3
    batch = dd3d_batch()
    serve = {k: batch[k] for k in ("data", "K_inv")}
    ref = jax.device_get(nnx.jit(lambda m, b: m.test_forward(b))(
        jm, to_jax(serve)))
    got = model.test_forward(to_torch(serve))
    assert set(got) == set(ref)
    assert tuple(got["box3d_cam"].shape) == (2, 16 + 16 + 12, 7)
    np.testing.assert_array_equal(got["label_preds"].numpy(),
                                  ref["label_preds"])
    close(got["scores"].numpy(), ref["scores"], 1e-5)
    close(got["box3d_cam"].numpy(), ref["box3d_cam"], 1e-4)
    assert (ref["scores"] > 0).any() and (ref["scores"] < 0).any()


def test_tiny_train_step_matches_jax_in_f64(tiny):
    """train_forward (the FCOS assignment, the focal, smooth-L1,
    centerness and 3-D losses) in train mode: losses and every gradient
    against the JAX step's, both in f64."""
    jm, state, _ = tiny
    batch = dd3d_batch(1)
    with jax.enable_x64():
        jm64 = as_dtype(jm, jnp.float64)
        jm64.train()

        @nnx.jit
        def grads_of(m, b):
            def loss_fn(m):
                losses = m.train_forward(b)
                return losses["loss"], losses
            return nnx.grad(loss_fn, has_aux=True)(m)

        grads, want = jax.device_get(grads_of(jm64, to_jax(
            batch, jnp.float64)))
    model = build_tiny(False)
    load_jax_params(model, state)
    model.double().train()
    got = model.train_forward(to_torch(batch, torch.float64))
    got["loss"].backward()
    assert set(got) == set(want) == {"loss", "loss_cls", "loss_box2d",
                                     "loss_ctr", "loss_3d"}
    for key in want:
        close(got[key].item(), want[key], 1e-9)
    assert want["loss_3d"] > 0 and want["loss_ctr"] > 0
    ref = to_torch_names(model, {
        ".".join(map(str, k)): np.asarray(v[...])
        for k, v in nnx.state(grads, nnx.Param).flat_state()})
    assert set(ref) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        close(p.grad.numpy(), ref[name].numpy(), 1e-8)
    assert np.abs(ref["depth_scales"].numpy()).min() > 0


def test_dd3d_refusals(tiny):
    _, _, model = tiny
    model.train()
    with pytest.raises(RuntimeError, match="eval"):
        model.test_forward(to_torch({k: v for k, v in dd3d_batch().items()
                                     if k in ("data", "K_inv")}))
    # postprocess_to_samples, once refused (item 5), is ported: no meta,
    # no sample
    assert DD3D.postprocess_to_samples(
        {"box3d_cam": np.zeros((0, 4, 7)), "scores": np.zeros((0, 4)),
         "label_preds": np.zeros((0, 4))}, []) == []


# --------------------------------------------------------------- configs
@pytest.mark.parametrize("name", ["dd3d_dla34_kitti", "dd3d_v2_99_kitti"])
def test_config_builds_with_jax_state(name):
    """Both KITTI configs through both packages' Config, the port's on the
    meta device: the parameter count and every state name and shape, and
    the strides, ranges and neck outputs."""
    path = os.path.join(CFG, name + ".yml")
    jm = nnx.eval_shape(lambda: JaxConfig(path=path).model)
    with torch.device("meta"):
        model = Config(path=path, device="meta").model
    check_state_names(model, abstract_shapes(jm))
    assert model.strides == jm.strides
    assert model.size_ranges == jm.size_ranges
    assert (model.num_classes, model.max_detection, model.score_threshold,
            model.depth_ref) == (jm.num_classes, jm.max_detection,
                                 jm.score_threshold, jm.depth_ref)
    assert len(model.tower) == 4
    assert len(model.neck.extra_convs) == (1 if "v2_99" in name else 0)
