"""Port parity of the PointPillars training slice against the JAX package:
the flax-convention BatchNorm, box encoding, target assignment, the losses,
the optimizer chain alone, and one whole train step on
configs/pointpillars/pointpillars_synthetic_tiny.yml (JAX make_train_step,
f32 on its XLA path, against the port's step on the plain versions).

Tolerances: running stats 1e-6 (BN alone and the whole step; the step
measured 1.1e-7); elementwise losses 1e-6; the loss dict 1e-5; the
optimizer alone 1e-6; grads 1e-4 of each tensor's largest magnitude (a
deep f32 backward in another order; measured 6.3e-6); params after the
step 2·lr (Adam's first update is ~lr·sign(g), so a tiny grad whose sign
differs moves a weight by up to 2·lr).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx
from torch import nn

from paddle3d_tpu.apis.config import Config as JaxConfig
from paddle3d_tpu.apis.pipeline import make_train_step as jax_train_step
from paddle3d_tpu.models.detection.pointpillars.target_assigner import \
    assign_targets as jax_assign
from paddle3d_tpu.models.layers.layer_libs import ConvBNReLU as JaxConv
from paddle3d_tpu.models.losses import weighted_loss as jax_losses
from paddle3d_tpu.ops import box_ops as jax_box_ops
from paddle3d_tpu_torch.apis import Config, make_train_step
from paddle3d_tpu_torch.models.detection.pointpillars import PointPillarsLoss
from paddle3d_tpu_torch.models.detection.pointpillars.target_assigner import \
    assign_targets
from paddle3d_tpu_torch.models.layers.layer_libs import ConvBNReLU
from paddle3d_tpu_torch.models.losses import weighted_loss
from paddle3d_tpu_torch.ops import box_ops
from paddle3d_tpu_torch.utils.convert import load_jax_params, to_torch_names

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "pointpillars",
                    "pointpillars_synthetic_tiny.yml")


def flat_state(module, kinds=(nnx.Param, nnx.BatchStat)):
    """nnx parameters and running stats as {dotted path: numpy array}."""
    return {".".join(map(str, k)): np.asarray(getattr(v, "value", v))
            for kind in kinds
            for k, v in nnx.state(module, kind).flat_state()}


def close(got, ref, tol):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (err, tol)


def test_bn_running_stats_follow_flax():
    """One train-mode forward of ConvBNReLU and its flax counterpart: the
    running stats agree within 1e-6; torch's own BatchNorm2d, which updates
    running_var with the unbiased variance, does not."""
    jax_mod = JaxConv(3, 5, 3, rngs=nnx.Rngs(0))
    rng = np.random.default_rng(0)
    bn = jax_mod.bn
    bn.mean.value = jnp.asarray(rng.normal(0, .2, 5), jnp.float32)
    bn.var.value = jnp.asarray(rng.uniform(.5, 2., 5), jnp.float32)
    bn.scale.value = jnp.asarray(rng.uniform(.5, 1.5, 5), jnp.float32)
    model = ConvBNReLU(3, 5, 3)
    load_jax_params(model, flat_state(jax_mod))
    plain = nn.BatchNorm2d(5, eps=1e-3, momentum=0.01)
    plain.load_state_dict(model.bn.state_dict())
    x = rng.normal(1., 2., (2, 8, 10, 3)).astype(np.float32)
    ref = np.asarray(jax_mod(jnp.asarray(x)))            # updates bn
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    out = model.train()(xt)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(), ref,
                               rtol=1e-5, atol=1e-5)
    for name, want in (("running_mean", bn.mean.value),
                       ("running_var", bn.var.value)):
        np.testing.assert_allclose(getattr(model.bn, name).numpy(),
                                   np.asarray(want), rtol=0, atol=1e-6)
    plain.train()(torch.nn.functional.conv2d(xt, model.conv.weight,
                                             padding=1))
    np.testing.assert_allclose(plain.running_mean.numpy(),
                               np.asarray(bn.mean.value), rtol=0, atol=1e-6)
    assert np.abs(plain.running_var.numpy() -
                  np.asarray(bn.var.value)).max() > 1e-6


def test_box_encode_matches_jax():
    rng = np.random.default_rng(1)
    anchors = np.concatenate([rng.uniform(-40, 40, (64, 3)),
                              rng.uniform(1, 4, (64, 3)),
                              rng.uniform(-3, 3, (64, 1))], -1)
    boxes = anchors + rng.normal(0, .3, anchors.shape)
    boxes[:4, 3] = -1.                                  # clamped sizes
    anchors, boxes = anchors.astype(np.float32), boxes.astype(np.float32)
    np.testing.assert_allclose(
        box_ops.second_box_encode(torch.from_numpy(boxes),
                                  torch.from_numpy(anchors)).numpy(),
        np.asarray(jax_box_ops.second_box_encode(boxes, anchors)),
        rtol=1e-6, atol=1e-6)


def make_gt(rng, b=2, g=6):
    """Car-sized boxes inside the tiny range, the last third padding."""
    boxes = np.zeros((b, g, 7), np.float32)
    boxes[..., 0] = rng.uniform(2, 30, (b, g))
    boxes[..., 1] = rng.uniform(-14, 14, (b, g))
    boxes[..., 2] = rng.uniform(-1.5, -.5, (b, g))
    boxes[..., 3:6] = rng.uniform([1.4, 3.5, 1.4], [1.8, 4.3, 1.7],
                                  (b, g, 3))
    boxes[..., 6] = rng.uniform(-4, 4, (b, g))           # wrapped first
    labels = np.zeros((b, g), np.int64)
    labels[:, -g // 3:] = -1
    return boxes, labels


def test_anchor_thresholds_and_assignment_match_jax():
    jax_model = JaxConfig(path=TINY).model
    model = Config(path=TINY, device="cpu").model
    jgen, gen = jax_model.anchor_generator, model.anchor_generator
    for name in ("anchors", "matched_thresholds", "unmatched_thresholds"):
        np.testing.assert_array_equal(getattr(gen, name),
                                      getattr(jgen, name))
    rng = np.random.default_rng(2)
    boxes, labels = make_gt(rng)
    # a gt exactly on an anchor: IoU 1, ties for its force match
    boxes[0, 0] = gen.anchors[400]
    mask = rng.uniform(size=(2, gen.anchors.shape[0])) > .2
    want = jax.vmap(lambda g, lab, m: jax_assign(
        jnp.asarray(gen.anchors), g, lab,
        jnp.asarray(gen.matched_thresholds),
        jnp.asarray(gen.unmatched_thresholds), m))(
            jnp.asarray(boxes), jnp.asarray(labels), jnp.asarray(mask))
    t = torch.from_numpy
    got = assign_targets(t(gen.anchors), t(boxes), t(labels),
                         t(gen.matched_thresholds),
                         t(gen.unmatched_thresholds), t(mask))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert (got[0] > 0).sum() > 4 and (got[0] == 0).any()
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-6)


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    b, a = 2, 500
    logits = rng.normal(0, 2, (b, a, 1)).astype(np.float32)
    onehot = (rng.uniform(size=(b, a, 1)) > .9).astype(np.float32)
    w = rng.uniform(0, 1, (b, a)).astype(np.float32)
    box = rng.normal(0, .5, (b, a, 7)).astype(np.float32)
    tgt = rng.normal(0, .5, (b, a, 7)).astype(np.float32)
    dirs = rng.normal(0, 1, (b, a, 2)).astype(np.float32)
    dlab = rng.integers(0, 2, (b, a))
    t = torch.from_numpy
    cases = [
        (weighted_loss.SigmoidFocalClassificationLoss(),
         jax_losses.SigmoidFocalClassificationLoss(), (logits, onehot, w)),
        (weighted_loss.WeightedSmoothL1RegressionLoss(
            code_weights=[1., 1., 2., 1., 1., 1., .5]),
         jax_losses.WeightedSmoothL1RegressionLoss(
             code_weights=[1., 1., 2., 1., 1., 1., .5]), (box, tgt, w)),
        (weighted_loss.WeightedSmoothL1RegressionLoss(codewise=False),
         jax_losses.WeightedSmoothL1RegressionLoss(codewise=False),
         (box, tgt, w)),
        (weighted_loss.WeightedSoftmaxClassificationLoss(),
         jax_losses.WeightedSoftmaxClassificationLoss(), (dirs, dlab, w)),
    ]
    for port, ref, args in cases:
        np.testing.assert_allclose(
            port(*map(t, args)).numpy(),
            np.asarray(ref(*map(jnp.asarray, args))), rtol=1e-6, atol=1e-6)

    jax_model = JaxConfig(path=TINY).model
    loss = Config(path=TINY, device="cpu").model.loss
    assert isinstance(loss, PointPillarsLoss)
    labels = rng.choice([-1, 0, 1], (b, a), p=[.1, .7, .2])
    anchors = rng.normal(0, 1, (a, 7)).astype(np.float32)
    args = (box, logits, tgt, labels, dirs, anchors)
    want = jax_model.loss(*map(jnp.asarray, args))
    got = loss(*map(t, args))
    assert set(got) == set(want) == {"loss", "loss_cls", "loss_reg",
                                     "loss_dir"}
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5)


def test_optimizer_chain_matches_optax(tmp_path):
    """Identical grads into the optax chain of the JAX Config's optimizer
    and into the port's, three steps across a StepDecay boundary, the
    first above the clip norm."""
    cfg_path = tmp_path / "opt.yml"
    cfg_path.write_text("_base_: {}\nlr_scheduler:\n  step_size: 2\n"
                        .format(TINY))
    tx = JaxConfig(path=str(cfg_path)).optimizer
    cfg = Config(path=str(cfg_path), device="cpu")
    model = cfg.model
    optimizer, scheduler = cfg.optimizer, cfg.lr_scheduler
    params = {k: p.detach().numpy().copy()
              for k, p in model.named_parameters()}
    state = tx.init(params)
    rng = np.random.default_rng(4)
    for i, scale in enumerate((1.0, 1e-3, 1e-2)):
        grads = {k: (rng.normal(0, scale, v.shape)).astype(np.float32)
                 for k, v in params.items()}
        if i == 0:
            assert np.sqrt(sum((g ** 2).sum() for g in grads.values())) > 10
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[k])
        optimizer.step()
        scheduler.step()
    assert optimizer.param_groups[0]["lr"] == pytest.approx(0.002 * 0.8)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                   rtol=0, atol=1e-6)


def make_batch(seed):
    """Tiny-config scans (ground plus car-sized clusters, out-of-range
    padding rows) and gt boxes on some of the clusters. NaN padding would
    do for the port, but the JAX package's XLA train path lets NaN rows
    into its BN batch statistics."""
    rng = np.random.default_rng(seed)
    b, n = 2, 1024
    pts = rng.uniform([0, -16, -2, 0], [32, 16, 2, 1], (b, n, 4))
    boxes, labels = make_gt(rng)
    k = n // 2
    pick = rng.integers(0, 4, (b, k))
    pts[:, :k, :2] = np.take_along_axis(boxes[..., :2], pick[..., None], 1)
    pts[:, :k, :2] += rng.normal(0, [0.6, 1.2], (b, k, 2))
    pts[:, -8:, 0] = 100.
    return {"data": pts.astype(np.float32), "gt_boxes": boxes,
            "gt_labels": labels}


@pytest.fixture(scope="module")
def train_step_pair():
    """One step of each side from the same state: JAX make_train_step, its
    grads (a value_and_grad from a clone), and the port's step."""
    jcfg = JaxConfig(path=TINY)
    jax_model = jcfg.model
    jax_model.train()
    state0 = flat_state(jax_model)
    batch = make_batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    @nnx.jit
    def grads_of(m, b):
        def loss_fn(m):
            losses = m.train_forward(b)
            return losses["loss"], losses
        return nnx.grad(loss_fn, has_aux=True)(m)

    grads, _ = grads_of(nnx.clone(jax_model), jbatch)
    clipped, _ = optax.clip_by_global_norm(10.).update(
        nnx.to_pure_dict(grads), None)
    losses = jax_train_step()(
        jax_model, nnx.Optimizer(jax_model, jcfg.optimizer, wrt=nnx.Param),
        jbatch)

    cfg = Config(path=TINY, device="cpu")
    model = cfg.model
    load_jax_params(model, state0)
    step = make_train_step(lr_scheduler=cfg.lr_scheduler)
    got = step(model.train(), cfg.optimizer,
               {k: torch.from_numpy(v) for k, v in batch.items()})
    flat_clipped = {".".join(map(str, k)): np.asarray(v) for k, v in
                    nnx.traversals.flatten_mapping(clipped).items()}
    return dict(model=model, got=got, want=jax.device_get(losses),
                grads=to_torch_names(model, flat_clipped),
                after=to_torch_names(model, flat_state(jax_model)))


def test_train_step_losses_match_jax(train_step_pair):
    got, want = train_step_pair["got"], train_step_pair["want"]
    assert set(got) == set(want) == {"loss", "loss_cls", "loss_reg",
                                     "loss_dir"}
    for k in want:
        assert np.isfinite(got[k].item())
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5)
    assert float(want["loss_reg"]) > 0          # the gt found anchors


def test_train_step_grads_match_jax(train_step_pair):
    model, grads = train_step_pair["model"], train_step_pair["grads"]
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    for name, want in grads.items():
        assert np.abs(want.numpy()).max() > 0, name
        close(params[name].grad.numpy(), want.numpy(), 1e-4)


def test_train_step_state_matches_jax(train_step_pair):
    """Every running stat after the step, and every parameter within
    2·lr of JAX's."""
    model, after = train_step_pair["model"], train_step_pair["after"]
    state = model.state_dict()
    stats = [k for k in after if "running" in k]
    assert len(stats) == 2 * sum(isinstance(m, nn.modules.batchnorm._BatchNorm)
                                 for m in model.modules())
    for name, want in after.items():
        tol = 1e-6 if "running" in name else 2 * 0.002
        np.testing.assert_allclose(state[name].numpy(), want.numpy(),
                                   rtol=tol, atol=tol, err_msg=name)


def test_train_step_refuses_amp_and_ema_and_parses_losses():
    """AMP O1 / O2 raise (item 15). EMA, once refused, is ported: the step
    takes (model, optimizer, ema, batch, decay) and returns (losses, ema),
    the shadow moved to decay * ema + (1 - decay) * param."""
    from paddle3d_tpu_torch.apis import parse_losses
    from paddle3d_tpu_torch.utils.ema import init_ema
    for kw, item in ((dict(amp_level="O2"), "bf16"),
                     (dict(amp_level="O1"), "bf16")):
        with pytest.raises(NotImplementedError, match=item):
            make_train_step(**kw)
    lin = nn.Linear(2, 1)
    lin.train_forward = lambda b: (lin(b["x"]) ** 2).mean()
    ema = init_ema(lin)
    before = {k: v.clone() for k, v in ema.items()}
    step = make_train_step(ema_decay=0.999)
    losses, out = step(lin, torch.optim.SGD(lin.parameters(), lr=1.),
                       ema, {"x": torch.ones(3, 2)}, 0.25)
    assert set(losses) == {"loss"} and out is ema
    for k, p in lin.named_parameters():
        assert torch.equal(ema[k], 0.25 * before[k] + 0.75 * p.detach())
        assert not torch.equal(ema[k], before[k])
    one, two = torch.tensor(1.), torch.tensor(2.)
    assert parse_losses({"loss": one, "loss_cls": two}) is one
    assert parse_losses({"a": one, "b": two}).item() == 3.
    assert parse_losses(two) is two


def test_train_step_nan_padding_equals_out_of_range_padding():
    """collate_lidar pads a batch with NaN points: one train step of the
    tiny config on make_batch's scans with the padding rows NaN gives the
    losses, grads and running stats of the same scans padded out of range,
    bit for bit (both are dropped by the same sentinel key; the port's
    plain versions on the CPU), and they are finite."""
    import chip_smoke
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # small ops: no fork-and-join an op
    try:
        runs = _nan_and_far_steps(chip_smoke)
    finally:
        torch.set_num_threads(threads)
    (l1, g1, s1), (l2, g2, s2) = runs
    assert all(torch.isfinite(v) for v in l1.values())
    for a, b in ((l1, l2), (g1, g2), (s1, s2)):
        assert set(a) == set(b)
        assert all(chip_smoke.same_bits(a[k], b[k]) for k in a)


def _nan_and_far_steps(chip_smoke):
    """One step on make_batch(1) with its padding rows NaN, and one on it
    as it is (x = 100 m), from one state: -> [(losses, grads, stats)] x 2."""
    cfg = Config(path=TINY, device="cpu")
    model, optimizer, scheduler = cfg.model.train(), cfg.optimizer, \
        cfg.lr_scheduler
    step = make_train_step(lr_scheduler=scheduler)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(1).items()}
    nan = dict(batch, data=batch["data"].clone())
    nan["data"][:, -8:] = float("nan")
    restore = chip_smoke.saved_state(model, optimizer, scheduler)
    runs = []
    for b in (nan, batch):
        losses = step(model, optimizer, b)
        runs.append((losses, {n: p.grad.clone()
                              for n, p in model.named_parameters()},
                     {k: v.clone() for k, v in model.state_dict().items()
                      if "running" in k}))
        restore()
    return runs
