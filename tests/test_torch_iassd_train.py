"""Port parity of IA-SSD training against the JAX package.

One AdamWOnecycle step (clip 10, OneCycle: the KITTI config's optimizer,
configs/iassd/iassd_kitti.yml:72-83) of configs/iassd/iassd_synthetic_tiny.yml
(written to tmp with that optimizer), the JAX weights carried across at
their init, against the JAX step on its CPU XLA path (XLA farthest-point
sampling and ball query), from the same numpy batch. The batch holds a scan
whose gt row is all -1 labels (no foreground anywhere in it) and, in the
other scan, two gt boxes with the same BEV centre (an exact tie of the
nearest-gt assignment, broken to the first index as jnp.argmin breaks it)
but other sizes. Then the assignment alone on identical centres
(tests/test_torch_iassd.py holds that a CPU train step takes no kernel).

Which reference, and why. The step is compared in f64 on both sides (the
JAX state and batch cast to f64 under jax.enable_x64; the port's model and
batch cast with .double(); IA-SSD has no voxelization that an f64 copy of
the points could move). In f32 a relu whose input lies within rounding of 0
passes its gradient on one side only: the aggregation around the votes runs
256- to 1,024-wide layers over 1,024 grouped rows, and one or two such
inputs moved some grads by up to 1e-2 of their tensor's largest value, in
either framework against its own f64 step (JAX's f32 step lay 6e-5 from its
f64 one, the port's f32 step 1.7e-2). In f64 the two steps agree to ~1e-14.
So the f32 step is held to the JAX f64 losses alone.

Tolerances: the assignment (gt index and foreground) equal; the f64 step's
losses 1e-12 relative, grads 1e-12 of each tensor's largest value, running
stats 1e-12, each AdamW update within 1e-12 where the clipped grad is well
clear of zero and 1e-10 elsewhere (a first Adam step divides g by |g| + eps,
which near g = 0 magnifies the grads' last bits); the f32 step's losses
1e-5 relative (the votes lie ~20 m out, so each centre offset of the box
targets carries a few 1e-6 m of f32 rounding, and ~20 BN layers' sums
run in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import nnx

from paddle3d_tpu.apis.config import Config as JaxConfig
from paddle3d_tpu_torch.apis import Config, make_train_step
from paddle3d_tpu_torch.models.detection import IASSD
from paddle3d_tpu_torch.utils.convert import load_jax_params, to_torch_names
from tests.test_torch_iassd import TINY, flat_state

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small torch ops: intra-op threads only add fork-and-join time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def train_yml(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "iassd_tiny_train.yml"
    path.write_text(yaml.safe_dump({
        "_base_": TINY,
        "optimizer": {"_inherited_": False, "type": "AdamWOnecycle",
                      "weight_decay": 0.01, "grad_clip_norm": 10.0},
        "lr_scheduler": {"_inherited_": False, "type": "OneCycle",
                         "learning_rate": 0.01, "total_step": 100,
                         "pct_start": 0.4, "div_factor": 10}}))
    return str(path)


def make_batch(seed, b=2, n=1024, g=6):
    """Scans over the tiny config's range: ground returns and points on the
    gt boxes, NaN padding. Scan 0 has g boxes, its last two -1 padding, and
    box 1 repeats box 0's BEV centre with another size (an exact tie);
    scan 1's labels are all -1."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, g, 7), np.float32)
    boxes[..., :2] = rng.uniform([4, -12], [28, 12], (b, g, 2))
    boxes[..., 2] = rng.uniform(-1.8, -1.4, (b, g))
    boxes[..., 3:6] = rng.uniform([1.5, 3.5, 1.4], [2., 4.5, 1.7], (b, g, 3))
    boxes[..., 6] = rng.uniform(-3, 3, (b, g))
    boxes[0, 1, :2] = boxes[0, 0, :2]
    boxes[0, 1, 3:6] = [2.6, 5.8, 2.2]
    labels = np.zeros((b, g), np.int64)
    labels[0, -2:] = -1
    labels[1] = -1
    pts = rng.uniform([0, -16, -2, 0], [32, 16, -1.2, 1], (b, n, 4))
    k = n // 2
    pick = rng.integers(0, g, (b, k))
    pts[:, :k, :3] = np.take_along_axis(
        boxes[..., :3] + [0, 0, .8], pick[..., None], 1) + rng.normal(
            0, [.8, .5, .3], (b, k, 3))
    pts[:, -24:] = np.nan
    return {"data": pts.astype(np.float32), "gt_boxes": boxes,
            "gt_labels": labels}


def _f64(x):
    return x.astype(jnp.float64) if getattr(x, "dtype", None) == \
        jnp.float32 else x


@pytest.fixture(scope="module")
def step(train_yml):
    """One train step of each side from the same state, in f64 (see the
    module docstring): the JAX step (its grads by nnx.grad with the BN stats
    updated, then the optax update) and the port's make_train_step; then
    the port's f32 step from the same state."""
    batch = make_batch(0)
    with jax.enable_x64():
        jcfg = JaxConfig(path=train_yml)
        jax_model = jcfg.model
        jax_model.train()
        state0 = flat_state(jax_model)
        graphdef, state = nnx.split(jax_model)
        jax_model = nnx.merge(graphdef, jax.tree.map(_f64, state))
        jbatch = {k: _f64(jnp.asarray(v)) for k, v in batch.items()}

        @nnx.jit
        def grads_of(m, b):
            def loss_fn(m):
                losses = m.train_forward(b)
                return losses["loss"], losses
            return nnx.grad(loss_fn, has_aux=True)(m)

        grads, want = grads_of(jax_model, jbatch)
        nnx.Optimizer(jax_model, jcfg.optimizer, wrt=nnx.Param).update(
            jax_model, grads)
        clipped, _ = optax.clip_by_global_norm(10.).update(
            nnx.to_pure_dict(grads), None)
        want, after = jax.device_get(want), flat_state(jax_model)
    flat_clipped = {".".join(map(str, k)): np.asarray(v) for k, v in
                    nnx.traversals.flatten_mapping(clipped).items()}

    runs = {}
    for dtype in (torch.float64, torch.float32):
        cfg = Config(path=train_yml, device="cpu")
        model = cfg.model
        load_jax_params(model, state0)
        model.to(dtype).train()
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        for k in ("data", "gt_boxes"):
            tbatch[k] = tbatch[k].to(dtype)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        got = make_train_step(lr_scheduler=cfg.lr_scheduler)(
            model, cfg.optimizer, tbatch)
        runs[dtype] = (model, got, before)
    model, got, before = runs[torch.float64]
    return dict(model=model, got=got, got32=runs[torch.float32][1],
                want=want, grads=to_torch_names(model, flat_clipped),
                before=before, after=to_torch_names(model, after))


def close(got, ref, tol):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (err, tol)


def jax_assign(ctr, gt_b, gt_l):
    """The JAX train_forward's assign_one (iassd.py:202-214) on one scan."""
    d = jnp.linalg.norm(ctr[:, None, :2] - gt_b[None, :, :2], axis=-1)
    d = jnp.where((gt_l >= 0)[None, :], d, 1e9)
    gi = jnp.argmin(d, axis=1)
    radius = 0.5 * jnp.sqrt(gt_b[gi, 3] ** 2 + gt_b[gi, 4] ** 2)
    return gi, jnp.min(d, axis=1) < radius


def test_assignment_matches_jax():
    """Centres on the gt boxes, between them and on the tied pair: the
    nearest valid gt (ties to the first), foreground inside its
    circumscribed circle, none in the all -1 scan."""
    batch = make_batch(1)
    boxes, labels = batch["gt_boxes"], batch["gt_labels"]
    rng = np.random.default_rng(2)
    ctr = np.concatenate([
        boxes[:, :, :3] + rng.normal(0, 1., (2, 6, 3)),
        rng.uniform([0, -16, -2], [32, 16, 0], (2, 40, 3))], 1)
    ctr[0, :2, :2] = boxes[0, 0, :2]                   # on the tied pair
    ctr = ctr.astype(np.float32)
    gi, fg = IASSD._assign(torch.from_numpy(ctr), torch.from_numpy(boxes),
                           torch.from_numpy(labels))
    for s in range(2):
        rgi, rfg = jax_assign(jnp.asarray(ctr[s]), jnp.asarray(boxes[s]),
                              jnp.asarray(labels[s]))
        np.testing.assert_array_equal(gi[s].numpy(), np.asarray(rgi))
        np.testing.assert_array_equal(fg[s].numpy(), np.asarray(rfg))
    assert gi[0, 0] == 0 and gi[0, 1] == 0 and fg[0, :2].all()
    assert fg[0].sum() > 4 and not fg[1].any()


def test_train_step_losses_match_jax(step):
    """The three losses and their sum, f64 and f32; the box loss is taken
    over the foreground votes, which the tie and the all -1 scan leave."""
    want = step["want"]
    for got, tol in ((step["got"], 1e-12), (step["got32"], 1e-5)):
        assert set(got) == set(want) == {"loss", "loss_cls", "loss_box",
                                         "loss_sa"}
        for k in want:
            assert np.isfinite(got[k].item()) and float(want[k]) > 0, k
            np.testing.assert_allclose(got[k].item(), float(want[k]),
                                       rtol=tol, err_msg=k)


def test_train_step_grads_match_jax(step):
    """Every parameter's grad after the clip: the SA layers', the vote
    layer's (through the votes into the aggregation's grouping offsets and
    the box targets) and both heads'."""
    model, grads = step["model"], step["grads"]
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    for name, want in grads.items():
        assert np.abs(want.numpy()).max() > 0, name
        close(params[name].grad.numpy(), want.numpy(), 1e-12)
    assert np.abs(params["vote.ctr_reg.weight"].grad.numpy()).max() > 0


def test_train_step_state_matches_jax(step):
    """Every running stat after the step within 1e-12 of JAX's, and every
    AdamW update within 1e-12 of JAX's where the clipped grad is well clear
    of zero, 1e-10 elsewhere."""
    model, before, after = step["model"], step["before"], step["after"]
    state = model.state_dict()
    stats = [k for k in after if "running" in k]
    assert "ctr_agg.scale_mlps.1.layers.2.bn.running_var" in stats
    for name in stats:
        np.testing.assert_allclose(state[name].numpy(), after[name].numpy(),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    firm = total = 0
    for name, grad in step["grads"].items():
        p0 = before[name].numpy()
        got, want = state[name].numpy() - p0, after[name].numpy() - p0
        gap = np.abs(got - want)
        g = np.abs(grad.numpy())
        big = g >= max(1e-2 * g.max(), 1e-5)
        assert (gap[big] <= 1e-12).all(), (name, gap[big].max())
        assert (gap <= 1e-10).all(), (name, gap.max())
        firm, total = firm + big.sum(), total + g.size
    assert firm > 0.3 * total, (firm, total)
