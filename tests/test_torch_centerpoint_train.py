"""Port parity of CenterPoint-pillars training against the JAX package.

One train step of a tiny two-layer config (centerpoint_synthetic_tiny.yml
with the nuScenes config's shape of PFN: two layers, 5 input channels; two
tasks of 1 and 2 classes, a velocity head; written to tmp) against the JAX
step on its CPU XLA path (in f64, see run_steps), the same converted
weights and numpy batch: the
port runs the multi-layer train canvas (the segmented window max, K12, on
its plain version), the gaussian target generator, the CenterNet losses and
Adam with its clip. One step of the one-layer centerpoint_synthetic_tiny.yml
goes through the one-layer train canvas (K3 / K1 / K7 plain versions).
Then the target generator on the nuScenes config's six tasks, the losses
on identical predictions, OneCycleAdam with its schedules against the optax
chain, and the port's repaired faults: a dropped grad_clip_norm, test_forward
in train mode, the voxel cap of the entry point, a bare-tensor loss.

Tolerances: losses 1e-5 relative, grads 1e-4 of each tensor's largest value
(a deep f32 backward in another order), running stats 1e-6, parameters
after the step 2·lr (Adam's first update is ~lr·sign(g)); targets equal
(heatmaps 1e-6: exp rounds by one ulp apart), regression targets 1e-6;
losses on identical predictions 1e-6 relative; the optimizer alone 1e-6.
Batches pad points with out-of-range rows: the JAX XLA train path lets NaN
rows into its BN statistics.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import nnx
from torch import nn

import bench
from paddle3d_tpu.apis.config import Config as JaxConfig
from paddle3d_tpu.models.detection.centerpoint.centerpoint_target import \
    CenterPointTargetGenerator as JaxTargets
from paddle3d_tpu.models.losses import centernet_loss as jax_losses
from paddle3d_tpu_torch.apis import Config, make_train_step
from paddle3d_tpu_torch.models.detection.centerpoint import \
    CenterPointTargetGenerator
from paddle3d_tpu_torch.models.losses import centernet_loss
from paddle3d_tpu_torch.utils.convert import load_jax_params, to_torch_names

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "centerpoint",
                    "centerpoint_synthetic_tiny.yml")
NUSCENES = os.path.join(REPO, "configs", "centerpoint",
                        "centerpoint_pillars_02voxel_nuscenes_10sweep.yml")
LR = 0.002          # the tiny config's StepDecay rate


def flat_state(module, kinds=(nnx.Param, nnx.BatchStat)):
    return {".".join(map(str, k)): np.asarray(getattr(v, "value", v))
            for kind in kinds
            for k, v in nnx.state(module, kind).flat_state()}


def close(got, ref, tol):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (err, tol)


@pytest.fixture(scope="module")
def two_layer_yml(tmp_path_factory):
    with open(TINY) as f:
        dic = yaml.safe_load(f)
    model = dic["model"]
    model["voxel_encoder"].update(in_channels=5, feat_channels=[16, 16])
    model["middle_encoder"]["in_channels"] = 16
    model["backbone"]["in_channels"] = 16
    head = model["bbox_head"]
    head["tasks"] = [dict(num_class=1, class_names=["car"]),
                     dict(num_class=2, class_names=["truck", "bus"])]
    head["common_heads"]["vel"] = [2, 2]
    head["code_weights"] = [1.0] * 8 + [0.2, 0.2]
    path = tmp_path_factory.mktemp("cfg") / "centerpoint_tiny_2l.yml"
    path.write_text(yaml.safe_dump(dic))
    return str(path)


def make_batch(seed, channels, classes, g=6):
    """Tiny-range scans (ground plus clusters on the gt boxes, some pillars
    over P points), gt boxes with velocity columns when 5 channels come,
    the last third of the labels -1, out-of-range padding rows."""
    rng = np.random.default_rng(seed)
    b, n = 2, 1024
    dim = 9 if channels == 5 else 7
    boxes = np.zeros((b, g, dim), np.float32)
    boxes[..., 0] = rng.uniform(2, 30, (b, g))
    boxes[..., 1] = rng.uniform(-14, 14, (b, g))
    boxes[..., 2] = rng.uniform(-1.5, -.5, (b, g))
    boxes[..., 3:6] = rng.uniform([1.4, 3.5, 1.4], [2.5, 6., 2.], (b, g, 3))
    boxes[..., 6] = rng.uniform(-4, 4, (b, g))           # wrapped first
    if dim == 9:
        boxes[..., 7:9] = rng.normal(0, 2., (b, g, 2))
    labels = rng.integers(0, classes, (b, g))
    labels[:, -g // 3:] = -1
    lo, hi = [0, -16, -2, 0, 0][:channels], [32, 16, 2, 1, .45][:channels]
    pts = rng.uniform(lo, hi, (b, n, channels))
    k = n // 2
    pick = rng.integers(0, g, (b, k))
    pts[:, :k, :2] = np.take_along_axis(boxes[..., :2], pick[..., None], 1)
    pts[:, :k, :2] += rng.normal(0, [0.6, 1.2], (b, k, 2))
    pts[:, -8:, 0] = 100.
    return {"data": pts.astype(np.float32), "gt_boxes": boxes,
            "gt_labels": labels.astype(np.int64)}


def run_steps(path, batch):
    """One step of each side from the same state: the JAX step in f64 (its
    grads by nnx.grad with the BN stats updated, then the optax update) and
    the port's make_train_step in f32. The JAX step's own f32 grads lie up
    to 4e-4 of a tensor's largest value from its f64 ones (the BN biases of
    the head and backbone), where the port's f32 grads lie within 7e-6 of
    them, so f64 is the reference."""
    with jax.enable_x64():
        jcfg = JaxConfig(path=path)
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

        grads, losses = grads_of(jax_model, jbatch)
        nnx.Optimizer(jax_model, jcfg.optimizer, wrt=nnx.Param).update(
            jax_model, grads)
        clipped, _ = optax.clip_by_global_norm(10.).update(
            nnx.to_pure_dict(grads), None)
        want, after = jax.device_get(losses), flat_state(jax_model)

    cfg = Config(path=path, device="cpu")
    model = cfg.model
    load_jax_params(model, state0)
    step = make_train_step(lr_scheduler=cfg.lr_scheduler)
    got = step(model.train(), cfg.optimizer,
               {k: torch.from_numpy(v) for k, v in batch.items()})
    flat_clipped = {".".join(map(str, k)): np.asarray(v) for k, v in
                    nnx.traversals.flatten_mapping(clipped).items()}
    return dict(model=model, got=got, want=want,
                grads=to_torch_names(model, flat_clipped),
                after=to_torch_names(model, after), jax_model=jax_model)


def _f64(x):
    return x.astype(jnp.float64) if getattr(x, "dtype", None) == \
        jnp.float32 else x


@pytest.fixture(scope="module")
def two_layer_step(two_layer_yml):
    return run_steps(two_layer_yml, make_batch(0, 5, 3))


def check_losses(got, want, tasks):
    assert set(got) == set(want) == {"loss"} | {
        "{}_{}".format(k, i) for k in ("hm_loss", "loc_loss")
        for i in range(tasks)}
    for k in want:
        assert np.isfinite(got[k].item())
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def check_grads(model, grads):
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    for name, want in grads.items():
        assert np.abs(want.numpy()).max() > 0, name
        close(params[name].grad.numpy(), want.numpy(), 1e-4)


def test_train_step_losses_match_jax(two_layer_step):
    check_losses(two_layer_step["got"], two_layer_step["want"], 2)
    assert float(two_layer_step["want"]["loc_loss_1"]) > 0


def test_train_step_grads_match_jax(two_layer_step):
    check_grads(two_layer_step["model"], two_layer_step["grads"])


def test_train_step_state_matches_jax(two_layer_step):
    """Every running stat after the step (both PFN layers' included), and
    every parameter within 2·lr of JAX's."""
    model, after = two_layer_step["model"], two_layer_step["after"]
    state = model.state_dict()
    stats = [k for k in after if "running" in k]
    assert "voxel_encoder.pfn_layers.1.mlp.bn.running_var" in stats
    assert len(stats) == 2 * sum(isinstance(m, nn.modules.batchnorm._BatchNorm)
                                 for m in model.modules())
    for name, want in after.items():
        tol = 1e-6 if "running" in name else 2 * LR
        np.testing.assert_allclose(state[name].numpy(), want.numpy(),
                                   rtol=tol, atol=tol, err_msg=name)


def test_one_layer_train_step_matches_jax():
    """centerpoint_synthetic_tiny.yml (one PFN layer: the K3 / K1 / K7
    canvas on its plain versions)."""
    res = run_steps(TINY, make_batch(1, 4, 1))
    check_losses(res["got"], res["want"], 1)
    check_grads(res["model"], res["grads"])


def test_losses_match_jax_on_identical_preds(two_layer_step):
    """FastFocalLoss, RegLoss and CenterHead.loss on the same predictions
    and targets (NHWC)."""
    rng = np.random.default_rng(3)
    b, h, w, m = 2, 16, 16, 20
    out = rng.uniform(1e-4, 1 - 1e-4, (b, h, w, 2)).astype(np.float32)
    target = rng.uniform(0, 1, (b, h, w, 2)).astype(np.float32)
    ind = rng.integers(0, h * w, (b, m))
    mask = rng.random((b, m)) < .6
    cat = rng.integers(0, 2, (b, m))
    reg = rng.normal(size=(b, h, w, 10)).astype(np.float32)
    box = rng.normal(size=(b, m, 10)).astype(np.float32)
    t = torch.from_numpy
    for port, ref, args in (
            (centernet_loss.FastFocalLoss(), jax_losses.FastFocalLoss(),
             (out, target, ind, mask, cat)),
            (centernet_loss.RegLoss(), jax_losses.RegLoss(),
             (reg, mask, ind, box))):
        np.testing.assert_allclose(port(*map(t, args)).numpy(),
                                   np.asarray(ref(*map(jnp.asarray, args))),
                                   rtol=1e-6, atol=1e-7)
    zero = np.zeros_like(mask)
    np.testing.assert_allclose(
        centernet_loss.FastFocalLoss()(*map(t, (out, target, ind, zero,
                                                cat))).item(),
        float(jax_losses.FastFocalLoss()(*map(jnp.asarray, (
            out, target, ind, zero, cat)))), rtol=1e-6)

    model, jax_model = two_layer_step["model"], two_layer_step["jax_model"]
    names = {"reg": 2, "height": 1, "dim": 3, "rot": 2, "vel": 2}
    preds, targets = [], []
    for c in (1, 2):
        preds.append({k: rng.normal(size=(b, h, w, n)).astype(np.float32)
                      for k, n in dict(names, hm=c).items()})
        targets.append((rng.uniform(0, 1, (b, h, w, c)).astype(np.float32),
                        box, ind, mask, rng.integers(0, c, (b, m))))
    want = jax_model.bbox_head.loss(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in preds],
        [tuple(map(jnp.asarray, tg)) for tg in targets])
    got = model.bbox_head.loss(
        [{k: t(v) for k, v in p.items()} for p in preds],
        [tuple(map(t, tg)) for tg in targets])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6,
                                   err_msg=k)


def test_targets_match_jax_on_nuscenes_tasks():
    """The nuScenes config's six tasks, bench.make_gt's boxes (velocity
    columns, -1 labels) plus boxes off the map and one of zero width."""
    with open(NUSCENES) as f:
        model_cfg = yaml.safe_load(f)["model"]
    ta = model_cfg["target_assign_cfg"]
    kw = dict(tasks=model_cfg["bbox_head"]["tasks"],
              down_ratio=ta["down_ratio"],
              point_cloud_range=model_cfg["voxelizer"]["point_cloud_range"],
              voxel_size=model_cfg["voxelizer"]["voxel_size"],
              gaussian_overlap=ta["gaussian_overlap"],
              max_objs=ta["max_objs"], min_radius=ta["min_radius"],
              with_velocity=True)
    boxes, labels = bench.make_gt(np.random.default_rng(0), 2, "centerpoint")
    boxes[0, :2, :2] = [[60., 0.], [0., -70.]]       # off the feature map
    boxes[1, 0, 3] = 0.                                # zero width
    want = JaxTargets(**kw)(jnp.asarray(boxes), jnp.asarray(labels))
    got = CenterPointTargetGenerator(**kw)(torch.from_numpy(boxes),
                                           torch.from_numpy(labels))
    assert len(got) == len(want) == 6
    for (hm, box, idx, mask, lab), ref in zip(got, want):
        assert hm.shape == (2, 128, 128, ref[0].shape[-1])
        np.testing.assert_allclose(hm.numpy(), np.asarray(ref[0]), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[2]))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(ref[3]))
        np.testing.assert_array_equal(lab.numpy(), np.asarray(ref[4]))
        np.testing.assert_allclose(box.numpy(), np.asarray(ref[1]),
                                   rtol=1e-6, atol=1e-6)
    assert sum(int(g[3].sum()) for g in got) > 60
    assert all(float(g[0].max()) == 1.0 for g in got if g[3].any())


def optimizer_yml(tmp_path, optimizer, schedule):
    path = tmp_path / "opt.yml"
    path.write_text(yaml.safe_dump({"_base_": TINY, "optimizer": optimizer,
                                    "lr_scheduler": schedule}))
    return str(path)


def run_optimizer(path, scales):
    """Identical grads into the JAX Config's optax chain and into the
    port's optimizer and schedule -> (port params, optax params)."""
    tx = JaxConfig(path=path).optimizer
    cfg = Config(path=path, device="cpu")
    model = cfg.model
    optimizer, scheduler = cfg.optimizer, cfg.lr_scheduler
    params = {k: p.detach().numpy().copy()
              for k, p in model.named_parameters()}
    state = tx.init(params)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(4)
    for scale in scales:
        grads = {k: (rng.normal(0, scale, v.shape)).astype(np.float32)
                 for k, v in params.items()}
        updates, state = update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[k])
        optimizer.step()
        scheduler.step()
    return model, params, optimizer


def test_one_cycle_adam_matches_optax(tmp_path):
    """OneCycleAdam with OneCycleWarmupDecayLr and a cycled
    OneCycleDecayWarmupMomentum beta1 over a 10-step cycle: five updates,
    across the LR peak, the first above the clip norm."""
    path = optimizer_yml(
        tmp_path,
        {"type": "OneCycleAdam", "beta2": 0.99, "weight_decay": 0.01,
         "grad_clip_norm": 35.0, "total_step": 10,
         "beta1": {"type": "OneCycleDecayWarmupMomentum",
                   "momentum_peak": 0.95, "momentum_trough": 0.85,
                   "step_ratio_peak": 0.4}},
        {"type": "OneCycleWarmupDecayLr", "base_learning_rate": 0.001,
         "lr_ratio_peak": 10, "lr_ratio_trough": 0.0001,
         "step_ratio_peak": 0.4, "total_step": 10})
    model, params, optimizer = run_optimizer(path, (3., 1e-2, 1e-3, 1e-2,
                                                    1e-1))
    # beta1 at the fifth update (count 4 of 10): the trough
    assert optimizer.param_groups[0]["betas"][0] == pytest.approx(0.85)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_adam_keeps_grad_clip_norm(tmp_path, caplog):
    """A grad_clip_norm under Adam clips (it wins over the nested
    grad_clip, as in the JAX package), with no key dropped."""
    path = optimizer_yml(
        tmp_path, {"type": "Adam", "weight_decay": 0.0001,
                   "grad_clip_norm": 0.5,
                   "grad_clip": {"type": "ClipGradByGlobalNorm",
                                 "clip_norm": 10.0}},
        {"type": "StepDecay", "learning_rate": 0.002, "step_size": 100})
    with caplog.at_level("WARNING"):
        model, params, _ = run_optimizer(path, (1e-1, 1e-1, 1e-3))
    assert "dropping" not in caplog.text
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_nuscenes_config_builds_its_training(caplog):
    """The nuScenes pillars config builds its model, OneCycleAdam (clip 35,
    decoupled decay 0.01, beta1 0.95 without total_step) and
    OneCycleWarmupDecayLr (total_step 100,000) on the CPU, no key
    dropped; the train path's shapes only (no full-width run here)."""
    with caplog.at_level("WARNING"):
        cfg = Config(path=NUSCENES, device="cpu")
        opt, sched = cfg.optimizer, cfg.lr_scheduler
    assert "dropping" not in caplog.text
    assert isinstance(opt, torch.optim.AdamW)
    group = opt.param_groups[0]
    assert group["betas"] == (0.95, 0.99) and group["weight_decay"] == 0.01
    assert group["lr"] == pytest.approx(1e-4)
    factor = sched.lr_lambdas[0]
    assert factor(40000) == pytest.approx(10.)
    assert factor(100000) == pytest.approx(1e-4)
    model = cfg.model
    gen = model.target_generator
    assert (gen.fm_h, gen.fm_w, gen.max_objs) == (128, 128, 500)
    pfn = model.voxel_encoder
    assert [layer.units for layer in pfn.pfn_layers] == [32, 64]
    assert model.voxelizer.max_num_voxels_for(True) == 30000


def tiny_pillars(path, kind="centerpoint"):
    model = Config(path=path, device="cpu").model
    pts = torch.from_numpy(make_batch(2, 5 if kind == "centerpoint" else 4,
                                      1)["data"])
    return model, pts


def test_test_forward_refuses_train_mode(two_layer_yml):
    """The serving entry of PointPillars and CenterPoint refuses a model in
    train mode (its eval canvas folds BN from running stats)."""
    pp = os.path.join(REPO, "configs", "pointpillars",
                      "pointpillars_synthetic_tiny.yml")
    for path, channels in ((two_layer_yml, 5), (pp, 4)):
        model = Config(path=path, device="cpu").model.train()
        pts = torch.from_numpy(make_batch(2, channels, 1)["data"])
        with pytest.raises(RuntimeError, match="eval mode"):
            model.test_forward({"data": pts})
        assert model.eval().test_forward({"data": pts})["scores"].shape[0] \
            == 2


def test_entry_point_picks_the_voxel_cap(two_layer_yml, monkeypatch):
    """The canvas takes the voxel cap and branch of its entry point's
    flag, not of the modules' mode: a train-mode PFN serves with the test
    cap and its running stats untouched; CenterPoint's voxel canvas passes
    the flag's cap."""
    from paddle3d_tpu_torch.models.detection.centerpoint import \
        centerpoint as cp_module
    from paddle3d_tpu_torch.ops import fused_pfn, pillar_ops
    model = Config(path=two_layer_yml, device="cpu").model.train()
    pts = torch.from_numpy(make_batch(2, 5, 1)["data"])
    caps = []
    fn = fused_pfn.fused_pfn_rows
    monkeypatch.setattr(fused_pfn, "fused_pfn_rows",
                        lambda *a, **k: caps.append(k["maxV"]) or fn(*a, **k))
    stats = model.voxel_encoder.pfn_layers[0].mlp.bn.running_mean.clone()
    mods = (model.voxelizer, model.voxel_encoder, model.middle_encoder)
    canvas = pillar_ops.fused_pillar_canvas(*mods, pts, False)
    assert caps == [1000] and not canvas.requires_grad
    assert torch.equal(model.voxel_encoder.pfn_layers[0].mlp.bn.running_mean,
                       stats)

    voxels = os.path.join(REPO, "configs", "centerpoint",
                          "centerpoint_voxels_0075voxel_nuscenes_10sweep.yml")
    vmodel = Config(path=voxels, device="cpu").model

    class Stop(Exception):
        pass

    def record(*args):
        caps.append(args[4])
        raise Stop

    monkeypatch.setattr(cp_module, "voxel_mean_batch", record)
    for flag in (True, False):
        with pytest.raises(Stop):
            vmodel._canvas(pts, flag)
    assert caps[1:] == [vmodel.voxelizer.max_num_voxels_for(True),
                        vmodel.voxelizer.max_num_voxels_for(False)]
    assert caps[1] != caps[2]


def test_train_step_takes_a_bare_loss_tensor():
    """A train_forward returning one tensor: the step returns {"loss": it}
    after the update."""
    class Tiny(nn.Module):
        def __init__(self):
            super().__init__()
            self.w = nn.Parameter(torch.ones(3))

        def train_forward(self, batch):
            return (self.w * batch["data"]).sum()

    model = Tiny()
    opt = torch.optim.SGD(model.parameters(), lr=0.5)
    out = make_train_step()(model, opt, {"data": torch.tensor([1., 2., 3.])})
    assert set(out) == {"loss"} and out["loss"].item() == 6.
    torch.testing.assert_close(model.w.detach(),
                               torch.tensor([.5, 0., -.5]))
