"""Port parity of CenterPoint-voxels training against the JAX package.

One train step of the tiny 41-layer voxel config that
tests/test_torch_centerpoint_voxels.py writes (its fixtures are shared: the
nuScenes voxel config with its real SparseResNet3D widths over a
128 x 128 x 41 grid, a train voxel cap of 1,200 that binds, one backbone
layer a stage, two tasks of 1 and 2 classes with a velocity head; the JAX
weights, their convs scaled so that the signal crosses the stack, carried
across by utils/convert.py), with the config's OneCycleAdam (clip 35) and
OneCycleWarmupDecayLr, against the JAX step on its CPU XLA path (the gather
sparse convs under autodiff, batch-statistics MaskedBatchNorm, the XLA
dense BEV). The port runs `voxel_mean_batch` at the train cap, the sparse
stack in train mode on the gather route, the dense BEV through the sorted
segment sum with its table-gather VJP (their plain versions here), the
gaussian targets, `CenterHead.loss` and the optimizer.

Which reference, and why. Both steps run in f64 (the JAX state and batch
cast under jax.enable_x64, the port's model and batch with .double()): the
JAX f32 train step's BN-bias grads stray up to 4e-4 of a tensor's largest
value from its own f64 step (tests/test_torch_centerpoint_train.py), more
than a parity test should allow. An f64 copy of the points moves points
that lie on a voxel face to the next voxel, so the points here sit at
least a tenth of a voxel inside their voxel (make_batch): both precisions
voxelize them alike.

Tolerances: the target indices, masks and labels equal, the box targets
1e-12, the heatmaps 1e-7 (the target generator splats its gaussians in
f32 whatever the boxes' dtype, the JAX one in f64 under x64); losses 1e-6
relative and grads 1e-5 of each tensor's largest value (the heatmaps' f32
rounding moves them by ~7e-8 and ~1e-6); a sparse conv's bias that feeds a
batch-statistics BN has no gradient (the BN takes its mean away): both
sides give rounding noise, held within 1e-12 of the largest grad; running
stats 1e-7; each OneCycleAdam update within 1e-10 where the clipped grad
is well clear of zero, 2·lr elsewhere (a first Adam step moves an element
by ~lr·sign(g), and near g = 0 the grads' gap can flip that sign).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from paddle3d_tpu.apis.config import Config as JaxConfig
from paddle3d_tpu.ops.box_ops import limit_period as jax_limit_period
from paddle3d_tpu_torch.apis import Config, make_train_step
from paddle3d_tpu_torch.ops import _build, sorted_scatter
from paddle3d_tpu_torch.ops.box_ops import limit_period
from paddle3d_tpu_torch.utils.convert import load_jax_params, to_torch_names
# the serving test's tiny config, JAX model and one-thread fixtures, shared
from tests.test_torch_centerpoint_voxels import (  # noqa: F401
    RANGE, VOXEL, config_path, flat_state, make_points, models, one_thread)


def make_batch(seed):
    """make_points' scans (ground, car-sized clusters, top-z points, rows
    out of range and NaN padding; the train cap binds on the first scan)
    with every in-range point moved to at least a tenth of a voxel inside
    its voxel, and gt boxes (9 columns, bottom z, velocity) on the scan's
    clusters: scan 0 four boxes of the three classes and two -1 rows, scan
    1 three, one with a yaw past pi (three cars in all: an odd count, so
    the L1 grads of a regression bias cannot cancel to zero)."""
    pts = make_points(seed)
    lo, vs = np.asarray(RANGE[:3], np.float32), np.asarray(VOXEL, np.float32)
    cell = np.floor((pts[..., :3] - lo) / vs)
    frac = np.clip((pts[..., :3] - lo) / vs - cell, .1, .9)
    inside = np.isfinite(cell).all(-1) & (pts[..., 0] < RANGE[3])
    pts[..., :3] = np.where(inside[..., None], lo + (cell + frac) * vs,
                            pts[..., :3]).astype(np.float32)
    rng = np.random.default_rng(seed + 10)
    boxes = np.zeros((2, 6, 9), np.float32)
    boxes[..., :2] = rng.uniform([2, -6], [14, 6], (2, 6, 2))
    boxes[..., 2] = -1.6
    boxes[..., 3:6] = [1.9, 4.4, 1.6]
    boxes[..., 6] = rng.uniform(-3, 3, (2, 6))
    boxes[1, 1, 6] = 4.0                        # wraps through limit_period
    boxes[..., 7:9] = rng.normal(0, 2., (2, 6, 2))
    labels = np.array([[0, 1, 2, 0, -1, -1], [0, 2, 1, -1, -1, -1]])
    return {"data": pts, "gt_boxes": boxes, "gt_labels": labels}


def _f64(x):
    return x.astype(jnp.float64) if getattr(x, "dtype", None) == \
        jnp.float32 else x


@pytest.fixture(scope="module")
def step(models, config_path):
    """One train step of each side in f64 from the shared models' state:
    the JAX step (nnx.grad with the BN stats updated, then the optax
    update) and the port's make_train_step; the sorted segment sum's calls
    and the launches of the port's step recorded."""
    jax_model, _ = models
    state0 = flat_state(jax_model)
    batch = make_batch(5)
    with jax.enable_x64():
        jcfg = JaxConfig(path=config_path)
        jax_model.train()
        graphdef, state = nnx.split(jax_model)
        jm = nnx.merge(graphdef, jax.tree.map(_f64, state))
        jbatch = {k: _f64(jnp.asarray(v)) for k, v in batch.items()}

        @nnx.jit
        def grads_of(m, b):
            def loss_fn(m):
                losses = m.train_forward(b)
                return losses["loss"], losses
            return nnx.grad(loss_fn, has_aux=True)(m)

        grads, want = grads_of(jm, jbatch)
        nnx.Optimizer(jm, jcfg.optimizer, wrt=nnx.Param).update(jm, grads)
        clipped, _ = optax.clip_by_global_norm(35.).update(
            nnx.to_pure_dict(grads), None)
        gt = jbatch["gt_boxes"]
        gt = gt.at[..., 6].set(jax_limit_period(gt[..., 6], 0.5,
                                                2 * jnp.pi))
        targets = jm.target_generator(gt, jbatch["gt_labels"])
        want, after, targets = (jax.device_get(want), flat_state(jm),
                                jax.device_get(targets))

    cfg = Config(path=config_path, device="cpu")
    model = cfg.model
    load_jax_params(model, state0)
    model.double().train()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for k in ("data", "gt_boxes"):
        tbatch[k] = tbatch[k].double()
    calls = []
    fn = sorted_scatter.sorted_segment_sum
    before = {k: v.clone() for k, v in model.state_dict().items()}
    launches = dict(_build.LAUNCHES)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sorted_scatter, "sorted_segment_sum",
                   lambda *a: calls.append(a) or fn(*a))
        got = make_train_step(lr_scheduler=cfg.lr_scheduler)(
            model, cfg.optimizer, tbatch)
    flat_clipped = {".".join(map(str, k)): np.asarray(v) for k, v in
                    nnx.traversals.flatten_mapping(clipped).items()}
    return dict(model=model, got=got, want=want, targets=targets,
                batch=tbatch, calls=calls, before=before,
                launches=(launches, dict(_build.LAUNCHES)),
                grads=to_torch_names(model, flat_clipped),
                after=to_torch_names(model, after))


def close(got, ref, tol):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (err, tol)


def test_train_step_runs_the_voxel_canvas(step):
    """The step's canvas: one dense-BEV segment sum at the stage-4 grid
    (2 x 16 x 16 cells) over rows that carry a gradient, from the train
    cap's voxels; no kernel launched on the CPU."""
    (keys, rows, cells), = step["calls"]
    assert cells == 2 * 16 * 16 and rows.requires_grad
    assert rows.dtype == torch.float64 and keys.dtype == torch.int32
    assert step["launches"][0] == step["launches"][1]
    assert step["model"].voxelizer.max_num_voxels_for(True) == 1200


def test_train_step_targets_match_jax(step):
    """The gaussian targets of the two tasks from the yaw-wrapped boxes."""
    model, batch = step["model"], step["batch"]
    gt = batch["gt_boxes"]
    gt = torch.cat([gt[..., :6], limit_period(gt[..., 6:7], 0.5,
                                              2 * math.pi), gt[..., 7:]], -1)
    got = model.target_generator(gt, batch["gt_labels"])
    assert len(got) == len(step["targets"]) == 2
    for (hm, box, idx, mask, lab), ref in zip(got, step["targets"]):
        np.testing.assert_allclose(hm.numpy(), np.asarray(ref[0]), rtol=0,
                                   atol=1e-7)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[2]))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(ref[3]))
        np.testing.assert_array_equal(lab.numpy(), np.asarray(ref[4]))
        np.testing.assert_allclose(box.numpy(), np.asarray(ref[1]),
                                   rtol=0, atol=1e-12)
        assert mask.any()


def test_train_step_losses_match_jax(step):
    got, want = step["got"], step["want"]
    assert set(got) == set(want) == {"loss"} | {
        "{}_{}".format(k, i) for k in ("hm_loss", "loc_loss")
        for i in range(2)}
    for k in want:
        assert np.isfinite(got[k].item()) and float(want[k]) > 0, k
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6,
                                   err_msg=k)


def test_train_step_grads_match_jax(step):
    """Every parameter's grad after the clip, the sparse stages' through
    the dense BEV's VJP included; the sparse convs' biases, which feed a
    batch-statistics MaskedBatchNorm, get none on either side."""
    model, grads = step["model"], step["grads"]
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    largest = max(np.abs(w.numpy()).max() for w in grads.values())
    dead = {n for n in grads if n.startswith("middle_encoder.")
            and n.endswith("conv.bias") or n.endswith(("conv1.bias",
                                                       "conv2.bias"))}
    assert len(dead) == 16
    for name, want in grads.items():
        got = params[name].grad.numpy()
        if name in dead:
            assert np.abs(want.numpy()).max() <= 1e-12 * largest, name
            assert np.abs(got).max() <= 1e-12 * largest, name
            continue
        assert np.abs(want.numpy()).max() > 0, name
        close(got, want.numpy(), 1e-5)
    assert np.abs(params["middle_encoder.conv_input.conv.weight"].grad
                  .numpy()).max() > 0


def test_train_step_state_matches_jax(step):
    """Every running stat after the step (the MaskedBatchNorms' of the
    sparse stack and the dense BNs') and every parameter's update after the
    OneCycleAdam step."""
    model, before, after = step["model"], step["before"], step["after"]
    state = model.state_dict()
    stats = [k for k in after if "running" in k]
    assert "middle_encoder.extra.bn.running_var" in stats
    for name in stats:
        np.testing.assert_allclose(state[name].numpy(), after[name].numpy(),
                                   rtol=1e-7, atol=1e-7, err_msg=name)
    lr = 1e-4                    # OneCycleWarmupDecayLr at step 0
    firm = total = 0
    for name, grad in step["grads"].items():
        p0 = before[name].numpy()
        gap = np.abs((state[name].numpy() - p0) - (after[name].numpy() - p0))
        g = np.abs(grad.numpy())
        big = g >= max(1e-2 * g.max(), 1e-5)
        assert (gap[big] <= 1e-10).all(), (name, gap[big].max())
        assert (gap <= 2 * lr).all(), (name, gap.max())
        firm, total = firm + big.sum(), total + g.size
    assert firm > 0.5 * total, (firm, total)
