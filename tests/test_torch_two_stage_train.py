"""Port parity of two-stage KITTI training (PV-RCNN, Voxel-RCNN) against
the JAX package.

One train step of each model on the tiny grid of tests/test_torch_two_stage.py
(the KITTI configs at their real widths over 16 m x 16 m: a 64 x 64 x 41
grid, voxel caps [600, 900], 16 proposals, 8 sampled RoIs, a 2^3 RoI grid),
the JAX weights carried across, the config's AdamWOnecycle and OneCycle,
against the JAX step on its CPU XLA path (gather sparse convs under
autodiff, XLA ball query and FPS), with JAX's own sampler draws fed to the
port. The gt boxes are the port's own first proposals, jittered, so that
fg, hard-bg and easy-bg RoIs are all sampled. Then the parts alone:
proposal_targets given JAX's draws (several pool mixes), the RPN loss and
the refinement loss on identical inputs, MaskedBatchNorm's train
statistics, the train-mode sparse conv, OneCycle and AdamWOnecycle.

Tolerances, and why. The sampled RoIs, their labels and masks are equal.
The JAX f32 step's train-mode BN puts its proposals up to ~1e-3 m from the
port's (which lie within ~1e-5 of the JAX step run in f64), and a RoI's IoU
with a gt jittered off it runs through the clip of near-parallel edges,
which magnifies that: boxes, IoUs and the soft cls labels (IoU - 0.25) / 0.5
within 2e-3, losses 1e-4 relative, grads 1e-3 of each tensor's largest
value (the RoI cls layer's, fed by those labels, are the worst, ~4e-4; the
rest lie within 1e-4). Running stats 1e-5 (the f32 one-pass batch variance
of flax's BatchNorm strays ~6e-6 on the RoI head's grouped features); the
AdamW updates 1e-6 where the grad is well clear of that gap, the decay-only
direction head within two roundings, 2·lr elsewhere. The parts on
identical inputs: RPN and refinement losses 1e-6 relative; proposal targets
equal but IoUs and soft labels, 1e-3 (corners from torch's cos / sin lie an
ulp from JAX's, and the RoIs are jittered copies of the gts, with
near-parallel edges); BN and sparse conv 1e-5.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import nnx

from paddle3d_tpu.apis.config import Config as JaxConfig
from paddle3d_tpu.models.detection.pv_rcnn import pv_rcnn as jax_pv_rcnn
from paddle3d_tpu.models.heads import proposal_target_layer as jax_ptl
from paddle3d_tpu.models.heads.anchor3d_head import \
    Anchor3DHead as JaxAnchor3DHead
from paddle3d_tpu.models.heads.roi_head import RoIGridHead as JaxRoIGridHead
from paddle3d_tpu.models.layers import sparse_layers as jax_sparse
from paddle3d_tpu_torch.apis import Config, make_train_step
from paddle3d_tpu_torch.models.detection.pv_rcnn import pv_rcnn
from paddle3d_tpu_torch.models.heads import Anchor3DHead, RoIGridHead
from paddle3d_tpu_torch.models.heads import proposal_target_layer as ptl
from paddle3d_tpu_torch.models.layers.sparse_layers import (MaskedBatchNorm,
                                                            SparseConv3D,
                                                            SparseTensor)
from paddle3d_tpu_torch.models.optimizers import optimizers
from paddle3d_tpu_torch.utils.convert import load_jax_params, to_torch_names
from tests.test_torch_centerpoint_train import optimizer_yml, run_optimizer
from tests.test_torch_two_stage import (PV_RCNN, VOXEL_RCNN, flat_state,
                                        make_points, randomise,
                                        tiny_overrides)

ROIS = 8                 # roi_per_image of the tiny configs
LR = 0.001               # OneCycle at step 0: 0.01 / div_factor 10


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small torch ops: intra-op threads only add fork-and-join time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, ref, tol):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (err, tol)


def jax_draws(key, b, p):
    """The JAX sampler's uniforms for proposal_targets(key, ...): [B, 3, P]
    (fg, hard, easy), split as proposal_target_layer.py does."""
    return np.stack([np.stack([np.asarray(jax.random.uniform(k, (p,)))
                               for k in jax.random.split(kb, 3)])
                     for kb in jax.random.split(key, b)])


def gt_from_proposals(rois, labels, seed, g=6, take=4):
    """Each scan's first `take` proposals as its gt boxes: jittered a
    little (fg RoIs), the last of them pushed half its length along its
    heading (an IoU of about 1/3: a hard-bg RoI); one far box more, -1
    padding. The other proposals stay easy bg."""
    rng = np.random.default_rng(seed)
    b = rois.shape[0]
    boxes = np.zeros((b, g, 7), np.float32)
    out = -np.ones((b, g), np.int64)
    for i in range(b):
        k = np.flatnonzero(labels[i] >= 0)[:take]
        n = len(k)
        boxes[i, :n] = rois[i, k]
        boxes[i, :n, :3] += rng.normal(0, 0.05, (n, 3))
        boxes[i, :n, 6] += rng.normal(0, 0.02, n)
        yaw, length = boxes[i, n - 1, 6], boxes[i, n - 1, 3]
        boxes[i, n - 1, :2] += 0.5 * length * np.array([np.cos(yaw),
                                                        np.sin(yaw)])
        out[i, :n] = labels[i, k]
        boxes[i, n] = [8., 3., -1.6, 1.6, 3.9, 1.56, 0.3]
        out[i, n] = 0
    return boxes, out


def train_yml(tmp_path_factory, name):
    base = PV_RCNN if name == "pv_rcnn" else VOXEL_RCNN
    dic = tiny_overrides(base)
    dic["model"]["target_config"] = {"roi_per_image": ROIS}
    path = tmp_path_factory.mktemp("cfg") / (name + "_train.yml")
    path.write_text(yaml.safe_dump(dic))
    return str(path)


@pytest.fixture(scope="module", params=["voxel_rcnn", "pv_rcnn"])
def steps(request, tmp_path_factory, monkeypatch_module):
    """One train step of each side from the same state and batch, with the
    targets each side sampled: the JAX step (its grads by nnx.grad with the
    BN stats updated, then the optax update) and the port's
    make_train_step, fed the JAX sampler's draws. Both in f32: the JAX step
    run in f64 assigns anchors differently where a degenerate gt box (a
    random-weight proposal, 3 cm wide) ties in the nearest-box IoU."""
    path = train_yml(tmp_path_factory, request.param)
    jcfg = JaxConfig(path=path)
    jax_model = jcfg.model
    randomise(jax_model, 0, 3.0)
    jax_model.train()
    cfg = Config(path=path, device="cpu")
    model = cfg.model
    load_jax_params(model, flat_state(jax_model))
    model.train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    recorded = []

    def record(fn):
        def wrapped(*args):
            out = fn(*args)
            recorded.append(out)
            return out
        return wrapped

    monkeypatch_module.setattr(jax_pv_rcnn, "proposal_targets",
                               record(jax_ptl.proposal_targets))
    monkeypatch_module.setattr(pv_rcnn, "proposal_targets",
                               record(ptl.proposal_targets))
    pts = make_points(0)
    with torch.no_grad():
        probe = copy.deepcopy(model)
        rois = probe.rpn_head.proposals(
            probe._stage1(torch.from_numpy(pts), True)[0])
    boxes, labels = gt_from_proposals(rois[0].numpy(), rois[2].numpy(), 1)
    batch = {"data": pts, "gt_boxes": boxes, "gt_labels": labels}
    stream = jax_model.sampler_rngs.sampler
    draws = jax_draws(jax.random.fold_in(stream.key[...], stream.count[...]),
                      2, rois[0].shape[1])

    @nnx.jit
    def grads_of(m, b):
        def loss_fn(m):
            losses = m.train_forward(b)
            return losses["loss"], (losses, recorded[-1])
        return nnx.grad(loss_fn, has_aux=True)(m)

    @nnx.jit
    def update(m, opt, grads):
        opt.update(m, grads)

    grads, (want, jax_targets) = grads_of(
        jax_model, {k: jnp.asarray(v) for k, v in batch.items()})
    update(jax_model, nnx.Optimizer(jax_model, jcfg.optimizer,
                                    wrt=nnx.Param), grads)
    clipped, _ = optax.clip_by_global_norm(10.).update(
        nnx.to_pure_dict(grads), None)
    flat_clipped = {".".join(map(str, k)): np.asarray(v) for k, v in
                    nnx.traversals.flatten_mapping(clipped).items()}

    model.sampler_draws = lambda b, p, device: torch.from_numpy(draws)
    got = make_train_step(lr_scheduler=cfg.lr_scheduler)(
        model, cfg.optimizer,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return dict(name=request.param, model=model, got=got,
                want=jax.device_get(want),
                targets=(recorded[-1], jax.device_get(jax_targets)),
                grads=to_torch_names(model, flat_clipped), before=before,
                after=to_torch_names(model, flat_state(jax_model)))


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_train_step_targets_match_jax(steps):
    """The sampled RoIs: all three pools drawn in each scan, slots, labels
    and masks equal, boxes, IoUs and soft labels close. The gt a RoI is
    matched to is compared where its IoU reaches cls_bg_thresh_lo: an easy
    bg RoI's IoU with every gt is 0 up to f32 residue of the clip, so which
    gt it names is arbitrary (and no loss reads it)."""
    got, ref = steps["targets"]
    for key in ("valid", "roi_labels", "reg_valid_mask"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    for key in ("rois", "roi_ious", "rcnn_cls_labels"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=0, atol=2e-3, err_msg=key)
    near = got["roi_ious"].numpy() >= 0.1
    np.testing.assert_array_equal(got["gt_label_of_rois"].numpy()[near],
                                  np.asarray(ref["gt_label_of_rois"])[near])
    np.testing.assert_allclose(got["gt_of_rois"].numpy()[near],
                               np.asarray(ref["gt_of_rois"])[near], rtol=0,
                               atol=1e-6)
    ious = got["roi_ious"].numpy()
    assert got["valid"].all()
    for scan in ious:
        assert (scan >= 0.55).any() and (scan < 0.1).any() and \
            ((scan >= 0.1) & (scan < 0.55)).any(), scan
    assert not any(t.requires_grad for t in got.values())


def test_train_step_losses_match_jax(steps):
    got, want = steps["got"], steps["want"]
    assert set(got) == set(want) == {"loss", "loss_rpn_cls", "loss_rpn_reg",
                                     "loss_rcnn_cls", "loss_rcnn_reg"}
    for k in want:
        assert np.isfinite(got[k].item()) and float(want[k]) > 0, k
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   err_msg=k)


def test_train_step_grads_match_jax(steps):
    """Every parameter's grad after the clip, the sparse stages' included
    (the support set's and the BEV's gradients reach them); the RPN's
    direction head, which no loss reaches, gets zero on both sides."""
    model, grads = steps["model"], steps["grads"]
    params = dict(model.named_parameters())
    assert set(grads) == set(params)
    for name, want in grads.items():
        got = params[name].grad.numpy()
        if "dir_head" in name:
            assert not want.numpy().any() and not got.any(), name
            continue
        assert np.abs(want.numpy()).max() > 0, name
        close(got, want.numpy(), 1e-3)
    assert np.abs(params["middle_encoder.stem.conv.weight"].grad.numpy()
                  ).max() > 0


def test_train_step_state_matches_jax(steps):
    """Every running stat after the step (the MaskedBatchNorms' included)
    within 1e-5 of JAX's, and every parameter's update against JAX's. A
    first AdamW step moves an element by lr · g / (|g| + eps) plus the
    decay lr · wd · p, so where the clipped grad is well clear of the
    port/JAX grad gap (10× the grads' tolerance, and 1e3 eps) the updates
    agree within 1e-6: a skipped step, a flipped sign or a missing decay
    (1e-5 · p) shows there. The direction head, which no loss reaches, is
    moved by the decay alone: within two roundings of its value. Only the
    near-zero grads, whose sign the gap may flip, keep the bound 2·lr."""
    model, before, after = steps["model"], steps["before"], steps["after"]
    state = model.state_dict()
    stats = [k for k in after if "running" in k]
    assert "middle_encoder.down3.bn.running_var" in stats
    for name in stats:
        np.testing.assert_allclose(state[name].numpy(), after[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    firm = total = 0
    for name, grad in steps["grads"].items():
        p0 = before[name].numpy()
        got, want = state[name].numpy() - p0, after[name].numpy() - p0
        gap = np.abs(got - want)
        if "dir_head" in name:
            assert (np.abs(want) > 8 * np.spacing(np.abs(p0))).mean() > 0.9
            assert (gap <= 2 * np.spacing(np.abs(p0))).all(), name
            continue
        g = np.abs(grad.numpy())
        big = g >= max(1e-2 * g.max(), 1e-5)
        assert (gap[big] <= 1e-6).all(), (name, gap[big].max())
        assert (gap <= 2 * LR).all(), (name, gap.max())
        firm, total = firm + big.sum(), total + g.size
    assert firm > 0.3 * total, (firm, total)


def target_inputs(kind, seed=0, b=2, p=24, g=4):
    """RoIs around random gt boxes: jittered a little (fg), more (hard bg),
    or far off (easy bg), per `kind`; some RoI slots empty."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((b, g, 7), np.float32)
    gt[..., :2] = rng.uniform([2, -20], [60, 20], (b, g, 2))
    gt[..., 2] = rng.uniform(-1.8, -1.4, (b, g))
    gt[..., 3:6] = rng.uniform([1.5, 3.5, 1.4], [1.9, 4.5, 1.7], (b, g, 3))
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (b, g))
    gl = rng.integers(0, 3, (b, g))
    gl[:, -1] = -1
    pick = rng.integers(0, g - 1, (b, p))
    rois = np.take_along_axis(gt, pick[..., None], 1).copy()
    labels = np.take_along_axis(gl, pick, 1).astype(np.int32)
    shift = {"mixed": rng.choice([0.05, 0.8, 6.0], (b, p)),
             "no_bg": np.full((b, p), 0.05), "no_fg": rng.choice(
                 [0.8, 6.0], (b, p)), "easy_only": np.full((b, p), 6.0)}[kind]
    rois[..., 0] += shift
    rois[..., 6] += rng.normal(0, 0.05, (b, p))
    labels[:, -3:] = -1
    rois[:, -3:] = 0.
    scores = rng.uniform(0, 1, (b, p)).astype(np.float32)
    return rois, labels >= 0, labels, scores, gt, gl


_jax_targets = jax.jit(jax_ptl.proposal_targets, static_argnames=("cfg",))


@pytest.mark.parametrize("kind,score_type", [
    ("mixed", "roi_iou"), ("no_bg", "roi_iou"), ("no_fg", "cls"),
    ("easy_only", "roi_iou")])
def test_proposal_targets_match_jax(kind, score_type):
    """proposal_targets given JAX's draws: the fg / hard / easy split with
    its short-pool wrap-around, the priority top-k, the gather of the
    sampled slots, both cls label types."""
    cfg = dict(roi_per_image=16, cls_score_type=score_type)
    inputs = target_inputs(kind)
    key = jax.random.PRNGKey(3)
    ref = jax.device_get(_jax_targets(
        key, *map(jnp.asarray, inputs), cfg=jax_ptl.ProposalTargetConfig(
            **cfg)))
    got = ptl.proposal_targets(
        torch.from_numpy(jax_draws(key, 2, 24)),
        *map(torch.from_numpy, inputs), ptl.ProposalTargetConfig(**cfg))
    assert set(got) == set(ref) | {"pool_sizes"}
    for k in ref:
        tol = 1e-3 if k in ("roi_ious", "rcnn_cls_labels") else 0
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=tol, err_msg=k)
    valid = got["valid"].numpy()
    fg, hard, easy = got["pool_sizes"].numpy().T
    np.testing.assert_array_equal(fg + hard + easy, inputs[1].sum(axis=1))
    if kind == "mixed":
        ious = got["roi_ious"].numpy()
        assert ((ious >= 0.55) & valid).any(axis=1).all()
        assert ((ious < 0.1) & valid).any(axis=1).all()
        assert (fg > 0).all() and (hard > 0).all() and (easy > 0).all()
    if kind == "no_bg":
        assert valid.all()        # fg fills every slot, reused
        assert not hard.any() and not easy.any()
    if kind == "easy_only":
        assert not fg.any() and not hard.any()


def test_rpn_loss_matches_jax():
    """Anchor3DHead.loss on identical predictions: the three-class tiny
    anchors with their 0.6 / 0.45 and 0.5 / 0.35 thresholds, the focal
    and smooth-L1 losses."""
    cfg = tiny_overrides(PV_RCNN)["model"]["rpn_head"]
    kw = dict(num_classes=3, feature_channels=8, num_proposals=16,
              output_stride_factor=8,
              **{k: cfg[k] for k in ("point_cloud_range", "voxel_size",
                                     "anchor_configs")})
    jhead = JaxAnchor3DHead(rngs=nnx.Rngs(0), **kw)
    head = Anchor3DHead(**kw)
    a = head._anchors.numpy()
    assert a.shape == (384, 7)
    rng = np.random.default_rng(5)
    preds = {"cls_preds": rng.normal(size=(2, 384, 3)),
             "box_preds": rng.normal(0, .3, (2, 384, 7)),
             "dir_preds": rng.normal(size=(2, 384, 2))}
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    pick = rng.integers(0, 384, (2, 5))
    gt = a[pick] + rng.normal(0, [.2, .2, .05, .1, .1, .05, .1],
                              (2, 5, 7)).astype(np.float32)
    gl = np.array([[0, 1, 2, 1, -1], [2, 2, 0, -1, -1]])
    ref = jax.jit(jhead.loss)({k: jnp.asarray(v) for k, v in preds.items()},
                              jnp.asarray(gt), jnp.asarray(gl))
    got = head.loss({k: torch.from_numpy(v) for k, v in preds.items()},
                    torch.from_numpy(gt), torch.from_numpy(gl))
    assert set(got) == set(ref) == {"loss_rpn_cls", "loss_rpn_reg"}
    for k in ref:
        assert float(ref[k]) > 0
        np.testing.assert_allclose(got[k].item(), float(ref[k]), rtol=1e-6,
                                   err_msg=k)


def test_refine_loss_matches_jax():
    """refine_loss on identical predictions and targets: soft and -1
    labels, the masked residual in the roi frame."""
    rng = np.random.default_rng(6)
    b, m = 2, 10
    rois = np.zeros((b, m, 7), np.float32)
    rois[..., :3] = rng.uniform([0, -10, -2], [20, 10, -1], (b, m, 3))
    rois[..., 3:6] = rng.uniform([1.4, 3.2, 1.3], [2.0, 4.4, 1.8], (b, m, 3))
    rois[..., 6] = rng.uniform(-3, 3, (b, m))
    targets = {
        "rois": rois,
        "gt_of_rois": rois + rng.normal(0, .2, rois.shape).astype(
            np.float32),
        "rcnn_cls_labels": rng.choice([-1., 0., .3, .8, 1.], (b, m)).astype(
            np.float32),
        "reg_valid_mask": rng.random((b, m)) < .5,
    }
    cls = rng.normal(size=(b, m)).astype(np.float32)
    reg = rng.normal(0, .3, (b, m, 7)).astype(np.float32)
    ref = JaxRoIGridHead.refine_loss(
        jnp.asarray(cls), jnp.asarray(reg),
        {k: jnp.asarray(v) for k, v in targets.items()})
    got = RoIGridHead.refine_loss(
        torch.from_numpy(cls), torch.from_numpy(reg),
        {k: torch.from_numpy(v) for k, v in targets.items()})
    for g, r in zip(got, ref):
        assert float(r) > 0
        np.testing.assert_allclose(g.item(), float(r), rtol=1e-6)


def sparse_inputs(seed, b=2, v=60, c=4, grid=(5, 12, 12)):
    """Distinct coords in the grid, the last rows of each scan invalid."""
    rng = np.random.default_rng(seed)
    d, h, w = grid
    coords = np.stack([np.stack(np.unravel_index(
        rng.choice(d * h * w, v, replace=False), grid), -1)
        for _ in range(b)]).astype(np.int32)
    mask = np.ones((b, v), bool)
    mask[1, v // 2:] = False
    coords[~mask] = 0
    feats = rng.normal(size=(b, v, c)).astype(np.float32)
    feats[~mask] = 0.
    return feats, coords, mask


def test_masked_batchnorm_train_matches_jax():
    """Train statistics over the valid rows only (two-pass biased variance),
    the flax-style running update at momentum 0.99, invalid rows zero; the
    output and its gradients (input, scale, bias)."""
    feats, _, mask = sparse_inputs(7, c=6)
    feats = feats * 3 + 1
    jbn = jax_sparse.MaskedBatchNorm(6, rngs=nnx.Rngs(0))
    jbn.scale[...] = jnp.linspace(.5, 1.5, 6)
    jbn.bias[...] = jnp.linspace(-.2, .3, 6)
    cot = np.random.default_rng(8).normal(size=feats.shape).astype(
        np.float32)

    def jloss(m, x):
        return jnp.sum(m(x, jnp.asarray(mask)) * cot)
    (gm, gx) = nnx.grad(jloss, argnums=(0, 1))(jbn, jnp.asarray(feats))
    ref = jbn(jnp.asarray(feats), jnp.asarray(mask))       # second update

    bn = MaskedBatchNorm(6)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(.5, 1.5, 6))
        bn.bias.copy_(torch.linspace(-.2, .3, 6))
    x = torch.from_numpy(feats).requires_grad_()
    (bn.train()(x, torch.from_numpy(mask)) * torch.from_numpy(cot)).sum(
    ).backward()
    out = bn(x, torch.from_numpy(mask))
    close(out.detach().numpy(), ref, 1e-5)
    assert not out.detach().numpy()[~mask].any()
    close(x.grad.numpy(), gx, 1e-5)
    close(bn.weight.grad.numpy(), gm["scale"][...], 1e-5)
    close(bn.bias.grad.numpy(), gm["bias"][...], 1e-5)
    close(bn.running_mean.numpy(), jbn.mean[...], 1e-6)
    close(bn.running_var.numpy(), jbn.var[...], 1e-6)
    assert abs(float(jbn.var[...][0]) - 1) > 1e-3      # it moved


@pytest.mark.parametrize("stride", [1, 2])
def test_sparse_conv_train_matches_jax(stride):
    """SparseConv3D in train mode, the gather route under autograd
    (submanifold, and strided onto a capped output set): output rows,
    active set, and the gradients of weight, bias and features."""
    grid = (5, 12, 12)
    feats, coords, mask = sparse_inputs(9, grid=grid)
    jconv = jax_sparse.SparseConv3D(4, 8, 3, stride, out_capacity=40,
                                    rngs=nnx.Rngs(1))
    conv = SparseConv3D(4, 8, 3, stride, out_capacity=40)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.array(jconv.weight[...])))
        conv.bias.copy_(torch.from_numpy(np.array(jconv.bias[...])))
    cap = 40 if stride == 2 else 60
    cot = np.random.default_rng(10).normal(size=(2, cap, 8)).astype(
        np.float32)

    def jloss(m, x):
        st = jax_sparse.SparseTensor(x, jnp.asarray(coords),
                                     jnp.asarray(mask), grid)
        out = m(st)
        return jnp.sum(out.features * cot), out
    (gm, gx), ref = nnx.grad(jloss, argnums=(0, 1), has_aux=True)(
        jconv, jnp.asarray(feats))
    x = torch.from_numpy(feats).requires_grad_()
    out = conv.train()(SparseTensor(x, torch.from_numpy(coords),
                                    torch.from_numpy(mask), grid))
    (out.features * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(out.coords.numpy(), np.asarray(ref.coords))
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    assert out.grid == ref.grid
    close(out.features.detach().numpy(), ref.features, 1e-5)
    close(x.grad.numpy(), gx, 1e-5)
    close(conv.weight.grad.numpy(), gm["weight"][...], 1e-5)
    close(conv.bias.grad.numpy(), gm["bias"][...], 1e-5)
    with pytest.raises(ValueError, match="epilogue"):
        conv(SparseTensor(x, torch.from_numpy(coords),
                          torch.from_numpy(mask), grid), relu=True)


def test_one_cycle_and_adamw_onecycle_match_optax(tmp_path):
    """OneCycle (optax.cosine_onecycle_schedule: pct_start 0.4, div 10,
    final div 1e4, the peak under `lr_max` or `learning_rate`) over a
    10-step cycle and AdamWOnecycle (clip 10, decay 0.01, beta1 0.95,
    beta2 0.99) against the JAX Config's optax chain: five updates across
    the peak, the first above the clip norm."""
    sched = optimizers.OneCycle(lr_max=0.01, total_step=10)
    ref = optax.cosine_onecycle_schedule(10, 0.01, 0.4, 10.0, 1e4)
    for step in range(12):
        assert sched(step) == pytest.approx(float(ref(step)), rel=1e-6)
    assert sched.learning_rate == pytest.approx(1e-3)
    path = optimizer_yml(
        tmp_path, {"type": "AdamWOnecycle", "weight_decay": 0.01,
                   "grad_clip_norm": 10.0},
        {"type": "OneCycle", "learning_rate": 0.01, "total_step": 10})
    model, params, optimizer = run_optimizer(path, (30., 1e-2, 1e-3, 1e-2,
                                                    1e-1))
    assert isinstance(optimizer, torch.optim.AdamW)
    assert optimizer.param_groups[0]["betas"] == (0.95, 0.99)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("path", [PV_RCNN, VOXEL_RCNN],
                         ids=["pv_rcnn", "voxel_rcnn"])
def test_kitti_configs_build_their_training(path, caplog):
    """The KITTI configs build AdamWOnecycle (AdamW, decay 0.01, beta1
    0.95 without total_step, clip 10) and OneCycle (peak 0.01 at 40 % of
    148,480 steps), with no key dropped; the train voxel cap is 16,000 and
    the sampler takes the config's target_config."""
    with caplog.at_level("WARNING"):
        cfg = Config(path=path, device="cpu")
        opt, sched = cfg.optimizer, cfg.lr_scheduler
    assert "dropping" not in caplog.text
    group = opt.param_groups[0]
    assert isinstance(opt, torch.optim.AdamW)
    assert group["betas"] == (0.95, 0.99) and group["weight_decay"] == 0.01
    assert group["lr"] == pytest.approx(1e-3)
    assert sched.lr_lambdas[0](int(0.4 * 148480)) == pytest.approx(10.)
    model = cfg.model
    assert model.voxelizer.max_num_voxels_for(True) == 16000
    with open(path) as f:
        want = yaml.safe_load(f)["model"]["target_config"]
    assert model.target_cfg == ptl.ProposalTargetConfig(**want)
    draws = model.sampler_draws(2, 128, "cpu")
    assert draws.shape == (2, 3, 128) and 0 <= draws.min() < draws.max() < 1
