"""Port parity of SqueezeSegV3 (SACBlock, SACRangeNet, SSGLossComputation,
SqueezeSegV3), its range-image transforms (LoadSemanticKITTIRange /
project_range, NormalizeRangeImage), the SemanticKITTI dataset and mIoU
metric, and LinearWarmup over StepDecay, on the CPU against the JAX
package, with inputs made from a seed by numpy (fixture files written to
tmp_path; nothing is downloaded).

The JAX models are built abstractly (nnx.eval_shape) and filled from a
seed by numpy (tests/test_torch_petr.py's seeded_state); utils/convert
carries the state across (the nnx.Sequential paths of `position_mlp` and
`head`, the nnx.List of `aux_heads`).

Tolerances and why:
  * the unfold, the (1, 2) max pool and the nearest resize: exact (index
    selections); the bilinear upsample: 1e-6 of the largest value (two
    taps weighted in f32 by each framework's own arithmetic);
  * SACBlock and the tiny config's test_forward in f32 (eval: running
    statistics): 1e-5 of the largest value, labels equal (CPU convs summed
    in other orders);
  * SACBlock and the train step in train mode in f64 on both sides (in
    f32 a relu input within rounding of 0 moves gradients far more):
    outputs and running statistics 1e-10, losses 1e-10 of their value,
    gradients 1e-9 of each tensor's largest value; the biases of the
    convs before a batch-statistics BN have no gradient (rounding noise on
    both sides): 1e-9 of the step's largest gradient;
  * the range projection, the dataset's labels and the metrics: exact
    (the same numpy arithmetic); NormalizeRangeImage: exact against the
    JAX transform on the CHW transpose;
  * LinearWarmup: 1e-6 of the rate (the JAX schedule computes in f32).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import nnx

from paddle3d_tpu.apis.config import Config as JaxConfig
from paddle3d_tpu.datasets.semantic_kitti import \
    SemanticKITTIDataset as JaxSemanticKITTI
from paddle3d_tpu.datasets.semantic_kitti import \
    SemanticKittiMetric as JaxKittiMetric
from paddle3d_tpu.models.optimizers.optimizers import \
    LinearWarmup as JaxLinearWarmup
from paddle3d_tpu.models.optimizers.optimizers import StepDecay as JaxStep
from paddle3d_tpu.models.segmentation import squeezesegv3 as jax_ssg
from paddle3d_tpu.transforms.normalize import \
    NormalizeRangeImage as JaxNormalizeRange
from paddle3d_tpu.transforms.range_image import \
    LoadSemanticKITTIRange as JaxLoadRange
from paddle3d_tpu_torch.apis import Config
from paddle3d_tpu_torch.datasets import (SemanticKITTIDataset,
                                         SemanticKittiMetric)
from paddle3d_tpu_torch.models.optimizers import LinearWarmup, StepDecay
from paddle3d_tpu_torch.models.segmentation import (SACBlock, SACRangeNet,
                                                    SqueezeSegV3,
                                                    SSGLossComputation)
from paddle3d_tpu_torch.sample import Sample
from paddle3d_tpu_torch.transforms import (LoadSemanticKITTIRange,
                                           NormalizeRangeImage, project_range)
from paddle3d_tpu_torch.utils.convert import load_jax_params, to_torch_names
from tests.test_torch_petr import (abstract_shapes, check_state_names, close,
                                   flat_state, jax_model, nchw, nhwc,
                                   seeded_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "squeezesegv3")
TINY = os.path.join(CFG, "squeezesegv3_synthetic_tiny.yml")
RN21 = os.path.join(CFG, "squeezesegv3_rangenet21_semantickitti.yml")
RN53 = os.path.join(CFG, "squeezesegv3_rangenet53_semantickitti.yml")
MEAN = [12.12, 10.88, 0.23, -1.04, 0.21]     # the configs' normalisation
STD = [12.32, 11.47, 6.91, 0.86, 0.16]


def as_dtype(module, dt):
    graphdef, st = nnx.split(module)
    return nnx.merge(graphdef, jax.tree.map(
        lambda x: x.astype(dt) if x.dtype == jnp.float32 else x, st))


@pytest.fixture(scope="module")
def tiny():
    """The tiny config (4 classes, encoder [8, 16, 16, 16]) on both sides,
    the seeded JAX state carried across."""
    jm, state = jax_model(TINY)
    model = Config(path=TINY, device="cpu").model
    load_jax_params(model, state)
    return jm, state, model


# ------------------------------------------------------------------ traps
def test_unfold_orders_channels_as_conv_general_dilated_patches():
    """F.unfold's 3 x 3 patches with one cell of zero padding, viewed as
    [B, 9 C, H, W], equal lax.conv_general_dilated_patches' (C, kh, kw)
    order."""
    x = np.random.default_rng(0).normal(size=(2, 3, 5, 7)).astype(
        np.float32)
    ref = jax.lax.conv_general_dilated_patches(
        jnp.asarray(x), (3, 3), (1, 1), [(1, 1), (1, 1)])
    got = F.unfold(torch.from_numpy(x), 3, padding=1).view(2, 27, 5, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("w", [20, 21])
def test_pool_and_resizes_match_jax(w):
    """The (1, 2) VALID max pool (an odd width drops its last column),
    jax.image.resize "nearest" to half the width as torch's
    "nearest-exact" (exact), and "bilinear" back up by 4 as
    align_corners=False (1e-6)."""
    x = np.random.default_rng(1).normal(size=(2, 4, w, 5)).astype(
        np.float32)
    pool = nnx.max_pool(jnp.asarray(x), window_shape=(1, 2), strides=(1, 2))
    np.testing.assert_array_equal(
        nhwc(F.max_pool2d(nchw(x), (1, 2), (1, 2))), np.asarray(pool))
    near = jax.image.resize(jnp.asarray(x), (2, 4, w // 2, 5), "nearest")
    np.testing.assert_array_equal(nhwc(F.interpolate(
        nchw(x), size=(4, w // 2), mode="nearest-exact")), np.asarray(near))
    small = x[:, :, : w // 4]
    up = jax.image.resize(jnp.asarray(small), (2, 4, 4 * (w // 4), 5),
                          "bilinear")
    close(nhwc(F.interpolate(nchw(small), size=(4, 4 * (w // 4)),
                             mode="bilinear", align_corners=False)),
          np.asarray(up), 1e-6)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_sac_block_matches_jax(mode):
    """One SACBlock (6 -> 8 channels at 12 x 20) in train mode (batch
    statistics, eps 1e-5, the running stats moved by flax's momentum 0.99;
    f64) and after .eval() (the running averages; f32)."""
    jm, state = seeded_state(nnx.eval_shape(lambda: jax_ssg.SACBlock(
        6, 8, rngs=nnx.Rngs(0))), 1)
    block = SACBlock(6, 8)
    load_jax_params(block, state)
    bns = [m for m in block.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert [(m.eps, m.momentum) for m in bns] == [(1e-5, 0.01)] * 2
    rng = np.random.default_rng(2)
    rimg = rng.normal(size=(2, 12, 20, 5))
    feats = rng.normal(size=(2, 12, 20, 6))
    train = mode == "train"
    getattr(jm, mode)()
    getattr(block, mode)()
    dt = np.float64 if train else np.float32
    with jax.enable_x64(train):
        jm = as_dtype(jm, jnp.float64 if train else jnp.float32)
        ref = np.asarray(nnx.jit(lambda m, r, f: m(r, f))(
            jm, jnp.asarray(rimg.astype(dt)), jnp.asarray(feats.astype(dt))))
        stats = flat_state(jm)
    if train:
        block.double()
    got = block(nchw(rimg.astype(dt)), nchw(feats.astype(dt)))
    close(nhwc(got), ref, 1e-10 if train else 1e-5)
    if train:
        after = to_torch_names(block, {k: v for k, v in stats.items()
                                       if k.endswith((".mean", ".var"))})
        assert len(after) == 4
        sd = block.state_dict()
        for name, v in after.items():
            close(sd[name].numpy(), v.numpy(), 1e-10)


# ---------------------------------------------------------------- model
def test_tiny_test_forward_matches_jax(tiny):
    """test_forward of the tiny config after .eval() on both sides: the
    NHWC logits and the labels."""
    jm, _, model = tiny
    jm.eval()
    model.eval()
    x = np.random.default_rng(3).normal(size=(2, 16, 64, 5)).astype(
        np.float32)
    ref = jax.device_get(nnx.jit(lambda m, b: m.test_forward(b))(
        jm, {"data": jnp.asarray(x)}))
    got = model.test_forward({"data": torch.from_numpy(x)})
    assert set(got) == set(ref) == {"pred_labels", "logits"}
    assert tuple(got["logits"].shape) == (2, 16, 64, 4)
    close(got["logits"].detach().numpy(), ref["logits"], 1e-5)
    np.testing.assert_array_equal(got["pred_labels"].numpy(),
                                  ref["pred_labels"])
    model.train()
    with pytest.raises(RuntimeError, match="eval"):
        model.test_forward({"data": torch.from_numpy(x)})
    model.eval()


def build_weighted(jax_side):
    """A 20-class model over a three-block encoder [8, 16, 16], its CE
    weighted by SSGLossComputation(20)."""
    if jax_side:
        kw = {"rngs": nnx.Rngs(0)}
        return jax_ssg.SqueezeSegV3(
            jax_ssg.SACRangeNet(5, (8, 16, 16), **kw), num_classes=20,
            loss=jax_ssg.SSGLossComputation(20), **kw)
    return SqueezeSegV3(SACRangeNet(5, (8, 16, 16)), num_classes=20,
                        loss=SSGLossComputation(20))


def test_class_weights_match_jax():
    """SSGLossComputation's inverse-frequency weights (0 at the ignored
    class) and the model's copy of them, outside its state dict."""
    ref = jax_ssg.SSGLossComputation(20, epsilon_w=2e-3, ignore_index=0)
    got = SSGLossComputation(20, epsilon_w=2e-3, ignore_index=0)
    np.testing.assert_array_equal(got.weights, ref.weights)
    assert got.weights[0] == 0 and got.weights.dtype == np.float32
    model = build_weighted(False)
    np.testing.assert_array_equal(model.class_weights.numpy(),
                                  SSGLossComputation(20).weights)
    assert "class_weights" not in model.state_dict()


def test_weighted_train_step_matches_jax_in_f64():
    """train_forward (the class-weighted CE of the head and, halved, of
    each scale's aux head, over the masked pixels) in train mode: losses,
    every gradient and the running stats against the JAX step's, both in
    f64."""
    jm, state = seeded_state(nnx.eval_shape(lambda: build_weighted(True)), 4)
    # a plain array attribute, not an nnx variable: eval_shape left its
    # shape only
    jm.class_weights = jax_ssg.SSGLossComputation(20).weights
    rng = np.random.default_rng(5)
    b, h, w = 2, 16, 32
    data = rng.normal(size=(b, h, w, 5))
    mask = rng.random((b, h, w)) < 0.7
    labels = np.where(mask, rng.integers(0, 20, (b, h, w)), 0)
    with jax.enable_x64():
        jm64 = as_dtype(jm, jnp.float64)
        jm64.train()

        @nnx.jit
        def grads_of(m, bt):
            def loss_fn(m):
                losses = m.train_forward(bt)
                return losses["loss"], losses
            return nnx.grad(loss_fn, has_aux=True)(m)

        grads, want = jax.device_get(grads_of(jm64, {
            "data": jnp.asarray(data), "proj_labels": jnp.asarray(
                labels.astype(np.int32)), "proj_mask": jnp.asarray(mask)}))
        stats = flat_state(jm64)
    model = build_weighted(False)
    load_jax_params(model, state)
    model.double().train()
    got = model.train_forward({"data": torch.from_numpy(data),
                               "proj_labels": torch.from_numpy(labels),
                               "proj_mask": torch.from_numpy(mask)})
    got["loss"].backward()
    assert set(got) == set(want) == {"loss", "loss_main", "loss_aux"}
    for key in want:
        close(got[key].item(), want[key], 1e-10)
    ref = to_torch_names(model, {
        ".".join(map(str, k)): np.asarray(v[...])
        for k, v in nnx.state(grads, nnx.Param).flat_state()})
    assert set(ref) == {n for n, _ in model.named_parameters()}
    # the biases of the convs before a batch-statistics BN have no
    # gradient: both sides give rounding noise, held against the step's
    # largest gradient
    dead = {n for n in ref if "position_mlp" in n and
            n.endswith(("layers.0.bias", "layers.3.bias"))}
    assert len(dead) == 6
    top = max(np.abs(v.numpy()).max() for v in ref.values())
    for name, p in model.named_parameters():
        if name in dead:
            assert np.abs(ref[name].numpy()).max() < 1e-10 * top
            assert np.abs(p.grad.numpy() - ref[name].numpy()).max() < \
                1e-9 * top
        else:
            close(p.grad.numpy(), ref[name].numpy(), 1e-9)
    after = to_torch_names(model, {k: v for k, v in stats.items()
                                   if k.endswith((".mean", ".var"))})
    sd = model.state_dict()
    for name, v in after.items():
        close(sd[name].numpy(), v.numpy(), 1e-10)


@pytest.mark.parametrize("path,chans", [
    (RN21, [32, 64, 128, 256]), (RN53, [64, 128, 256, 512, 1024])])
def test_full_configs_build_with_jax_state(path, chans):
    """RangeNet-21 and -53 through both packages' Config, the port's on
    the meta device: every state name and shape, the encoder widths and
    the head's input (480 and 1,984 channels)."""
    jm = nnx.eval_shape(lambda: JaxConfig(path=path).model)
    with torch.device("meta"):
        model = Config(path=path, device="meta").model
    check_state_names(model, abstract_shapes(jm))
    assert model.backbone.out_channels == jm.backbone.out_channels == chans
    assert model.head.layers[0].in_channels == sum(chans)
    assert model.class_weights is None and jm.class_weights is None


def test_postprocess_matches_jax(tiny):
    jm, _, model = tiny
    out = {"pred_labels": torch.from_numpy(
        np.random.default_rng(6).integers(0, 4, (2, 3, 5)))}
    metas = [{"path": "a.bin", "id": 0, "proj_x": 1},
             {"path": "b.bin", "id": 1}]
    ref = jax_ssg.SqueezeSegV3.postprocess_to_samples(
        {"pred_labels": out["pred_labels"].numpy()}, metas)
    got = SqueezeSegV3.postprocess_to_samples(out, metas)
    for g, r in zip(got, ref):
        assert (g.path, g.modality, dict(g.meta)) == (r.path, r.modality,
                                                      dict(r.meta))
        np.testing.assert_array_equal(g.labels, r.labels)


# ------------------------------------------------------------ transforms
def scan(seed, n=3000):
    """A synthetic velodyne scan: points in a 64-beam band at 2-60 m, a
    remission, per-point labels; three points duplicated (ties in depth,
    one in the same pixel)."""
    rng = np.random.default_rng(seed)
    az = rng.uniform(-np.pi, np.pi, n)
    el = rng.uniform(np.radians(-24.5), np.radians(2.5), n)
    r = rng.uniform(2, 60, n)
    pts = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el), rng.uniform(0, 1, n)], axis=1)
    pts[-3:] = pts[:3]
    pts[-1, 3] = 0.123
    return pts.astype(np.float32), rng.integers(0, 20, n).astype(np.int32)


def test_range_projection_matches_jax(tmp_path):
    """LoadSemanticKITTIRange on a .bin written to tmp_path, with and
    without labels, and project_range on the array, against the JAX
    transform: every output exact (numpy's argsort puts ties in its own
    order in both)."""
    pts, labels = scan(7)
    path = str(tmp_path / "000000.bin")
    pts.tofile(path)
    for lab in (labels, None):
        mine, theirs = (Sample(path, "lidar") for _ in range(2))
        mine.labels, theirs.labels = lab, lab
        got = LoadSemanticKITTIRange(proj_H=64, proj_W=512)(mine)
        ref = JaxLoadRange(proj_H=64, proj_W=512)(theirs)
        keys = ["data", "proj_mask", "proj_x", "proj_y"] + (
            ["proj_labels"] if lab is not None else [])
        assert ("proj_labels" in got) == (lab is not None)
        for k in keys:
            np.testing.assert_array_equal(got[k], ref[k])
            assert got[k].dtype == ref[k].dtype
    direct = project_range(pts[:, :3], pts[:, 3], 64, 512, labels=labels)
    np.testing.assert_array_equal(direct["data"], ref["data"])
    assert direct["data"].shape == (64, 512, 5)
    assert 0.05 < direct["proj_mask"].mean() < 1


def test_normalize_range_image_is_hwc_and_the_jax_pair_breaks():
    """NormalizeRangeImage on the projection's HWC image equals the JAX
    transform on the CHW transpose (mean and std over the channels, then
    the mask); the JAX transform on the configs' HWC image (64 x 2,048,
    the shape LoadSemanticKITTIRange makes) raises."""
    pts, _ = scan(8)
    proj = project_range(pts[:, :3], pts[:, 3], 64, 2048)
    mine = Sample(None, "lidar")
    mine.data, mine.proj_mask = proj["data"], proj["proj_mask"]
    got = NormalizeRangeImage(MEAN, STD)(mine).data
    theirs = Sample(None, "lidar")
    theirs.data = proj["data"].transpose(2, 0, 1)
    theirs.proj_mask = proj["proj_mask"]
    ref = JaxNormalizeRange(MEAN, STD)(theirs).data
    np.testing.assert_array_equal(got, ref.transpose(1, 2, 0))
    assert got.shape == (64, 2048, 5) and (got[~proj["proj_mask"]] == 0).all()
    hwc = Sample(None, "lidar")
    hwc.data, hwc.proj_mask = proj["data"], proj["proj_mask"]
    with pytest.raises(ValueError, match="broadcast"):
        JaxNormalizeRange(MEAN, STD)(hwc)
    with pytest.raises(ValueError, match="H, W, 5"):
        NormalizeRangeImage(MEAN, STD)(theirs)


# --------------------------------------------------------------- dataset
def write_kitti(root):
    """sequences 08 (two frames, labels with instance ids in the high 16
    bits, one raw label past the map) and 00 (one frame, no labels)."""
    rng = np.random.default_rng(9)
    raw_ids = np.array([0, 10, 40, 44, 48, 50, 70, 71, 72, 252, 259, 300])
    for seq, frames, labelled in (("08", 2, True), ("00", 1, False)):
        vdir = os.path.join(root, "sequences", seq, "velodyne")
        ldir = os.path.join(root, "sequences", seq, "labels")
        os.makedirs(vdir)
        os.makedirs(ldir)
        for f in range(frames):
            pts, _ = scan(10 + f, 1500)
            pts.tofile(os.path.join(vdir, "{:06d}.bin".format(f)))
            if labelled:
                sem = rng.choice(raw_ids, len(pts)).astype(np.uint32)
                inst = rng.integers(0, 5, len(pts)).astype(np.uint32)
                (sem | (inst << 16)).tofile(
                    os.path.join(ldir, "{:06d}.label".format(f)))


def test_semantic_kitti_dataset_and_metric_match_jax(tmp_path):
    """Both datasets on the same sequences through the range projection
    (64 x 512): files, remapped labels, projections and the collated
    batch and metas; the port's normalised image is the JAX projection
    normalised over its channels. Then each package's mIoU over the same
    predictions through postprocess_to_samples."""
    root = str(tmp_path)
    write_kitti(root)
    ours = SemanticKITTIDataset(root, mode="val", transforms=[
        LoadSemanticKITTIRange(proj_H=64, proj_W=512),
        NormalizeRangeImage(MEAN, STD)])
    theirs = JaxSemanticKITTI(root, mode="val", transforms=[
        JaxLoadRange(proj_H=64, proj_W=512)])
    assert ours.files == theirs.files == [("08", "000000"), ("08", "000001")]
    assert len(SemanticKITTIDataset(root, sequences=["00", "01"])) == 1
    got, ref = [ours[i] for i in range(2)], [theirs[i] for i in range(2)]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.labels, r.labels)
        assert g.labels.max() <= 19 and g.meta.id == r.meta.id
        for k in ("proj_mask", "proj_x", "proj_y", "proj_labels"):
            np.testing.assert_array_equal(g[k], r[k])
        norm = (r.data - np.asarray(MEAN, np.float32)) / np.asarray(
            STD, np.float32) * r.proj_mask[..., None]
        np.testing.assert_array_equal(g.data, norm)
    (gb, gm), (rb, rm) = ours.collate_fn(got), theirs.collate_fn(ref)
    assert set(gb) == set(rb) == {"data", "proj_mask", "proj_labels"}
    for k in ("proj_mask", "proj_labels"):
        np.testing.assert_array_equal(gb[k], rb[k])
    assert gb["data"].shape == (2, 64, 512, 5)
    preds = np.random.default_rng(11).integers(0, 20, (2, 64, 512))
    ours_m, theirs_m = ours.metric, theirs.metric
    ours_m.update(SqueezeSegV3.postprocess_to_samples(
        {"pred_labels": torch.from_numpy(preds)}, gm))
    theirs_m.update(jax_ssg.SqueezeSegV3.postprocess_to_samples(
        {"pred_labels": preds}, rm))
    np.testing.assert_array_equal(ours_m.conf, theirs_m.conf)
    assert ours_m.compute() == theirs_m.compute()
    assert isinstance(ours_m, SemanticKittiMetric)
    assert isinstance(theirs_m, JaxKittiMetric)


# ------------------------------------------------------------- schedule
@pytest.mark.parametrize("end_lr", [None, 0.02])
def test_linear_warmup_over_step_decay_matches_jax(end_lr):
    """The configs' schedule (a warm-up from 0 over 1,000 updates, then
    StepDecay 0.01 x 0.99 every 14,000) and the end_lr form, against the
    JAX package's at updates 0 to past two decays."""
    ref = JaxLinearWarmup(JaxStep(0.01, 14000, 0.99), warmup_steps=1000,
                          start_lr=0.0, end_lr=end_lr)
    sched = LinearWarmup(StepDecay(0.01, 14000, 0.99), warmup_steps=1000,
                         start_lr=0.0, end_lr=end_lr)
    for step in (0, 1, 250, 999, 1000, 1001, 13999, 14000, 30000):
        want = float(ref(step))
        got = sched.learning_rate * sched.factor(step)
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


def test_config_builds_the_nested_schedule():
    """The RangeNet-21 config's `lr_scheduler: {type: LinearWarmup,
    learning_rate: {type: StepDecay, ...}}` through the port's Config:
    SGD at rate 0 for update 0, the warm-up's rate after 500 updates."""
    cfg = Config(path=RN21, device="cpu")
    cfg._model = torch.nn.Linear(2, 2)        # the optimizer's parameters
    opt, sched = cfg.optimizer, cfg.lr_scheduler
    assert type(opt) is torch.optim.SGD
    assert isinstance(sched.lr_lambdas[0].__self__, LinearWarmup)
    assert opt.param_groups[0]["lr"] == 0.0
    for _ in range(500):
        opt.step()
        sched.step()
    assert opt.param_groups[0]["lr"] == pytest.approx(0.005, rel=1e-12)
