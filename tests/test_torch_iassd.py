"""Port parity of IA-SSD serving: configs/iassd/iassd_synthetic_tiny.yml end
to end against the JAX model (the same YAML, the JAX weights with
randomised eval BN carried across, the same NaN-padded numpy points), the
backbone's sampled sets layer by layer, the dict surface of the reference
YAMLs, and the KITTI config's parameter shapes at full width. The JAX side
runs its CPU path (XLA ball query and farthest-point sampling).

Tolerances: sampled points equal (they are gathered input coordinates);
features 1e-4 of each tensor's largest value; end to end labels equal,
scores 1e-5, boxes 1e-3.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from paddle3d_tpu.apis.config import Config as JaxConfig
from paddle3d_tpu.models.detection.iassd.iassd import IASSD as JaxIASSD
from paddle3d_tpu_torch.apis import Config
from paddle3d_tpu_torch.models.detection import IASSD
from paddle3d_tpu_torch.ops import _build
from paddle3d_tpu_torch.utils.convert import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "iassd", "iassd_synthetic_tiny.yml")
KITTI = os.path.join(REPO, "configs", "iassd", "iassd_kitti.yml")


def flat_state(module):
    """nnx parameters and running stats as {dotted path: numpy array}."""
    return {".".join(map(str, k)): np.asarray(getattr(v, "value", v))
            for kind in (nnx.Param, nnx.BatchStat)
            for k, v in nnx.state(module, kind).flat_state()}


def randomise(module, seed):
    """Random eval BN statistics and affine parameters; the linear heads'
    weights scaled up so that scores spread and the votes move."""
    rng = np.random.default_rng(seed)
    for _, m in module.iter_modules():
        if isinstance(m, nnx.BatchNorm):
            c = m.mean.value.shape
            m.mean.value = jnp.asarray(rng.normal(0, .2, c), jnp.float32)
            m.var.value = jnp.asarray(rng.uniform(.5, 2., c), jnp.float32)
            m.scale.value = jnp.asarray(rng.uniform(.8, 1.6, c), jnp.float32)
        if isinstance(m, nnx.Linear) and m.bias is not None:
            m.kernel.value = m.kernel.value * 4.
    module.eval()


def make_points(seed, b=2, n=1024):
    """Synthetic scans over the tiny config's range: ground returns, a few
    car-sized clusters, NaN padding; the last scan keeps 200 points, fewer
    than the first layer samples (256)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([0, -16, -2, 0], [32, 16, -1.2, 1], (b, n, 4))
    k = n // 2
    centers = rng.uniform([4, -12, -1.2], [28, 12, 0], (b, 6, 3))
    pick = rng.integers(0, 6, (b, k))
    pts[:, :k, :3] = np.take_along_axis(centers, pick[..., None], 1) + \
        rng.normal(0, [.9, .5, .4], (b, k, 3))
    pts[:, -24:] = np.nan
    pts[-1, 200:] = np.nan
    return pts.astype(np.float32)


@pytest.fixture(scope="module")
def models():
    jax_model = JaxConfig(path=TINY).model
    randomise(jax_model, 0)
    model = Config(path=TINY, device="cpu").model
    load_jax_params(model, flat_state(jax_model))
    return jax_model, model.eval()


@pytest.fixture(scope="module")
def jax_run(models):
    jax_model, _ = models
    graphdef, state = nnx.split(jax_model)

    @jax.jit
    def infer(state, points):
        m = nnx.merge(graphdef, state)
        votes, feats, mask, sa_confs, scores = m._backbone(points)
        return (votes, feats, mask, sa_confs, m.cls_head(feats),
                m.reg_head(feats), m.test_forward({"data": points}))

    pts = make_points(0)
    return (pts,) + tuple(jax.device_get(infer(state, jnp.asarray(pts))))


def _close(got, ref, tol=1e-4):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (err, tol)


def test_backbone_matches_jax(models, jax_run):
    """The SA stack (farthest-point sampling, then confidence top-k on the
    scores of the layer before), the vote layer and the aggregation around
    the votes: the sampled sets of the two confidence layers equal, votes,
    features and head outputs close."""
    _, model = models
    pts, votes, feats, mask, sa_confs, cls, reg, _ = jax_run
    with torch.no_grad():
        got = model._backbone(torch.from_numpy(pts))
        got_cls, got_reg = model.cls_head(got[1]), model.reg_head(got[1])
    assert got[0].shape == (2, 32, 3) and got[1].shape == (2, 32, 1536)
    np.testing.assert_array_equal(got[2].numpy(), mask)
    assert len(got[3]) == len(sa_confs) == 2
    for (conf, xyz, m), (rconf, rxyz, rm) in zip(got[3], sa_confs):
        np.testing.assert_array_equal(xyz.numpy(), rxyz)
        np.testing.assert_array_equal(m.numpy(), rm)
        _close(conf.numpy(), rconf)
    _close(got[0].numpy(), votes)
    _close(got[1].numpy(), feats)
    _close(got_cls.numpy(), cls)
    _close(got_reg.numpy(), reg)
    assert np.abs(votes - sa_confs[-1][1]).max() > 0.5       # votes moved


def test_end_to_end_matches_jax(models, jax_run):
    """test_forward against the JAX model: labels equal, scores 1e-5, boxes
    1e-3; boxes are kept and padded by the -1 convention."""
    _, model = models
    pts, out = jax_run[0], jax_run[-1]
    got = model.test_forward({"data": torch.from_numpy(pts)})
    assert got["box3d_lidar"].shape == (2, 16, 7)
    assert got["label_preds"].dtype == torch.int32
    np.testing.assert_array_equal(got["label_preds"].numpy(),
                                  out["label_preds"])
    np.testing.assert_allclose(got["scores"].numpy(), out["scores"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["box3d_lidar"].numpy(),
                               out["box3d_lidar"], rtol=1e-3, atol=1e-3)
    kept = out["scores"] >= 0
    assert 2 <= kept.sum() < kept.size


def test_third_layer_without_scores_samples_by_farthest_point():
    """The KITTI defaults give layers 1 and 2 no confidence head, so the
    ctr_aware layer 3 receives no scores and falls through to
    farthest-point sampling; only layer 4 takes the confidence top-k."""
    model = Config(path=KITTI, device="cpu").model
    mods = model.sa_modules
    assert [m.sample_type for m in mods] == ["d-fps", "d-fps", "ctr_aware",
                                             "ctr_aware"]
    assert [m.confidence is not None for m in mods] == [False, False, True,
                                                        True]
    pts = torch.from_numpy(make_points(1, b=1, n=700)[..., :3])
    mask = torch.isfinite(pts).all(-1)
    pts = torch.where(mask[..., None], pts, 0.)
    from paddle3d_tpu_torch.ops.fps import farthest_point_sample_batched
    torch.testing.assert_close(
        mods[2]._sample(pts, mask, None),
        farthest_point_sample_batched(pts, mask, 512), rtol=0, atol=0)
    assert model.ctr_agg.sample_type == "identity"
    assert model.ctr_agg.radii == [4.8, 6.4]


def test_kitti_config_builds_with_jax_shapes():
    """The KITTI config at full width (its last mlps entry differs from the
    constructor default): every parameter and running stat of the port
    filled from the JAX model, without running either."""
    model = Config(path=KITTI, device="cpu").model
    assert isinstance(model, IASSD)
    last = model.sa_modules[3]
    assert last.scale_mlps[1].layers[2].linear.weight.shape == (1024, 512)
    assert last.aggregation.layers[0].linear.weight.shape == (512, 1536)
    assert model.ctr_agg.scale_mlps[0].layers[0].linear.weight.shape == \
        (256, 131)
    assert model.cls_head.layers[1].bias.tolist() == pytest.approx(
        [-2.19] * 3)
    load_jax_params(model, flat_state(JaxConfig(path=KITTI).model))


def test_dict_surface_matches_jax():
    """The reference YAMLs' IASSD_Backbone / IASSD_Head dicts fold onto the
    flat surface as in the JAX model: the same parameter shapes."""
    backbone = dict(
        layer_types=["SA_Layer", "SA_Layer", "SA_Layer", "SA_Layer",
                     "Vote_Layer", "SA_Layer"],
        npoint_list=[64, 32, 16, 8, 8, 8],
        sample_method_list=["D-FPS", "D-FPS", "ctr_aware", "ctr_aware",
                            None, None],
        radius_list=[[0.5, 1.0], [1.0, 2.0], [2.0, 4.0], [], [],
                     [4.0, 6.0]],
        nsample_list=[[4, 8], [4, 8], [4, 8], [], [], [4, 8]],
        mlps=[[[8, 8], [8, 16]], [[16, 16], [16, 32]], [[16, 32], [16, 32]],
              [], [24], [[32, 32], [32, 64]]],
        aggregation_mlps=[[16], [32], [32], [], [], [64]],
        confidence_mlps=[[], [16], [16], [], [], []],
        max_translate_range=[3.0, 3.0, 2.0], input_channel=4, num_classes=2)
    head = dict(cls_fc=[32], reg_fc=[32], num_classes=2)
    jmodel = JaxIASSD(backbone=backbone, head=head, rngs=nnx.Rngs(0))
    model = IASSD(backbone=backbone, head=head)
    load_jax_params(model, flat_state(jmodel))
    assert [m.npoint for m in model.sa_modules] == [64, 32, 16, 8]
    assert model.sa_modules[3].radii == [4.0, 6.0]
    assert model.vote.ctr_reg.weight.shape == (3, 24)


def test_training_raises_and_cpu_takes_no_kernel(models, monkeypatch):
    """test_forward refuses a model in train mode (batch-statistics BN
    would serve and move its running stats); a CPU train step (its parity:
    tests/test_torch_iassd_train.py) and a CPU forward never reach the
    kernel library or its counters, and the aggregation around the votes
    keeps its given centres."""
    def no_build():
        raise AssertionError("kernel library requested for a CPU tensor")

    _, model = models
    monkeypatch.setattr(_build, "library", no_build)
    before = dict(_build.LAUNCHES)
    train = Config(path=TINY, device="cpu").model.train()
    assert train.ctr_agg.sample_type == "identity"
    pts = torch.from_numpy(make_points(2))
    with pytest.raises(RuntimeError, match="eval mode"):
        train.test_forward({"data": pts})
    boxes = torch.tensor([[[10., 4., -1.6, 1.8, 4., 1.5, .3],
                           [20., -5., -1.6, 1.8, 4., 1.5, 1.]]] * 2)
    losses = train.train_forward({"data": pts, "gt_boxes": boxes,
                                  "gt_labels": torch.tensor([[0, -1]] * 2)})
    losses["loss"].backward()
    assert set(losses) == {"loss", "loss_cls", "loss_box", "loss_sa"}
    assert torch.isfinite(losses["loss"])
    assert train.vote.ctr_reg.weight.grad.abs().max() > 0
    model.test_forward({"data": pts})
    assert _build.LAUNCHES == before


def test_new_models_import_no_jax():
    """The port's two-stage and point models import torch and never jax,
    flax or paddle3d_tpu: build PV-RCNN, Voxel-RCNN and IA-SSD at full
    width and run the tiny IA-SSD in a fresh interpreter."""
    code = (
        "import sys, torch\n"
        "from paddle3d_tpu_torch.apis import Config\n"
        "import paddle3d_tpu_torch.ops.ball_query\n"
        "import paddle3d_tpu_torch.ops.fps\n"
        "names = [type(Config(path=p, device='cpu').model).__name__\n"
        "         for p in sys.argv[1:4]]\n"
        "m = Config(path=sys.argv[4], device='cpu').model.eval()\n"
        "m.test_forward({'data': torch.rand(1, 300, 4) * 10})\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'flax', 'paddle3d_tpu'))\n"
        "print(names, bad)\n")
    paths = [os.path.join(REPO, "configs", *p) for p in (
        ("pv_rcnn", "pv_rcnn_005voxel_kitti.yml"),
        ("voxel_rcnn", "voxel_rcnn_005voxel_kitti_car.yml"),
        ("iassd", "iassd_kitti.yml"))] + [TINY]
    res = subprocess.run([sys.executable, "-c", code] + paths, cwd=REPO,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "['PVRCNN', 'VoxelRCNN', 'IASSD'] []"
