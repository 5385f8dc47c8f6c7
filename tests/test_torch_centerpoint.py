"""Port parity of CenterPoint-pillars serving on a tiny two-layer config:
configs/centerpoint/centerpoint_synthetic_tiny.yml with the nuScenes
config's shape of PFN (two layers, 5 input channels), two tasks of 1 and 2
classes (so the heatmap padding channel is exercised), a velocity head
(9-d boxes) and nms_pre_max_size 512 (the blocked NMS branch). The JAX model
and the port are built from the same YAML, the JAX weights (randomised eval
BN) carried across, the same numpy points through both test_forward paths;
the JAX side runs its CPU XLA path.

Tolerances: head outputs 1e-4 (a conv stack of f32 sums in another order);
predict on identical preds 1e-5 (the same elementwise math); end to end the
same kept set and labels, scores 1e-4 and boxes 1e-3 (box decode
exponentiates the 1e-4 head difference), as the PointPillars parity test.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

from paddle3d_tpu.apis.config import Config as JaxConfig
from paddle3d_tpu_torch.apis import Config
from paddle3d_tpu_torch.models.detection import CenterHead, CenterPoint
from paddle3d_tpu_torch.ops import _build, pillar_ops
from paddle3d_tpu_torch.utils.convert import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "centerpoint",
                    "centerpoint_synthetic_tiny.yml")
NUSCENES = os.path.join(REPO, "configs", "centerpoint",
                        "centerpoint_pillars_02voxel_nuscenes_10sweep.yml")
VOXELS = os.path.join(REPO, "configs", "centerpoint",
                      "centerpoint_voxels_0075voxel_nuscenes_10sweep.yml")
CELLS = 64 * 64          # the tiny grid: 32 m x 32 m at 0.5 m
SCANS = {"sparse": 1024, "dense": 2048}
CONV_GAIN = 3.0         # see the models fixture


def flat_state(module):
    """nnx parameters and running stats as {dotted path: numpy array}."""
    return {".".join(map(str, k)): np.asarray(getattr(v, "value", v))
            for kind in (nnx.Param, nnx.BatchStat)
            for k, v in nnx.state(module, kind).flat_state()}


def make_points(seed, n, b=2):
    """Tiny-config scans of (x, y, z, intensity, dt): ground returns plus
    car-sized clusters (so scores spread and NMS has work), a few NaN-padded
    rows."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([0, -16, -2, 0, 0], [32, 16, 2, 1, .45], (b, n, 5))
    k = n // 2
    centers = rng.uniform([2, -14], [30, 14], (b, 10, 2))
    pick = rng.integers(0, 10, (b, k))
    pts[:, :k, :2] = np.take_along_axis(centers, pick[..., None], 1) + \
        rng.normal(0, [1.0, 0.5], (b, k, 2))
    pts[:, -8:] = np.nan
    return pts.astype(np.float32)


@pytest.fixture(scope="module")
def config_path(tmp_path_factory):
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
    model["test_cfg"]["nms"]["nms_pre_max_size"] = 512
    path = tmp_path_factory.mktemp("cfg") / "centerpoint_tiny_2l.yml"
    path.write_text(yaml.safe_dump(dic))
    return str(path)


@pytest.fixture(scope="module")
def models(config_path):
    jax_model = JaxConfig(path=config_path).model
    rng = np.random.default_rng(0)
    for _, bn in jax_model.iter_modules():
        if isinstance(bn, nnx.BatchNorm):
            c = bn.mean.value.shape
            bn.mean.value = jnp.asarray(rng.normal(0, .2, c), jnp.float32)
            bn.var.value = jnp.asarray(rng.uniform(.5, 2., c), jnp.float32)
    # ±1/sqrt(fan_in) weights shrink the signal ~3x a layer, which leaves
    # a flat heatmap whose near-equal scores order differently in the two
    # frameworks: scale every conv up to keep the scene's contrast
    for _, conv in jax_model.iter_modules():
        if isinstance(conv, (nnx.Conv, nnx.ConvTranspose)):
            conv.kernel.value = conv.kernel.value * CONV_GAIN
    jax_model.eval()
    model = Config(path=config_path, device="cpu").model
    load_jax_params(model, flat_state(jax_model))
    return jax_model, model.eval()


@pytest.fixture(scope="module")
def jax_run(models):
    """JAX test_forward per scan size, split to also return the neck
    features and the head outputs."""
    jax_model, _ = models
    graphdef, state = nnx.split(jax_model)

    @jax.jit
    def infer(state, points):
        m = nnx.merge(graphdef, state)
        feats = m._extract_feats(points, training=False)
        preds = m.bbox_head(feats)
        return feats, preds, m.bbox_head.predict(preds, m.test_cfg)

    out = {}
    for case, n in SCANS.items():
        pts = make_points(0, n)
        out[case] = (pts,) + tuple(jax.device_get(infer(state,
                                                        jnp.asarray(pts))))
    return out


def test_head_outputs_match(models, jax_run):
    _, model = models
    _, feats, preds, _ = jax_run["sparse"]
    with torch.no_grad():
        got = model.bbox_head(torch.from_numpy(
            np.array(feats)).permute(0, 3, 1, 2))
    assert len(got) == 2 and model.bbox_head._mergeable()
    for task_got, task_ref in zip(got, preds):
        assert set(task_got) == set(task_ref) == {"reg", "height", "dim",
                                                  "rot", "vel", "hm"}
        for k, ref in task_ref.items():
            np.testing.assert_allclose(task_got[k].numpy(), np.asarray(ref),
                                       rtol=1e-4, atol=1e-4)


def test_head_towers_equal_merged_form(models):
    """Eval's merged convolutions compute the towers' function."""
    _, model = models
    head = model.bbox_head
    x = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (2, 64, 16, 16)).astype(np.float32))
    with torch.no_grad():
        shared = head.shared_conv(x)
        merged = head._merged_call(shared)
        towers = [task(shared) for task in head.task_heads]
    for m, t in zip(merged, towers):
        for k in t:
            torch.testing.assert_close(m[k], t[k], rtol=1e-5, atol=1e-5)


def test_predict_on_identical_preds(models, jax_run):
    _, model = models
    _, _, preds, out = jax_run["sparse"]
    got = model.bbox_head.predict(
        [{k: torch.from_numpy(np.array(v)) for k, v in p.items()}
         for p in preds], model.test_cfg)
    assert got["box3d_lidar"].shape == (2, 64, 9)
    np.testing.assert_array_equal(got["label_preds"].numpy(),
                                  out["label_preds"])
    np.testing.assert_allclose(got["scores"].numpy(), out["scores"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["box3d_lidar"].numpy(),
                               out["box3d_lidar"], rtol=1e-5, atol=1e-5)
    labels = out["label_preds"][out["scores"] >= 0]
    assert {0, 1, 2} & set(labels.tolist())


@pytest.mark.parametrize("case", sorted(SCANS))
def test_end_to_end_matches_jax(models, jax_run, case, monkeypatch):
    """Both canvas routes of the port: the sparse scan through the
    transposed row-major sum, the dense one through the channel-major sum
    (its plain version on the CPU)."""
    _, model = models
    pts, _, _, out = jax_run[case]
    dense = pillar_ops.is_dense_scan(pts.shape[1], CELLS)
    assert dense == (case == "dense")
    calls = []
    for name in ("sorted_segment_sum_cm", "sorted_segment_sum"):
        fn = getattr(pillar_ops, name)
        monkeypatch.setattr(pillar_ops, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    got = model.test_forward({"data": torch.from_numpy(pts)})
    assert calls == ["sorted_segment_sum_cm" if dense
                     else "sorted_segment_sum"]
    assert got["box3d_lidar"].shape == (2, 64, 9)
    np.testing.assert_array_equal(got["label_preds"].numpy(),
                                  out["label_preds"])
    np.testing.assert_allclose(got["scores"].numpy(), out["scores"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["box3d_lidar"].numpy(),
                               out["box3d_lidar"], rtol=1e-3, atol=1e-3)
    assert (out["scores"] >= 0).sum() > 0


def test_nuscenes_config_builds_with_jax_shapes():
    """The nuScenes config at full width: the JAX model's parameter and
    running-stat shapes fill the port's model (weights carried across),
    without running it."""
    model = Config(path=NUSCENES, device="cpu").model
    assert isinstance(model, CenterPoint)
    assert isinstance(model.bbox_head, CenterHead)
    assert model.down_ratio == 4 and model.bbox_head.with_velocity
    assert len(model.voxel_encoder.pfn_layers) == 2
    load_jax_params(model, flat_state(JaxConfig(path=NUSCENES).model))


def test_config_defaults_to_the_card():
    cfg = Config(path=NUSCENES)
    assert cfg.device == "cuda"
    assert not hasattr(cfg, "_model")          # nothing built yet


def test_train_forward_raises():
    """Pillar and voxel training are ported
    (tests/test_torch_centerpoint_train.py,
    tests/test_torch_centerpoint_voxels_train.py); a voxel config's
    train_forward raises on a model in eval mode, whose sparse layers would
    take the serving route and running-stat BN (checked before any layer
    runs: nothing of the full-width net is computed)."""
    model = Config(path=VOXELS, device="cpu").model.eval()
    with pytest.raises(RuntimeError, match="train mode"):
        model.train_forward({"data": torch.zeros(1, 8, 5)})


def test_cpu_canvas_takes_no_kernel(models, monkeypatch):
    """A CPU tensor never reaches the kernel library or its counters."""
    def no_build():
        raise AssertionError("kernel library requested for a CPU tensor")

    _, model = models
    monkeypatch.setattr(_build, "library", no_build)
    before = dict(_build.LAUNCHES)
    model.test_forward({"data": torch.from_numpy(make_points(3, 2048))})
    assert _build.LAUNCHES == before
