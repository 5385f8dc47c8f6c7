"""Port parity of PV-RCNN and Voxel-RCNN serving on a tiny grid: the KITTI
configs (configs/pv_rcnn/pv_rcnn_005voxel_kitti.yml and
configs/voxel_rcnn/voxel_rcnn_005voxel_kitti_car.yml) with their real
channel widths and their z extent of 41 layers, over 16 m x 16 m at 0.25 m
(a 64 x 64 x 41 grid, BEV 8 x 8 x 320), a voxel cap that binds, backbone
layers cut to one per stage, 64 keypoints, a 2^3 RoI grid and 16 proposals.
The JAX model and the port are built from the same YAML, the JAX weights
(randomised eval BN) carried across, the same NaN-padded numpy points
through both; the JAX side runs its CPU path (XLA ball query and FPS, gather
sparse convs).

Tolerances: indices (keypoints, proposals' anchors, labels) equal; features
1e-4 of each tensor's largest value; end to end scores 1e-5, boxes 1e-3.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

from paddle3d_tpu.apis.config import Config as JaxConfig
from paddle3d_tpu.models.detection.pointpillars.anchors import \
    AnchorGenerator as JaxAnchorGenerator
from paddle3d_tpu.models.heads.roi_head import RoIGridHead as JaxRoIGridHead
from paddle3d_tpu.models.layers.sparse_layers import \
    MaskedBatchNorm as JaxMaskedBN
from paddle3d_tpu.models.layers.sparse_layers import \
    SparseConv3D as JaxSparseConv3D
from paddle3d_tpu.models.point_encoders.voxel_set_abstraction import \
    VoxelSetAbstraction as JaxVSA
from paddle3d_tpu.models.point_encoders.voxel_set_abstraction import \
    bev_bilinear as jax_bev_bilinear
from paddle3d_tpu_torch.apis import Config, make_train_step
from paddle3d_tpu_torch.models.detection import PVRCNN, VoxelRCNN
from paddle3d_tpu_torch.models.heads import Anchor3DHead, RoIGridHead
from paddle3d_tpu_torch.models.point_encoders import (VoxelSetAbstraction,
                                                      bev_bilinear)
from paddle3d_tpu_torch.ops import _build
from paddle3d_tpu_torch.utils.convert import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PV_RCNN = os.path.join(REPO, "configs", "pv_rcnn",
                       "pv_rcnn_005voxel_kitti.yml")
VOXEL_RCNN = os.path.join(REPO, "configs", "voxel_rcnn",
                          "voxel_rcnn_005voxel_kitti_car.yml")
RANGE = [0., -8., -2., 16., 8., 2.]
VOXEL = [0.25, 0.25, 0.1]
GAIN = 3.0               # see the models fixture


def flat_state(module):
    """nnx parameters and running stats as {dotted path: numpy array}."""
    return {".".join(map(str, k)): np.asarray(getattr(v, "value", v))
            for kind in (nnx.Param, nnx.BatchStat)
            for k, v in nnx.state(module, kind).flat_state()}


def randomise(module, seed, gain=1.0):
    """Random eval BN statistics; conv weights scaled by `gain`."""
    rng = np.random.default_rng(seed)
    for _, m in module.iter_modules():
        if isinstance(m, (nnx.BatchNorm, JaxMaskedBN)):
            c = m.mean.value.shape
            m.mean.value = jnp.asarray(rng.normal(0, .2, c), jnp.float32)
            m.var.value = jnp.asarray(rng.uniform(.5, 2., c), jnp.float32)
        if isinstance(m, (nnx.Conv, nnx.ConvTranspose)):
            m.kernel.value = m.kernel.value * gain
        if isinstance(m, JaxSparseConv3D):
            m.weight.value = m.weight.value * gain
    module.eval()


def make_points(seed, b=2, n=3000):
    """Tiny-grid scans of (x, y, z, intensity): ground returns and car-sized
    clusters below z = 1.9 m (so no stage voxel leaves its grid), a few
    out-of-range rows, NaN padding; the last scan keeps a fifth of its
    points, fewer than the voxel cap."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([0, -8, -2, 0], [16, 8, -1.5, 1], (b, n, 4))
    k = n // 2
    centers = rng.uniform([1, -7, -1.5], [15, 7, 0], (b, 8, 3))
    pick = rng.integers(0, 8, (b, k))
    pts[:, :k, :3] = np.take_along_axis(centers, pick[..., None], 1) + \
        rng.normal(0, [.8, .4, .3], (b, k, 3))
    pts[:, k:k + 20, 0] = 17.0
    pts[:, -16:] = np.nan
    pts[-1, n // 5:] = np.nan
    return pts.astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain sparse conv runs 27 x Cin small ops a conv: intra-op
    threads add only fork-and-join time to each, which a parallel test run
    turns into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_overrides(base):
    anchors = [dict(cfg, anchor_strides=[2.0, 2.0, 0.0],
                    anchor_offsets=[1.0, -7.0, cfg["anchor_offsets"][2]])
               for cfg in yaml.safe_load(open(base))["model"]["rpn_head"][
                   "anchor_configs"]] if base == PV_RCNN else [dict(
                       sizes=[1.6, 3.9, 1.56], anchor_strides=[2.0, 2.0, 0.0],
                       anchor_offsets=[1.0, -7.0, -1.78],
                       rotations=[0.0, 1.57], matched_threshold=0.6,
                       unmatched_threshold=0.45)]
    model = {
        "voxelizer": {"point_cloud_range": RANGE, "voxel_size": VOXEL,
                      "max_num_voxels": [600, 900]},
        "middle_encoder": {"point_cloud_range": RANGE, "voxel_size": VOXEL},
        "backbone": {"layer_nums": [1, 1]},
        "rpn_head": {"point_cloud_range": RANGE, "voxel_size": VOXEL,
                     "num_proposals": 16, "nms_pre": 64,
                     "anchor_configs": anchors},
        "roi_head": {"grid_size": 2, "head_fc": [32, 32]},
    }
    if base == PV_RCNN:
        model["point_encoder"] = {"num_keypoints": 64,
                                  "point_cloud_range": RANGE,
                                  "voxel_size": VOXEL}
    return {"_base_": base, "model": model}


@pytest.fixture(scope="module", params=["pv_rcnn", "voxel_rcnn"])
def models(request, tmp_path_factory):
    base = PV_RCNN if request.param == "pv_rcnn" else VOXEL_RCNN
    path = tmp_path_factory.mktemp("cfg") / (request.param + "_tiny.yml")
    path.write_text(yaml.safe_dump(tiny_overrides(base)))
    jax_model = JaxConfig(path=str(path)).model
    # ±1/sqrt(fan_in) weights shrink the signal ~3x a layer: scale every
    # conv to keep the scene, as the CenterPoint-voxels parity test does
    randomise(jax_model, 0, GAIN)
    model = Config(path=str(path), device="cpu").model
    load_jax_params(model, flat_state(jax_model))
    return request.param, jax_model, model.eval()


@pytest.fixture(scope="module")
def jax_run(models):
    """The JAX model on one scan batch: stage 1, the proposals, the support
    set and test_forward."""
    _, jax_model, _ = models
    graphdef, state = nnx.split(jax_model)

    @jax.jit
    def infer(state, points):
        m = nnx.merge(graphdef, state)
        preds, bev, sparse_out = m._stage1(points, training=False)
        rois = m.rpn_head.proposals(preds)
        supports, _ = m._support_set(points, bev, sparse_out)
        stages = [(s.features, s.coords, s.mask) for s, _ in sparse_out[3]]
        return (preds, bev, stages, rois, supports,
                m.test_forward({"data": points}))

    pts = make_points(0)
    return (pts,) + tuple(jax.device_get(infer(state, jnp.asarray(pts))))


def _close(got, ref, tol=1e-4):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (err, tol)


def test_stage1_and_proposals_match_jax(models, jax_run):
    """Stage 1 (voxel means, SparseNet3D with its stage taps, backbone,
    neck, Anchor3DHead) and the proposals. Every valid stage row lies
    inside its grid, so every support row is compared."""
    name, _, model = models
    pts, preds, bev, stages, rois, _, _ = jax_run
    with torch.no_grad():
        got_preds, got_bev, got_stages = model._stage1(torch.from_numpy(pts),
                                                        False)
        got_rois = model.rpn_head.proposals(got_preds)
    assert got_bev.shape == (2, 8, 8, 320)
    _close(got_bev.numpy(), bev, 1e-5)
    for (st, _), (f, c, m) in zip(got_stages, stages):
        np.testing.assert_array_equal(st.coords.numpy(), np.asarray(c))
        np.testing.assert_array_equal(st.mask.numpy(), np.asarray(m))
        assert bool((st.coords[..., 0][st.mask] < st.grid[0]).all())
        _close(st.features.numpy(), f, 1e-5)
    assert np.asarray(stages[0][2])[0].all()       # the voxel cap binds
    k = 6 if name == "pv_rcnn" else 2
    assert got_preds["cls_preds"].shape == (2, 64 * k, k // 2)
    for key, ref in preds.items():
        np.testing.assert_allclose(got_preds[key].numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got_rois[2].numpy(), rois[2])
    np.testing.assert_allclose(got_rois[1].numpy(), rois[1], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_rois[0].numpy(), rois[0], rtol=1e-3,
                               atol=1e-3)
    assert (rois[2] >= 0).sum() >= 8
    if name == "pv_rcnn":
        assert len(set(rois[2][rois[2] >= 0])) > 1    # several classes


def test_proposals_on_identical_preds(models, jax_run):
    """`proposals` alone, on the JAX head's own outputs: decode, score
    top-k, blocked or one-shot suppress, -1 / 0 padding."""
    _, _, model = models
    _, preds, _, _, rois, _, _ = jax_run
    with torch.no_grad():
        got = model.rpn_head.proposals(
            {k: torch.from_numpy(np.asarray(v)) for k, v in preds.items()})
    assert got[0].shape == (2, 16, 7) and got[2].dtype == torch.int32
    np.testing.assert_array_equal(got[2].numpy(), rois[2])
    np.testing.assert_allclose(got[1].numpy(), rois[1], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), rois[0], rtol=1e-5, atol=1e-5)


def test_support_set_matches_jax(models, jax_run):
    """PV-RCNN: the keypoints (farthest-point indices on NaN-padded scans,
    the second scan shorter than the rest) equal, their features through
    bev_bilinear, the raw-point source and the four stage sources close.
    Voxel-RCNN: the last two stages' voxel centres and features."""
    name, _, model = models
    pts, _, _, _, _, supports, _ = jax_run
    with torch.no_grad():
        _, bev, stages = model._stage1(torch.from_numpy(pts), False)
        got = model._support_set(torch.from_numpy(pts), bev, stages)
    if name == "pv_rcnn":
        kp, kf, km = got
        assert kp.shape == (2, 64, 3) and kf.shape == (2, 64, 128)
        np.testing.assert_array_equal(kp.numpy(), supports[0])
        np.testing.assert_array_equal(km.numpy(), supports[2])
        _close(kf.numpy(), supports[1])
        assert np.abs(supports[1]).max() > 0
    else:
        assert len(got) == 2
        for (xyz, f, m), (rxyz, rf, rm) in zip(got, supports):
            np.testing.assert_array_equal(m.numpy(), rm)
            np.testing.assert_allclose(xyz.numpy(), rxyz, rtol=1e-6,
                                       atol=1e-6)
            _close(f.numpy(), rf, 1e-5)


def test_end_to_end_matches_jax(models, jax_run):
    """test_forward against the JAX model: labels equal, scores 1e-5, boxes
    1e-3."""
    _, _, model = models
    pts, _, _, _, _, _, out = jax_run
    got = model.test_forward({"data": torch.from_numpy(pts)})
    assert got["box3d_lidar"].shape == (2, 16, 7)
    np.testing.assert_array_equal(got["label_preds"].numpy(),
                                  out["label_preds"])
    np.testing.assert_allclose(got["scores"].numpy(), out["scores"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["box3d_lidar"].numpy(),
                               out["box3d_lidar"], rtol=1e-3, atol=1e-3)
    assert (out["scores"] >= 0).sum() >= 8


def test_training_raises_and_cpu_takes_no_kernel(models, monkeypatch):
    """Training runs on the CPU (a copy of the model, train mode, the
    config's AdamWOnecycle step with finite losses; the parity of the step
    against the JAX package is tests/test_torch_two_stage_train.py) and
    test_forward refuses a model in train mode; a CPU tensor never reaches
    the kernel library or its counters, in training or serving."""
    name, _, model = models

    def no_build():
        raise AssertionError("kernel library requested for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_build)
    before = dict(_build.LAUNCHES)
    trained = copy.deepcopy(model).train()
    opt = torch.optim.AdamW(trained.parameters(), lr=1e-3)
    pts = make_points(3, n=800)
    boxes = np.zeros((2, 3, 7), np.float32)
    boxes[..., :3] = [[4., 0., -1.6], [9., 3., -1.6], [12., -4., -1.6]]
    boxes[..., 3:6] = [1.6, 3.9, 1.56]
    labels = np.array([[0, 0, -1], [0, -1, -1]])
    losses = make_train_step()(trained, opt, {
        "data": torch.from_numpy(pts), "gt_boxes": torch.from_numpy(boxes),
        "gt_labels": torch.from_numpy(labels)})
    assert set(losses) == {"loss", "loss_rpn_cls", "loss_rpn_reg",
                           "loss_rcnn_cls", "loss_rcnn_reg"}
    assert all(np.isfinite(v.item()) for v in losses.values()), name
    with pytest.raises(RuntimeError, match="eval mode"):
        trained.test_forward({"data": torch.from_numpy(pts)})
    model.test_forward({"data": torch.from_numpy(pts)})
    assert _build.LAUNCHES == before


def test_three_class_anchors_match_jax():
    """The PV-RCNN config's anchors (3 classes x 2 rotations, differing z
    offsets) and their match thresholds against the JAX AnchorGenerator,
    element for element, in the head's (y, x, class, rotation) order."""
    cfg = yaml.safe_load(open(PV_RCNN))["model"]["rpn_head"]
    kw = dict(output_stride_factor=cfg["output_stride_factor"],
              point_cloud_range=cfg["point_cloud_range"],
              voxel_size=cfg["voxel_size"],
              anchor_configs=cfg["anchor_configs"])
    head = Anchor3DHead(num_classes=3, feature_channels=8, **kw)
    ref = JaxAnchorGenerator(**kw)
    assert head._anchors.shape == (200 * 176 * 6, 7)
    assert head.anchor_generator.num_anchors_per_loc == 6
    np.testing.assert_array_equal(head._anchors.numpy(), ref.anchors)
    np.testing.assert_array_equal(head.anchor_generator.matched_thresholds,
                                  ref.matched_thresholds)
    np.testing.assert_array_equal(head.anchor_generator.unmatched_thresholds,
                                  ref.unmatched_thresholds)
    a = head._anchors.reshape(200, 176, 6, 7)
    assert a[0, 0, :, 2].tolist() == pytest.approx(
        [-1.78, -1.78, -0.6, -0.6, -0.6, -0.6])
    assert "_anchors" not in head.state_dict()
    with pytest.raises(NotImplementedError, match="item 9"):
        Anchor3DHead(num_classes=3, feature_channels=8,
                     anchor_generator=dict(ranges=[], sizes=[]))


def test_roi_grid_head_matches_jax():
    """RoIGridHead at the config's widths on a 3^3 grid: grid points, the
    pooled features (one support set for every radius, and one per radius),
    the cls and reg outputs. Some RoIs lie away from every support point
    (empty balls pool to zero), some slots are all-zero boxes."""
    rng = np.random.default_rng(0)
    sxyz = rng.uniform([0, -8, -2], [16, 8, 1], (2, 300, 3)).astype(
        np.float32)
    smask = np.ones((2, 300), bool)
    smask[1, 120:] = False
    rois = np.zeros((2, 6, 7), np.float32)
    rois[..., :3] = rng.uniform([2, -6, -1.5], [14, 6, -0.5], (2, 6, 3))
    rois[..., 3:6] = rng.uniform([1.4, 3.2, 1.3], [2.0, 4.4, 1.8], (2, 6, 3))
    rois[..., 6] = rng.uniform(-np.pi, np.pi, (2, 6))
    rois[:, 4, :2] = 100.
    rois[:, 5] = 0.
    for in_ch in (128, [64, 32]):
        kw = dict(in_channels=in_ch, grid_size=3, mlps=(64, 64),
                  radii=(0.8, 1.6), nsamples=(16, 16), head_fc=(32, 32))
        jhead = JaxRoIGridHead(rngs=nnx.Rngs(1), **kw)
        randomise(jhead, 2)
        head = RoIGridHead(**kw)
        load_jax_params(head, flat_state(jhead))
        chans = in_ch if isinstance(in_ch, list) else [in_ch]
        feats = [rng.normal(size=(2, 300, c)).astype(np.float32)
                 for c in chans]
        sup = [(sxyz, f, smask) for f in feats]
        jsup = [tuple(map(jnp.asarray, s)) for s in sup]
        tsup = [tuple(map(torch.from_numpy, s)) for s in sup]
        if len(sup) == 1:
            jsup, tsup = jsup[0], tsup[0]
        np.testing.assert_allclose(
            head._grid_points(torch.from_numpy(rois)).numpy(),
            np.asarray(jax.vmap(jhead._grid_points)(jnp.asarray(rois))),
            rtol=1e-6, atol=1e-5)
        ref_cls, ref_reg = jhead(jnp.asarray(rois), jsup)
        with torch.no_grad():
            cls, reg = head.eval()(torch.from_numpy(rois), tsup)
        assert cls.shape == (2, 6) and reg.shape == (2, 6, 7)
        _close(cls.numpy(), ref_cls)
        _close(reg.numpy(), ref_reg)
        with torch.no_grad():
            pooled = head.pool(torch.from_numpy(rois), tsup)
        _close(pooled.numpy(), jhead.pool(jnp.asarray(rois), jsup))
        assert np.abs(np.asarray(ref_reg)).max() > 0


def test_bev_bilinear_and_vsa_match_jax():
    """bev_bilinear (the -0.5 cell offset, taps outside the map count as
    zero) and VoxelSetAbstraction on the model_cfg surface (per-source MLP
    widths and radii) with two stage sources, NaN-padded points."""
    rng = np.random.default_rng(3)
    bev = rng.normal(size=(2, 10, 12, 7)).astype(np.float32)
    xy = rng.uniform([-1, -9], [17.5, 9], (2, 50, 2)).astype(np.float32)
    xy[:, 0] = [0.1, -7.9]                # below the first cell centre
    xy[:, 1] = [16.0, 8.0]                # the far corner
    pc, vs = [0., -8., -2., 16., 8., 2.], [0.25, 0.25, 0.1]
    cell = [16. / 12 / 4, 16. / 10 / 4, 0.1]     # 12 x 10 cells at stride 4
    got = bev_bilinear(torch.from_numpy(bev), torch.from_numpy(xy), pc, cell,
                       4)
    ref = jax.vmap(lambda b, k: jax_bev_bilinear(b, k, pc, cell, 4))(
        jnp.asarray(bev), jnp.asarray(xy))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert (np.asarray(ref)[:, 10:] == 0).all(axis=-1).any()    # outside

    cfg = dict(num_keypoints=40, out_channels=24, sa_layer=dict(
        raw_points=dict(mlps=[[8, 8]], pool_radius=[0.4, 1.2],
                        nsample=[16, 8]),
        x_conv3=dict(mlps=[[12, 16]], pool_radius=[1.2, 2.4],
                     nsample=[16, 8]),
        x_conv4=dict(mlps=[[20, 24]], pool_radius=[2.4, 4.8],
                     nsample=[16, 8])))
    kw = dict(model_cfg=cfg, num_bev_features=7, bev_stride=8,
              point_cloud_range=pc, voxel_size=vs)
    jvsa = JaxVSA(rngs=nnx.Rngs(5), **kw)
    randomise(jvsa, 6)
    vsa = VoxelSetAbstraction(**kw)
    load_jax_params(vsa, flat_state(jvsa))
    assert vsa.stage_channels == [12, 20] and vsa.stage_radii == [2.4, 4.8]
    assert vsa.raw_nsample == 8 and vsa.prefuse_channels == 7 + 8 + 16 + 24
    pts = make_points(7, n=600)
    bev8 = rng.normal(size=(2, 8, 8, 7)).astype(np.float32)
    stages = []
    for c, v in ((12, 150), (20, 60)):
        sx = rng.uniform([0, -8, -2], [16, 8, 0], (2, v, 3)).astype(
            np.float32)
        sm = np.ones((2, v), bool)
        sm[1, v // 3:] = False
        stages.append((sx, rng.normal(size=(2, v, c)).astype(np.float32),
                       sm))
    ref = jvsa(jnp.asarray(pts), jnp.asarray(bev8),
               [tuple(map(jnp.asarray, s)) for s in stages],
               return_prefuse=True)
    with torch.no_grad():
        got = vsa.eval()(torch.from_numpy(pts), torch.from_numpy(bev8),
                         [tuple(map(torch.from_numpy, s)) for s in stages],
                         return_prefuse=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    _close(got[1].numpy(), ref[1])
    _close(got[3].numpy(), ref[3])
    assert got[1].shape == (2, 40, 24)


@pytest.mark.parametrize("path,cls", [(PV_RCNN, PVRCNN),
                                      (VOXEL_RCNN, VoxelRCNN)],
                         ids=["pv_rcnn", "voxel_rcnn"])
def test_kitti_config_builds_with_jax_shapes(path, cls):
    """The KITTI configs at full width: every parameter and running stat of
    the port filled from the JAX model, without running either."""
    model = Config(path=path, device="cpu").model
    assert isinstance(model, cls)
    assert model.middle_encoder.grid == (41, 1600, 1408)
    assert model.voxelizer.max_num_voxels_for(False) == 40000
    assert model.rpn_head._anchors.shape[0] == 200 * 176 * (
        6 if cls is PVRCNN else 2)
    assert model.roi_head.fc.layers[0].linear.weight.shape == (256, 27648)
    if cls is PVRCNN:
        pe = model.point_encoder
        assert pe.num_keypoints == 2048 and pe.prefuse_channels == 400
        assert pe.stage_radii == [0.8, 1.6, 3.2, 6.4]
    else:
        assert not hasattr(model, "point_encoder")
    load_jax_params(model, flat_state(JaxConfig(path=path).model))


def test_point_head_raises():
    """The KITTI config has no point head; with one given the port names
    the item that brings it."""
    cfg = Config(path=PV_RCNN, device="cpu")
    cfg.dic["model"]["point_head"] = 1
    with pytest.raises(NotImplementedError, match="item 8b"):
        cfg.model
