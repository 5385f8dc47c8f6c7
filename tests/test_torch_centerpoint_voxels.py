"""Port parity of CenterPoint-voxels serving on a tiny grid: the nuScenes
voxel config (configs/centerpoint/centerpoint_voxels_0075voxel_nuscenes_
10sweep.yml) with its real SparseResNet3D channel widths and its z extent of
41 layers (so the extra conv's z-only stride meets an odd depth, as at full
width), over 16 m x 16 m at 0.125 m (a 128 x 128 x 41 grid, BEV 16 x 16),
a voxel cap that binds, backbone layers cut to one per stage and two tasks
of 1 and 2 classes. The JAX model and the port are built from the same
YAML, the JAX weights (randomised eval BN) carried across, the same numpy
points through both; the JAX side runs its CPU path (gather + matmul sparse
convs, XLA dense BEV).

Tolerances: the sparse middle's BEV and stages 1e-5 of each tensor's
largest value (f32 sums of <= 27 * 128 products in another order, over 21
convs); head outputs 1e-4; end to end the same labels, scores 1e-4 and
boxes 1e-3, as the pillar parity tests.
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
from paddle3d_tpu.models.layers.sparse_layers import \
    MaskedBatchNorm as JaxMaskedBN
from paddle3d_tpu.models.layers.sparse_layers import \
    SparseConv3D as JaxSparseConv3D
from paddle3d_tpu.models.middle_encoders.sparse_resnet import \
    SparseNet3D as JaxSparseNet3D
from paddle3d_tpu.models.necks.second_fpn import SecondFPN as JaxSecondFPN
from paddle3d_tpu_torch.apis import Config
from paddle3d_tpu_torch.models.detection import CenterPoint
from paddle3d_tpu_torch.models.layers import (MaskedBatchNorm, SparseConv3D,
                                              SparseTensor)
from paddle3d_tpu_torch.models.middle_encoders import (SparseNet3D,
                                                       SparseResNet3D)
from paddle3d_tpu_torch.models.middle_encoders.sparse_resnet import _dense_bev
from paddle3d_tpu_torch.models.necks import SecondFPN
from paddle3d_tpu_torch.ops import _build, sorted_scatter
from paddle3d_tpu_torch.ops.voxelize import voxel_mean_batch
from paddle3d_tpu_torch.utils.convert import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOXELS = os.path.join(REPO, "configs", "centerpoint",
                      "centerpoint_voxels_0075voxel_nuscenes_10sweep.yml")
RANGE = [0., -8., -2., 16., 8., 2.]
VOXEL = [0.125, 0.125, 0.1]
GAIN = 3.0               # see the models fixture


def flat_state(module):
    """nnx parameters and running stats as {dotted path: numpy array}."""
    return {".".join(map(str, k)): np.asarray(getattr(v, "value", v))
            for kind in (nnx.Param, nnx.BatchStat)
            for k, v in nnx.state(module, kind).flat_state()}


def make_points(seed, b=2, n=4000):
    """Tiny-grid scans of (x, y, z, intensity, dt): ground returns, car-sized
    clusters, a few points at the top z (z >= 1.2 m: stage-4 layer 4, which
    the extra conv's stride maps out of the BEV), out-of-range and NaN-padded
    rows. The last scan keeps a tenth of its points (the rest NaN), so the
    voxel and stage caps bind on the first scan only: a cap drops the
    highest keys, and with them the top layer."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([0, -8, -2, 0, 0], [16, 8, -1.5, 1, .45], (b, n, 5))
    k = n // 2
    centers = rng.uniform([1, -7, -1.5], [15, 7, 0], (b, 8, 3))
    pick = rng.integers(0, 8, (b, k))
    pts[:, :k, :3] = np.take_along_axis(centers, pick[..., None], 1) + \
        rng.normal(0, [.8, .4, .3], (b, k, 3))
    pts[:, k:k + 40, 2] = rng.uniform(1.25, 1.99, (b, 40))
    pts[:, k + 40:k + 60, 0] = 17.0
    pts[:, -16:] = np.nan
    pts[-1, n // 10:k] = np.nan
    pts[-1, k + 60:] = np.nan
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


@pytest.fixture(scope="module")
def config_path(tmp_path_factory):
    dic = {
        "_base_": VOXELS,
        "model": {
            "voxelizer": {"point_cloud_range": RANGE, "voxel_size": VOXEL,
                          "max_num_voxels": [1200, 1500]},
            "middle_encoder": {"point_cloud_range": RANGE,
                               "voxel_size": VOXEL},
            "backbone": {"layer_nums": [1, 1]},
            "bbox_head": {"tasks": [
                dict(num_class=1, class_names=["car"]),
                dict(num_class=2, class_names=["truck", "bus"])]},
            "test_cfg": {"point_cloud_range": RANGE, "voxel_size": VOXEL,
                         "post_center_limit_range": [-2., -10., -10., 18.,
                                                     10., 10.],
                         "nms": {"nms_pre_max_size": 128,
                                 "nms_post_max_size": 32}},
        },
    }
    path = tmp_path_factory.mktemp("cfg") / "centerpoint_voxels_tiny.yml"
    path.write_text(yaml.safe_dump(dic))
    return str(path)


@pytest.fixture(scope="module")
def models(config_path):
    jax_model = JaxConfig(path=config_path).model
    rng = np.random.default_rng(0)
    for _, m in jax_model.iter_modules():
        if isinstance(m, (nnx.BatchNorm, JaxMaskedBN)):
            c = m.mean.value.shape
            m.mean.value = jnp.asarray(rng.normal(0, .2, c), jnp.float32)
            m.var.value = jnp.asarray(rng.uniform(.5, 2., c), jnp.float32)
        # ±1/sqrt(fan_in) weights shrink the signal ~3x a layer through 21
        # sparse and ~12 dense convs: scale every conv to keep the scene
        if isinstance(m, (nnx.Conv, nnx.ConvTranspose)):
            m.kernel.value = m.kernel.value * GAIN
        if isinstance(m, JaxSparseConv3D):
            m.weight.value = m.weight.value * GAIN
    jax_model.eval()
    model = Config(path=config_path, device="cpu").model
    load_jax_params(model, flat_state(jax_model))
    return jax_model, model.eval()


@pytest.fixture(scope="module")
def jax_run(models):
    """The JAX model on one scan batch: the voxel means, the middle
    encoder's BEV and stages, the neck features, head outputs and
    test_forward."""
    jax_model, _ = models
    graphdef, state = nnx.split(jax_model)
    vox = jax_model.voxelizer

    @jax.jit
    def infer(state, points):
        m = nnx.merge(graphdef, state)
        from paddle3d_tpu.ops.voxelize import voxel_mean_batch as vmean
        vm = vmean(points, vox.voxel_size, vox.point_cloud_range,
                   vox.max_num_points_in_voxel, vox.max_num_voxels_for(False),
                   m.voxel_encoder.in_channels)
        bev, stages = m.middle_encoder(vm[0], vm[1], vm[3],
                                       return_stages=True)
        feats = m.neck(m.backbone(bev))
        preds = m.bbox_head(feats)
        stages = [(s.features, s.coords, s.mask) for s, _ in stages]
        return (vm, bev, stages, feats, preds,
                m.bbox_head.predict(preds, m.test_cfg))

    pts = make_points(0)
    return (pts,) + tuple(jax.device_get(infer(state, jnp.asarray(pts))))


def _close(got, ref, tol):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), (err, tol)


def test_middle_encoder_matches_jax(models, jax_run):
    """SparseResNet3D at its real widths: every stage's active set bit for
    bit (the capacities bind), its features and the dense BEV."""
    _, model = models
    _, vm, bev, stages, _, _, _ = jax_run
    feats, coords, num, mask = (torch.from_numpy(np.array(a)) for a in vm)
    assert bool(mask[0].all()) and not mask[1].all()   # the voxel cap
    with torch.no_grad():
        got_bev, got_stages = model.middle_encoder(feats, coords, mask,
                                                   return_stages=True)
    assert got_bev.shape == (2, 16, 16, 256) and bev.shape == got_bev.shape
    _close(got_bev.numpy(), bev, 1e-5)
    assert [s for _, s in got_stages] == [1, 2, 4, 8]
    full = 0
    for (st, _), (f, c, m) in zip(got_stages, stages):
        np.testing.assert_array_equal(st.coords.numpy(), np.asarray(c))
        np.testing.assert_array_equal(st.mask.numpy(), np.asarray(m))
        _close(st.features.numpy(), f, 1e-5)
        full += int(np.asarray(m)[0].all())
    assert full >= 2                              # stage capacities bind
    assert (np.abs(np.asarray(bev)) > 0).mean() > 0.05


def test_top_z_voxels_leave_the_bev(models, jax_run):
    """The reference quirk: the extra conv's z-only stride 2 on a depth of
    5 sends stage-4 layer 4 to z = 2 >= D = 2; those rows stay valid in the
    sparse tensor and the dense BEV drops them (keys >= D*H*W), as both JAX
    routes do."""
    _, model = models
    _, _, bev, stages, _, _, _ = jax_run
    f, c, m = (torch.from_numpy(np.array(a)) for a in stages[3])
    assert bool(((c[..., 0] == 4) & m).any())     # the top points arrived
    with torch.no_grad():
        out = model.middle_encoder.extra(SparseTensor(f, c, m, (5, 16, 16)))
    assert out.grid == (2, 16, 16)
    top = (out.coords[..., 0] == 2) & out.mask
    assert bool(top.any()) and bool(out.features[top].abs().sum() > 0)
    kept = out._replace(mask=out.mask & ~top)
    with torch.no_grad():
        torch.testing.assert_close(_dense_bev(out), _dense_bev(kept),
                                   rtol=0, atol=0)


def test_end_to_end_matches_jax(models, jax_run, monkeypatch):
    """test_forward of the port (VoxelMean → SparseResNet3D → SecondBackbone
    → SecondFPN at upsample strides [1, 2] → CenterHead → decode + NMS)
    against the JAX model, NaN padding and the top-z quirk included; the
    dense BEV goes through the port's sorted segment sum."""
    _, model = models
    pts, _, _, _, feats, preds, out = jax_run
    calls = []
    fn = sorted_scatter.sorted_segment_sum
    monkeypatch.setattr(sorted_scatter, "sorted_segment_sum",
                        lambda *a: calls.append(a[2]) or fn(*a))
    with torch.no_grad():
        got_feats = model._extract_feats(torch.from_numpy(pts), False)
    assert calls == [2 * 16 * 16]
    _close(got_feats.permute(0, 2, 3, 1).numpy(), feats, 1e-4)
    with torch.no_grad():
        got_preds = model.bbox_head(got_feats)
    for task_got, task_ref in zip(got_preds, preds):
        for k, ref in task_ref.items():
            np.testing.assert_allclose(task_got[k].numpy(), np.asarray(ref),
                                       rtol=1e-4, atol=1e-4)
    got = model.test_forward({"data": torch.from_numpy(pts)})
    assert got["box3d_lidar"].shape == (2, 64, 9)
    np.testing.assert_array_equal(got["label_preds"].numpy(),
                                  out["label_preds"])
    np.testing.assert_allclose(got["scores"].numpy(), out["scores"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["box3d_lidar"].numpy(),
                               out["box3d_lidar"], rtol=1e-3, atol=1e-3)
    kept = out["scores"] >= 0
    assert kept.sum() > 0 and {0, 1, 2} & set(out["label_preds"][kept])


def test_voxel_mean_inputs_match_jax(jax_run, models):
    """The fused voxelize + mean at the model's own settings: 10 points a
    voxel, the test cap of 1,500 voxels binding."""
    _, model = models
    pts, vm = jax_run[0], jax_run[1]
    vox = model.voxelizer
    got = voxel_mean_batch(torch.from_numpy(pts), vox.voxel_size,
                           vox.point_cloud_range, vox.max_num_points_in_voxel,
                           vox.max_num_voxels_for(False),
                           model.voxel_encoder.in_channels)
    for g, r in zip(got[1:], vm[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_allclose(got[0].numpy(), vm[0], rtol=1e-6, atol=1e-6)


def test_voxel_config_builds_with_jax_shapes():
    """The nuScenes voxel config at full width: every parameter and running
    stat of the port (SparseConv3D weights [27·Cin, Cout], MaskedBatchNorm
    scale / bias / mean / var, the dense stack) filled from the JAX model,
    without running it."""
    model = Config(path=VOXELS, device="cpu").model
    assert isinstance(model, CenterPoint)
    me = model.middle_encoder
    assert isinstance(me, SparseResNet3D) and me.grid == (41, 1440, 1440)
    assert model.down_ratio == 8 and model.bbox_head.with_velocity
    assert model.test_cfg["point_cloud_range"][0] == -54.0
    assert model.voxelizer.max_num_voxels_for(False) == 160000
    assert me.conv4[1].conv2.weight.shape == (27 * 128, 128)
    load_jax_params(model, flat_state(JaxConfig(path=VOXELS).model))
    names = {k for k in model.state_dict() if "middle_encoder" in k}
    assert "middle_encoder.conv_input.bn.running_var" in names
    assert "middle_encoder.conv1.0.conv1.bias" in names


def test_sparse_net3d_matches_jax():
    """SparseNet3D (the SECOND-style middle of the PV-RCNN and Voxel-RCNN
    configs) on a 21 x 64 x 64 grid, weights and eval BN stats carried
    across: the BEV and every stage. Depth 5 strides to 2, so stage-3
    layer 4 lands on z = 2 >= D at stage 4: those rows stay valid, and the
    subm conv after them writes them as zero, as the JAX package's kernel
    route does (its CPU gather route computes them); the BEV drops them on
    every route."""
    rng_, vs = (0., -8., -2., 16., 8., 2.), (0.25, 0.25, 0.2)
    kw = dict(in_channels=4, voxel_size=vs, point_cloud_range=rng_,
              stage_capacities=(900, 500, 300, 200))
    jnet = JaxSparseNet3D(rngs=nnx.Rngs(1), **kw)
    rng = np.random.default_rng(2)
    for _, m in jnet.iter_modules():
        if isinstance(m, JaxMaskedBN):
            c = m.mean.value.shape
            m.mean.value = jnp.asarray(rng.normal(0, .2, c), jnp.float32)
            m.var.value = jnp.asarray(rng.uniform(.5, 2., c), jnp.float32)
        if isinstance(m, JaxSparseConv3D):
            m.weight.value = m.weight.value * GAIN
    jnet.eval()
    net = SparseNet3D(**kw)
    load_jax_params(net, flat_state(jnet))
    pts = torch.from_numpy(make_points(4, n=2000))
    feats, coords, _, mask = voxel_mean_batch(pts, vs, rng_, 5, 900, 4)
    ref_bev, ref_stages = jnet(jnp.asarray(feats.numpy()),
                               jnp.asarray(coords.numpy()),
                               jnp.asarray(mask.numpy()), return_stages=True)
    with torch.no_grad():
        bev, stages = net.eval()(feats, coords, mask, return_stages=True)
    assert net.grid == (21, 64, 64) and bev.shape == (2, 8, 8, 64 * 2)
    _close(bev.numpy(), ref_bev, 1e-5)
    for (st, k), (rst, rk) in zip(stages, ref_stages):
        assert k == rk
        np.testing.assert_array_equal(st.coords.numpy(),
                                      np.asarray(rst.coords))
        inside = (st.coords[..., 0] < st.grid[0]).numpy()
        _close(st.features.numpy()[inside],
               np.asarray(rst.features)[inside], 1e-5)
        assert not st.features.numpy()[~inside].any()
    assert bool((st.mask & (st.coords[..., 0] >= st.grid[0])).any())
    assert np.abs(np.asarray(ref_bev)).max() > 0


def test_second_fpn_stride_one_matches_jax():
    """SecondFPN with upsample strides [1, 2] (a stride-1 transposed conv,
    which no pillar config has), weights and eval BN stats carried
    across."""
    jax_fpn = JaxSecondFPN(in_channels=(128, 256), out_channels=(256, 256),
                           upsample_strides=(1, 2), rngs=nnx.Rngs(3))
    rng = np.random.default_rng(1)
    for _, bn in jax_fpn.iter_modules():
        if isinstance(bn, nnx.BatchNorm):
            c = bn.mean.value.shape
            bn.mean.value = jnp.asarray(rng.normal(0, .2, c), jnp.float32)
            bn.var.value = jnp.asarray(rng.uniform(.5, 2., c), jnp.float32)
    jax_fpn.eval()
    fpn = SecondFPN(in_channels=(128, 256), out_channels=(256, 256),
                    upsample_strides=(1, 2))
    load_jax_params(fpn, flat_state(jax_fpn))
    xs = [rng.normal(size=(2, 12, 12, 128)).astype(np.float32),
          rng.normal(size=(2, 6, 6, 256)).astype(np.float32)]
    ref = np.asarray(jax_fpn([jnp.asarray(x) for x in xs]))
    with torch.no_grad():
        got = fpn.eval()([torch.from_numpy(x).permute(0, 3, 1, 2)
                          for x in xs])
    assert got.shape == (2, 512, 12, 12)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=1e-4, atol=1e-4)


def test_training_raises(config_path, monkeypatch):
    """A voxel CenterPoint trains (its parity with the JAX step:
    tests/test_torch_centerpoint_voxels_train.py): on CPU tensors its train
    step reaches no kernel library and moves no launch counter, and its
    canvas raises when the entry point's flag and the modules' mode
    disagree (the sparse layers take their route and BN from the mode).
    The layers in train mode: the sparse conv takes the gather route and
    refuses a fused epilogue, MaskedBatchNorm takes batch statistics over
    the valid rows."""
    def no_build():
        raise AssertionError("kernel library requested for a CPU tensor")

    model = Config(path=config_path, device="cpu").model
    pts = torch.from_numpy(make_points(6))
    with pytest.raises(RuntimeError, match="train mode"):
        model.eval().train_forward({"data": pts})
    monkeypatch.setattr(_build, "library", no_build)
    before = dict(_build.LAUNCHES)
    boxes = torch.tensor([[[6., 2., -1.6, 1.9, 4.4, 1.6, .3, 1., 0.]]] * 2)
    losses = model.train().train_forward({
        "data": pts, "gt_boxes": boxes,
        "gt_labels": torch.tensor([[0], [2]])})
    losses["loss"].backward()
    assert _build.LAUNCHES == before and torch.isfinite(losses["loss"])
    assert model.middle_encoder.conv_input.conv.weight.grad.abs().max() > 0

    conv = SparseConv3D(4, 16, generator=torch.Generator().manual_seed(0))
    st = SparseTensor(torch.randn(1, 3, 4), torch.tensor([[[0, 0, 0],
                                                           [0, 0, 1],
                                                           [1, 2, 2]]],
                                                         dtype=torch.int32),
                      torch.tensor([[True, True, False]]), (4, 4, 4))
    with pytest.raises(ValueError, match="epilogue"):
        conv.train()(st, relu=True)
    out = conv(st)
    assert out.features.shape == (1, 3, 16) and out.features.requires_grad
    assert not out.features[0, 2].any()
    bn = MaskedBatchNorm(16).train()
    y = bn(out.features, st.mask)
    torch.testing.assert_close(y[0, :2].mean(dim=0), bn.bias.expand(16))
    assert not y[0, 2].any()


def test_cpu_forward_takes_no_kernel(models, monkeypatch):
    """A CPU tensor never reaches the kernel library or its counters."""
    def no_build():
        raise AssertionError("kernel library requested for a CPU tensor")

    _, model = models
    monkeypatch.setattr(_build, "library", no_build)
    before = dict(_build.LAUNCHES)
    model.test_forward({"data": torch.from_numpy(make_points(3, n=1000))})
    assert _build.LAUNCHES == before
