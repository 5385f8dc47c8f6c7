"""Port parity of BEVFusion (pillars + camera, lidar-only, camera-only): the
[V, P, C] hard voxelization, the buffer PillarFeatureNet, PointPillarsScatter
and its VJP, the camera BEV's bilinear resize, the depth-distribution loss,
tiny BEVFusion models end to end (serving, and train steps) and the three
nuScenes configs' state, on the CPU against the JAX package, with inputs
made from a seed by numpy.

The JAX models are built abstractly (nnx.eval_shape) and filled from a
seed by numpy (tests/test_torch_petr.py's seeded_state);
utils/convert.load_jax_params carries the state across. The tiny models
are tests/models/test_bevfusion.py's (pillars of 0.5 m onto 32 x 32 cells,
a voxel cap of 100, a one-layer PFN of 16, SecondBackbone + SecondFPN,
ResNet-18 at base 8 to C4, an LSS of 8 depth bins onto the same 32 x 32
grid, SE fusion to 32 channels, a one-class CenterHead), under
chip_smoke.bevdet_rig's tilted cameras. The lidar and camera BEVs have the
same grid there (and in every config of the repo: 200 x 200), so the
models never resize; the resize is held alone, growing and shrinking.

Tolerances and why:
  * hard_voxelize: every output index for index (buffers bit for bit);
  * the buffer PFN: 1e-6 of the largest value in eval mode in f32 (CPU
    matmul sums); in train mode in f64, 1e-10 and the running stats 1e-10
    (flax's fast variance E[x^2] - E[x]^2 against torch's two-pass one:
    in f32 that alone moves the outputs by 2.4e-5 over 12,800 slots);
  * the scatter: bit for bit, and its VJP bit for bit (a gather);
  * the resize: 1e-6 of the largest value;
  * the depth loss: 1e-6 of its value (f32 logs);
  * test_forward: labels equal, scores 1e-5, boxes 1e-4 of the largest
    value (CPU convolutions summed in other orders);
  * the L+C train step in f64 on both sides: losses 1e-8 of their value,
    gradients 2e-7 of each tensor's largest value (the port's gaussian
    heatmaps are f32, as in tests/test_torch_caddn.py; measured 1.05e-7,
    a camera BN scale), the PFN's against the JAX PFN run op by op (see
    the test), running stats
    1e-10 (the fast variance, in f64); the lidar-only and camera-only
    steps' losses against the JAX forward's in f32, 1e-5 of their value.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import chip_smoke
from paddle3d_tpu.apis.config import Config as JaxConfig
from paddle3d_tpu.models.backbones import ResNet as JaxResNet
from paddle3d_tpu.models.backbones import SecondBackbone as JaxSecondBackbone
from paddle3d_tpu.models.detection import BEVFusion as JaxBEVFusion
from paddle3d_tpu.models.detection import CenterHead as JaxCenterHead
from paddle3d_tpu.models.middle_encoders import \
    PointPillarsScatter as JaxScatter
from paddle3d_tpu.models.necks import SecondFPN as JaxSecondFPN
from paddle3d_tpu.models.transformers import \
    LSSViewTransformer as JaxLSSViewTransformer
from paddle3d_tpu.models.voxel_encoders import \
    PillarFeatureNet as JaxPillarFeatureNet
from paddle3d_tpu.models.voxelizers import HardVoxelizer as JaxHardVoxelizer
from paddle3d_tpu.ops import voxelize as jax_voxelize
from paddle3d_tpu_torch.apis import Config, make_train_step
from paddle3d_tpu_torch.models.backbones import ResNet, SecondBackbone
from paddle3d_tpu_torch.models.detection import BEVFusion, CenterHead
from paddle3d_tpu_torch.models.detection.bevfusion import resize_bilinear
from paddle3d_tpu_torch.models.middle_encoders import PointPillarsScatter
from paddle3d_tpu_torch.models.necks import SecondFPN
from paddle3d_tpu_torch.models.transformers import LSSViewTransformer
from paddle3d_tpu_torch.models.voxel_encoders import PillarFeatureNet
from paddle3d_tpu_torch.models.voxelizers import HardVoxelizer
from paddle3d_tpu_torch.ops import sorted_scatter, voxelize
from paddle3d_tpu_torch.utils.convert import load_jax_params, to_torch_names
from tests.test_torch_bevdet import to_jax, to_torch
from tests.test_torch_petr import (abstract_shapes, check_state_names, close,
                                   flat_state, seeded_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "bevfusion")
PC = [-8., -8., -3., 8., 8., 3.]
VS = [0.5, 0.5, 6.0]
HW, CAMS = (64, 96), 2
GRID = dict(x=[-8., 8., 0.5], y=[-8., 8., 0.5], z=[-3., 3., 6.],
            depth=[1., 9., 1.])
TEST_CFG = dict(
    nms=dict(nms_pre_max_size=64, nms_post_max_size=8,
             nms_iou_threshold=0.2),
    score_threshold=0.05, point_cloud_range=PC, down_ratio=1,
    voxel_size=VS, post_center_limit_range=[-12., -12., -5., 12., 12., 5.])
HEAD = dict(in_channels=32, tasks=[dict(num_class=1, class_names=["car"])],
            weight=0.25, code_weights=[1.] * 8,
            common_heads=dict(reg=(2, 2), height=(1, 2), dim=(3, 2),
                              rot=(2, 2)), share_conv_channel=16)
LOSSES = {"loss", "hm_loss_0", "loc_loss_0"}


def build_tiny(jax_side, lidar=True, camera=True):
    """tests/models/test_bevfusion.py's BEVFusion in either package, with
    either stream left out."""
    if jax_side:
        kw = {"rngs": nnx.Rngs(0)}
        mods = (JaxHardVoxelizer, JaxPillarFeatureNet, JaxScatter,
                JaxSecondBackbone, JaxSecondFPN, JaxResNet,
                JaxLSSViewTransformer, JaxCenterHead, JaxBEVFusion)
    else:
        kw = {}
        mods = (HardVoxelizer, PillarFeatureNet, PointPillarsScatter,
                SecondBackbone, SecondFPN, ResNet, LSSViewTransformer,
                CenterHead, BEVFusion)
    vox, pfn, scat, sb, sfpn, res, lss, head, model = mods
    parts = {}
    if lidar:
        parts.update(
            lidar_voxelizer=vox(VS, PC, 8, 100),
            lidar_voxel_encoder=pfn(4, (16,), max_num_points_in_voxel=8,
                                    voxel_size=VS, point_cloud_range=PC,
                                    legacy=False, **kw),
            lidar_middle_encoder=scat(16, VS, PC),
            pts_backbone=sb(in_channels=16, out_channels=(16, 32),
                            layer_nums=(1, 1), downsample_strides=(1, 2),
                            **kw),
            pts_neck=sfpn(in_channels=(16, 32), out_channels=(8, 8),
                          upsample_strides=(1, 2), **kw))
    if camera:
        parts.update(
            img_backbone=res(depth=18, base_channels=8, out_indices=(2,),
                             **kw),
            img_view_transformer=lss(GRID, input_size=HW, downsample=16,
                                     in_channels=32, out_channels=16, **kw))
    return model(
        bbox_head=head(**HEAD, **kw), test_cfg=TEST_CFG,
        point_cloud_range=PC, voxel_size=VS, fusion_channels=32,
        lidar_channels=16 if lidar else 0,
        camera_channels=16 if camera else 0, se=True,
        camera_depth_range=[1.0, 9.0, 1.0],
        target_assign_cfg=dict(down_ratio=1, max_objs=8), **parts, **kw)


def jax_tiny(seed=0, **streams):
    return seeded_state(nnx.eval_shape(lambda: build_tiny(True, **streams)),
                        seed)


def port_tiny(state, **streams):
    model = build_tiny(False, **streams)
    load_jax_params(model, state)
    return model


def make_batch(seed=0, b=2, n_points=300):
    """Points uniform over the range (a tenth NaN, a tenth outside), images,
    the tilted bevdet_rig, two gt boxes a frame (one padded in frame 1),
    img_depth at the feature stride (D = 8)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-8, -8, -3, 0], [8, 8, 3, 1],
                      (b, n_points, 4)).astype(np.float32)
    pts[:, ::10] = np.nan
    pts[:, 5::10, 0] = 9.5
    batch = {"data": pts,
             "img": rng.uniform(0, 1, (b, CAMS) + HW + (3,)).astype(
                 np.float32)}
    batch.update(chip_smoke.bevdet_rig(HW, CAMS, b, tilt=0.02, bda_yaw=0.3))
    gt = np.zeros((b, 2, 7), np.float32)
    gt[..., :2] = rng.uniform(-6, 6, (b, 2, 2))
    gt[..., 2] = -1.5
    gt[..., 3:6] = [1.9, 4.6, 1.7]
    gt[..., 6] = rng.uniform(-3, 3, (b, 2))
    labels = np.zeros((b, 2), np.int64)
    labels[1, 1] = -1
    gt[1, 1] = 0
    batch.update(gt_boxes=gt, gt_labels=labels, img_depth=np.concatenate([
        rng.uniform(0.5, 9.5, (b, CAMS, 4, 6, 1)),
        rng.dirichlet(np.ones(8), (b, CAMS, 4, 6))], axis=-1).astype(
            np.float32))
    return batch


# ------------------------------------------------------------ voxelizer
def voxel_case(case):
    """-> (points [B, N, 4] f32, voxel_size, range, P, V)."""
    rng = np.random.default_rng({"overflow": 1, "padding": 2, "faces": 3,
                                 "nuscenes": 4}[case])
    if case == "overflow":      # both caps bind: 3 x 4 cells, 40 points
        pts = rng.uniform([0, 0, 0, 0], [1.5, 2, 1, 1], (2, 40, 4))
        return pts.astype(np.float32), (0.5, 0.5, 1.0), \
            (0., 0., 0., 1.5, 2., 1.), 3, 7
    if case == "padding":       # NaN rows, points outside every side
        pts = rng.uniform([-1, -1, -1, 0], [3, 3, 3, 1], (3, 64, 4))
        pts[:, ::7] = np.nan
        pts[1, 3, 2] = np.inf
        return pts.astype(np.float32), (0.5, 0.5, 0.5), \
            (0., 0., 0., 2., 2., 2.), 4, 20
    if case == "faces":         # points on cell faces and the range's edges
        lattice = np.stack(np.meshgrid(np.arange(0, 2.01, 0.25),
                                       np.arange(0, 2.01, 0.25),
                                       np.arange(0, 1.01, 0.5),
                                       indexing="ij"), -1).reshape(-1, 3)
        lattice = lattice[rng.permutation(len(lattice))]
        pts = np.concatenate([lattice, rng.uniform(0, 1, (len(lattice), 1))],
                             -1)[None]
        return pts.astype(np.float32), (0.25, 0.25, 0.5), \
            (0., 0., 0., 2., 2., 1.), 2, 1000
    # BEVFusion's pillars at the config's widths, a sweep cut to 4,000
    # points of 5 channels
    pts = rng.uniform([-55, -55, -6, 0, 0], [55, 55, 4, 1, .5], (2, 4000, 5))
    return pts.astype(np.float32), (0.25, 0.25, 8.0), \
        (-50., -50., -5., 50., 50., 3.), 64, 30000


@pytest.mark.parametrize("case", ["overflow", "padding", "faces",
                                  "nuscenes"])
def test_hard_voxelize_matches_jax_index_for_index(case):
    """hard_voxelize_batch against the JAX function: voxels, coords,
    num_points and the mask equal, element for element."""
    pts, vs, pc, p, v = voxel_case(case)
    ref = [np.asarray(x) for x in jax_voxelize.hard_voxelize_batch(
        jnp.asarray(pts), vs, pc, p, v)]
    got = [x.numpy() for x in voxelize.hard_voxelize_batch(
        torch.from_numpy(pts), vs, pc, p, v)]
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    mask, num = ref[3], ref[2]
    assert mask.any() and (num[mask] > 0).all()
    if case == "overflow":
        assert mask.all() and (num == p).any()


# ------------------------------------------------------ PFN and scatter
def pfn_inputs(seed=5):
    """The BEVFusion config's PFN widths (5 channels, [64, 64], P = 64) on
    a 2 x 100-voxel buffer of a voxelized sweep."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-50, -50, -5, 0, 0], [50, 50, 3, 1, .5],
                      (2, 3000, 5)).astype(np.float32)
    pts[:, :600, :2] = rng.uniform(-50, -49.5, (2, 600, 2))  # 4 dense pillars
    return [np.asarray(x) for x in jax_voxelize.hard_voxelize_batch(
        jnp.asarray(pts), (0.25, 0.25, 8.0), (-50., -50., -5., 50., 50., 3.),
        64, 100)]


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_buffer_pillar_feature_net_matches_jax(mode):
    """The buffer PillarFeatureNet (two layers: the half-width concat of
    the first) in eval mode in f32, and in train mode in f64 (BN
    statistics over every B * V * P slot, padding included) with its
    running stats."""
    kw = dict(in_channels=5, feat_channels=(64, 64),
              max_num_points_in_voxel=64, voxel_size=(0.25, 0.25, 8.0),
              point_cloud_range=(-50., -50., -5., 50., 50., 3.),
              legacy=False)
    jm, state = seeded_state(nnx.eval_shape(
        lambda: JaxPillarFeatureNet(rngs=nnx.Rngs(0), **kw)), 6)
    model = PillarFeatureNet(**kw)
    load_jax_params(model, state)
    voxels, coords, num, mask = pfn_inputs()
    assert (num == 64).any() and (num[mask] < 64).any()
    train = mode == "train"
    getattr(jm, mode)()
    getattr(model, mode)()
    with jax.enable_x64(train):
        dt = jnp.float64 if train else jnp.float32
        graphdef, st = nnx.split(jm)
        jm = nnx.merge(graphdef, jax.tree.map(
            lambda x: x.astype(dt) if x.dtype == jnp.float32 else x, st))
        ref = np.asarray(nnx.jit(lambda m, *a: m(*a))(
            jm, jnp.asarray(voxels, dt), jnp.asarray(num),
            jnp.asarray(coords)))
        stats = flat_state(jm)
    if train:
        model.double()
    got = model(torch.from_numpy(voxels).to(
        torch.float64 if train else torch.float32),
        torch.from_numpy(num), torch.from_numpy(coords))
    assert tuple(got.shape) == (2, 100, 64)
    close(got.detach().numpy(), ref, 1e-10 if train else 1e-6)
    if train:
        after = to_torch_names(model, {k: v for k, v in stats.items()
                                       if k.endswith((".mean", ".var"))})
        sd = model.state_dict()
        for name, v in after.items():
            close(sd[name].numpy(), v.numpy(), 1e-10)


def test_pillar_scatter_and_vjp_match_jax():
    """PointPillarsScatter on the voxelizer's output (the valid voxels in
    ascending key order, then padding) and its VJP under a seeded
    cotangent, bit for bit; at BEVFusion's widths the density rule sends
    the pillar scatter to K2 (30,000 or 40,000 rows onto 400 x 400 cells)
    and the camera pool to K7 (6 x 41 x 28 x 50 rows onto 200 x 200)."""
    voxels, coords, num, mask = pfn_inputs()
    feats = np.random.default_rng(7).normal(size=(2, 100, 64)).astype(
        np.float32) * mask[..., None]
    cot = np.random.default_rng(8).normal(size=(2, 400, 400, 64)).astype(
        np.float32)
    jscat = JaxScatter(64, (0.25, 0.25, 8.0), (-50., -50., -5., 50., 50., 3.))
    ref, vjp = jax.vjp(lambda f: jscat(f, jnp.asarray(coords),
                                       jnp.asarray(mask)), jnp.asarray(feats))
    ref_g = np.asarray(vjp(jnp.asarray(cot))[0])
    scat = PointPillarsScatter(64, (0.25, 0.25, 8.0),
                               (-50., -50., -5., 50., 50., 3.))
    f = torch.from_numpy(feats).requires_grad_()
    got = scat(f, torch.from_numpy(coords), torch.from_numpy(mask))
    got.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(f.grad.numpy(), ref_g)
    assert [sorted_scatter.kernel_for(v, 400 * 400)
            for v in (30000, 40000)] == ["sorted_segment_sum"] * 2
    assert sorted_scatter.kernel_for(6 * 41 * 28 * 50, 200 * 200) == \
        "sorted_segment_sum_dense"


@pytest.mark.parametrize("size", [(24, 40), (9, 13)])
def test_resize_bilinear_matches_jax_image_resize(size):
    """The camera BEV's resize onto the lidar grid, growing (16 x 20 ->
    24 x 40) and shrinking (antialiased: -> 9 x 13)."""
    x = np.random.default_rng(9).normal(size=(2, 16, 20, 3)).astype(
        np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2,) + size + (3,),
                                      method="bilinear"))
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), size)
    close(got.permute(0, 2, 3, 1).numpy(), ref, 1e-6)


@pytest.mark.parametrize("method", ["kld", "mse"])
def test_depth_dist_loss_matches_jax(method):
    """depth_dist_loss on seeded probabilities and targets, some patches'
    least depth outside camera_depth_range."""
    rng = np.random.default_rng(10)
    logits = rng.normal(size=(2, 3, 5, 6, 8))
    prob = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(
        np.float32)                                      # [B, N, h, w, D]
    tgt = np.concatenate([rng.uniform(0., 10., (2, 3, 5, 6, 1)),
                          rng.dirichlet(np.ones(8), (2, 3, 5, 6))],
                         -1).astype(np.float32)
    jm = nnx.eval_shape(lambda: build_tiny(True, lidar=False))
    jm.img_depth_loss_method = method
    ref = float(jm.depth_dist_loss(jnp.asarray(prob), jnp.asarray(tgt)))
    model = build_tiny(False, lidar=False)
    model.img_depth_loss_method = method
    got = model.depth_dist_loss(torch.from_numpy(prob).permute(
        0, 1, 4, 2, 3), torch.from_numpy(tgt)).item()
    close(got, ref, 1e-6)


# ------------------------------------------------------------------ model
STREAMS = {"lidar_camera": {}, "lidar": {"camera": False},
           "camera": {"lidar": False}}


@pytest.mark.parametrize("name", list(STREAMS))
def test_tiny_test_forward_matches_jax(name):
    """The tiny model's test_forward (eval BN, the eval voxel cap, decode +
    NMS) with both streams, the lidar stream alone and the camera stream
    alone."""
    jm, state = jax_tiny(**STREAMS[name])
    jm.eval()
    model = port_tiny(state, **STREAMS[name]).eval()
    batch = make_batch()
    ref = jax.device_get(nnx.jit(lambda m, b: m.test_forward(b))(
        jm, to_jax(batch)))
    got = model.test_forward(to_torch(batch))
    assert set(got) == set(ref)
    assert tuple(got["box3d_lidar"].shape) == (2, 8, 7)
    np.testing.assert_array_equal(got["label_preds"].numpy(),
                                  ref["label_preds"])
    close(got["scores"].numpy(), ref["scores"], 1e-5)
    close(got["box3d_lidar"].numpy(), ref["box3d_lidar"], 1e-4)
    assert (ref["scores"] > 0).any()


class _Probe(nnx.Module):
    """The JAX PFN with a zero parameter added to its output: its gradient
    is the cotangent the step hands the PFN."""

    def __init__(self, inner, shape):
        self.inner = inner
        self.probe = nnx.Param(jnp.zeros(shape, jnp.float64))

    def __call__(self, *args):
        return self.inner(*args) + self.probe


def test_tiny_train_step_matches_jax_in_f64():
    """train_forward of the L+C model in train mode (the train voxel cap,
    batch-statistics BN, the KLD depth loss): losses, every gradient and
    the running stats against the JAX step's, both in f64.

    The PFN's own gradients are held against the JAX PFN run op by op on
    the cotangent the jitted step hands it (read through _Probe). Under
    jit, XLA recomputes the PFN rows inside the masked max's VJP (which
    gives the gradient to the rows equal to the max) in another fusion
    and another rounding, so that some maxima no longer equal their rows
    and lose their gradient: the jitted JAX step's PFN gradients sit up
    to 90 % from its own op-by-op ones, which the port's equal to 1e-14."""
    jm, state = jax_tiny()
    jm.train()
    batch = make_batch(1)
    with jax.enable_x64():
        graphdef, st = nnx.split(jm)

        def as_f64():
            return nnx.merge(graphdef, jax.tree.map(
                lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32
                else x, st))
        jm64 = as_f64()
        jm64.lidar_voxel_encoder = _Probe(jm64.lidar_voxel_encoder,
                                          (2, 100, 16))
        jbatch = to_jax(batch, jnp.float64)

        @nnx.jit
        def grads_of(m, b):
            def loss_fn(m):
                losses = m.train_forward(b)
                return losses["loss"], losses
            return nnx.grad(loss_fn, has_aux=True)(m)

        grads, want = jax.device_get(grads_of(jm64, jbatch))
        stats = flat_state(jm64)
        cot = grads.lidar_voxel_encoder.probe[...]
        pfn = as_f64().lidar_voxel_encoder
        voxels, coords, num, _ = jm64.lidar_voxelizer(jbatch["data"], True)
        pfn_grads = nnx.grad(lambda m: jnp.sum(m(voxels, num, coords) * cot))(
            pfn)
    model = port_tiny(state).double().train()
    got = model.train_forward(to_torch(batch, torch.float64))
    got["loss"].backward()
    assert set(got) == set(want) == LOSSES | {"img_depth_loss"}
    for key in want:
        close(got[key].item(), want[key], 1e-8)
    assert want["img_depth_loss"] > 0
    flat = {".".join(map(str, k)): np.asarray(v[...])
            for k, v in nnx.state(grads, nnx.Param).flat_state()
            if k[0] != "lidar_voxel_encoder"}
    flat.update({"lidar_voxel_encoder." + ".".join(map(str, k)):
                 np.asarray(v[...])
                 for k, v in nnx.state(pfn_grads, nnx.Param).flat_state()})
    ref = to_torch_names(model, flat)
    assert set(ref) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        if p.grad is None:          # ResNet stage 3, whose output is unused
            assert name.startswith("img_backbone.stages.3."), name
            assert not ref[name].numpy().any(), name
        else:
            close(p.grad.numpy(), ref[name].numpy(), 2e-7)
    after = to_torch_names(model, {
        k.replace(".inner.", "."): v for k, v in stats.items()
        if k.endswith((".mean", ".var"))})
    sd = model.state_dict()
    for name, v in after.items():
        close(sd[name].numpy(), v.numpy(), 1e-10)


@pytest.mark.parametrize("name", ["lidar", "camera"])
def test_tiny_one_stream_train_step(name):
    """One train step (make_train_step, AdamW) of the lidar-only and the
    camera-only model: its losses against the JAX train_forward's in f32,
    every gradient finite, the parameters moved. (The camera-only model
    has the depth loss; the lidar-only one has none.)"""
    jm, state = jax_tiny(**STREAMS[name])
    jm.train()
    batch = make_batch(2)
    want = jax.device_get(nnx.jit(lambda m, b: m.train_forward(b))(
        jm, to_jax(batch)))
    model = port_tiny(state, **STREAMS[name]).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    got = make_train_step()(model, opt, to_torch(batch))
    assert set(got) == set(want) == LOSSES | (
        {"img_depth_loss"} if name == "camera" else set())
    for key in want:
        close(got[key].item(), want[key], 1e-5)
    assert all(bool(torch.isfinite(p.grad).all())
               for p in model.parameters())
    moved = [k for k, v in model.state_dict().items()
             if v.is_floating_point() and not torch.equal(v, before[k])]
    assert any(k.startswith("fuse_conv.") for k in moved)


def test_bevfusion_refusals():
    """The anchor-head branch and the MVX image hooks raise, naming item
    9; test_forward refuses train mode; postprocess_to_samples, no longer
    refused, is CenterPoint's."""
    parts = dict(test_cfg=TEST_CFG, point_cloud_range=PC, voxel_size=VS,
                 fusion_channels=32, camera_channels=16,
                 img_backbone=ResNet(depth=18, base_channels=8,
                                     out_indices=(2,)),
                 img_view_transformer=LSSViewTransformer(
                     GRID, input_size=HW, downsample=16, in_channels=32,
                     out_channels=16))
    with pytest.raises(NotImplementedError, match="item 9"):
        BEVFusion(bbox_head=object(), **parts)
    with pytest.raises(NotImplementedError, match="item 9"):
        BEVFusion(bbox_head=CenterHead(**HEAD), img_rpn_head=object(),
                  **parts)
    model = BEVFusion(bbox_head=CenterHead(**HEAD), **parts).train()
    with pytest.raises(RuntimeError, match="eval"):
        model.test_forward(to_torch(make_batch()))
    # postprocess_to_samples, once refused (item 5), is CenterPoint's,
    # as in the JAX package: no meta, no sample
    assert BEVFusion.postprocess_to_samples(
        {"box3d_lidar": np.zeros((0, 4, 9)), "scores": np.zeros((0, 4)),
         "label_preds": np.zeros((0, 4))}, []) == []


# --------------------------------------------------------------- configs
@pytest.mark.parametrize("name", ["bevf_pp_nuscenes", "bevf_lidar_nuscenes",
                                  "bevf_cam_nuscenes"])
def test_config_builds_with_jax_state(name):
    """The three nuScenes configs (the two variants through _base_ and
    _inherited_) through both packages' Config, the port's on the meta
    device: the parameter count and every state name and shape, and the
    streams, grids and caps."""
    path = os.path.join(CFG, name + ".yml")
    jm = nnx.eval_shape(lambda: JaxConfig(path=path).model)
    with torch.device("meta"):
        model = Config(path=path, device="meta").model
    check_state_names(model, abstract_shapes(jm))
    assert (model.lidar_voxelizer is None) == (jm.lidar_voxelizer is None) \
        == (name == "bevf_cam_nuscenes")
    assert (model.img_view_transformer is None) == \
        (jm.img_view_transformer is None) == (name == "bevf_lidar_nuscenes")
    if model.lidar_voxelizer is not None:
        vox = model.lidar_voxelizer
        assert vox.max_num_voxels == [30000, 40000]
        assert vox.max_num_points_in_voxel == 64
        assert (model.lidar_middle_encoder.ny,
                model.lidar_middle_encoder.nx) == (400, 400)
    if model.img_view_transformer is not None:
        vt, jvt = model.img_view_transformer, jm.img_view_transformer
        assert (vt.grid_size, vt.D, vt.h_feat, vt.w_feat) == (
            jvt.grid_size, jvt.D, jvt.h_feat, jvt.w_feat) == (
                (200, 200, 1), 41, 28, 50)
    assert model.test_cfg == jm.test_cfg
    assert model.bbox_head.num_classes == [1, 2, 2, 1, 2, 2]
    assert model.seblock is not None and model.camera_depth_range == \
        jm.camera_depth_range


def test_chip_smoke_img_depth_copies_the_dataset_math():
    """chip_smoke.bevfusion_img_depth's per-patch depth target, built from
    its own depth maps, against the JAX dataset's _gaussian_depth_targets
    (paddle3d_tpu/datasets/nuscenes/nuscenes_multi_modality.py:58-94) on
    the same maps, frame by frame: 1e-6 (both f64 numpy, cast to f32)."""
    from paddle3d_tpu.datasets.nuscenes.nuscenes_multi_modality import \
        NuscenesMMDataset
    hw, stride, rng = (64, 96), 16, (1.0, 9.0, 1.0)
    mats = {k: torch.from_numpy(v) for k, v in chip_smoke.bevdet_rig(
        hw, CAMS, 2, tilt=0.02).items()}
    scans = np.random.default_rng(11).uniform(
        [-20, -20, -3], [20, 20, 3], (2, 800, 3)).astype(np.float32)
    scans[:, ::50] = np.nan
    got = chip_smoke.bevfusion_img_depth(scans, mats, hw, stride, rng)
    maps = chip_smoke.depth_maps(scans, mats, hw, 1.0)

    class Frame:
        depth_stride, cam_depth_range, constant_std = stride, list(rng), None

        def __init__(self, full):
            self.full = full

        def _depth_maps(self, lidar_sd, lidar2imgs):
            return self.full
    assert got.shape == (2, CAMS, 4, 6, 9)
    for i in range(2):
        ref = NuscenesMMDataset._gaussian_depth_targets(Frame(maps[i]), None,
                                                        None)
        close(got[i], ref, 1e-6)
    md = got[..., 0]
    assert 0.05 < ((md >= 1) & (md <= 9)).mean() < 1
