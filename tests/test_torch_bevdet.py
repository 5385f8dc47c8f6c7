"""Port parity of BEVDet4D, the sixth camera model: the frustum geometry
(get_lidar_coor, the voxel ranks and validity), CustomResNet, FPN_LSS, the
LSS lift-splat pool and a tiny BEVDet4D end to end (serving with a
prev_bev state, one train step with an adjacent frame) on the CPU against
the JAX package, with inputs made from a seed by numpy, and the full-width
config's state.

The JAX models are built abstractly (nnx.eval_shape) and filled from a
seed by numpy (tests/test_torch_petr.py's seeded_state); utils/convert
.load_jax_params carries the state across. The cameras are
chip_smoke.bevdet_rig's: tools/bench_camera.py's ring as BEVDet's test
pipeline hands it (the 450 x 800 image resized and cropped), tilted by a
small seeded rotation a camera and under a BEV yaw where the test says so,
so that every 3 x 3 product has three live terms.

Tolerances and why:
  * the frustum's points: bit for bit, and its rank and valid index for
    index, against the JAX functions under jit (the port computes in the
    arithmetic XLA compiles them to: ops/xla_arith);
  * feature maps (CustomResNet, FPN_LSS): 1e-5 of the largest value; CPU
    convolutions summed in other orders, jax.image.resize's bilinear as a
    weights product against torch's lerp;
  * the pool: 1e-6 of the largest value; JAX sorts unstably and adds by
    its sorted scatter, the port sorts stably: the rows of a cell are
    summed in another order;
  * test_forward: labels equal, scores 1e-5, boxes 1e-4, bev_feature 1e-5
    of the largest value;
  * the train step in f64 on both sides: losses within 1e-8 of their
    value, gradients 1e-7 of each tensor's largest value (the port's
    gaussian heatmaps are f32, as in tests/test_torch_caddn.py), running
    stats 1e-12.
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
from paddle3d_tpu.models.backbones import CustomResNet as JaxCustomResNet
from paddle3d_tpu.models.backbones import ResNet as JaxResNet
from paddle3d_tpu.models.detection import BEVDet as JaxBEVDet
from paddle3d_tpu.models.detection import CenterHead as JaxCenterHead
from paddle3d_tpu.models.necks import FPN_LSS as JaxFPN_LSS
from paddle3d_tpu.models.transformers import \
    LSSViewTransformer as JaxLSSViewTransformer
from paddle3d_tpu_torch.apis import Config
from paddle3d_tpu_torch.models.backbones import CustomResNet, ResNet
from paddle3d_tpu_torch.models.detection import BEVDet, CenterHead
from paddle3d_tpu_torch.models.necks import FPN_LSS
from paddle3d_tpu_torch.models.transformers import LSSViewTransformer
from paddle3d_tpu_torch.ops import sorted_scatter
from paddle3d_tpu_torch.utils.convert import load_jax_params, to_torch_names
from tests.test_torch_petr import (abstract_shapes, check_state_names, close,
                                   flat_state, seeded_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FULL = os.path.join(REPO, "configs", "bevdet",
                    "bevdet4d_r50_depth_nuscenes.yml")
HW, CAMS = (64, 96), 2          # the tiny model's images and cameras
GRID = dict(x=[-8., 8., 0.5], y=[-8., 8., 0.5], z=[-3., 3., 6.],
            depth=[1., 9., 1.])
TEST_CFG = dict(
    nms=dict(nms_pre_max_size=64, nms_post_max_size=8,
             nms_iou_threshold=0.2),
    score_threshold=0.05, point_cloud_range=[-8., -8., -3., 8., 8., 3.],
    down_ratio=1, voxel_size=[0.5, 0.5, 6.0],
    post_center_limit_range=[-12., -12., -5., 12., 12., 5.])
HEAD = dict(in_channels=16, tasks=[dict(num_class=1, class_names=["car"])],
            weight=0.25, code_weights=[1.] * 8,
            common_heads=dict(reg=(2, 2), height=(1, 2), dim=(3, 2),
                              rot=(2, 2)), share_conv_channel=16)


def build_tiny(jax_side):
    """tests/models/test_bevdet.py's BEVDet4D (ResNet-18 at base 8 to C4,
    8 depth bins onto a 32 x 32 grid of 16 channels, the previous frame's
    BEV concatenated, CustomResNet (32 -> 16, 32) + FPN_LSS, one-class
    CenterHead) in either package."""
    if jax_side:
        rngs = nnx.Rngs(0)
        kw = {"rngs": rngs}
        mods = (JaxResNet, JaxLSSViewTransformer, JaxCustomResNet,
                JaxFPN_LSS, JaxCenterHead, JaxBEVDet)
    else:
        kw = {}
        mods = (ResNet, LSSViewTransformer, CustomResNet, FPN_LSS,
                CenterHead, BEVDet)
    res, lss, cres, fpn, head, model = mods
    return model(
        img_backbone=res(depth=18, base_channels=8, out_indices=(2,), **kw),
        img_neck=None,
        img_view_transformer=lss(GRID, input_size=HW, downsample=16,
                                 in_channels=32, out_channels=16, **kw),
        img_bev_encoder_backbone=cres(32, num_layer=(1, 1),
                                      num_channels=(16, 32), stride=(1, 2),
                                      **kw),
        img_bev_encoder_neck=fpn(16 + 32, 16, **kw),
        bbox_head=head(**HEAD, **kw), test_cfg=TEST_CFG,
        target_assign_cfg=dict(down_ratio=1, max_objs=8), temporal=True)


@pytest.fixture(scope="module")
def tiny():
    jm, state = seeded_state(nnx.eval_shape(lambda: build_tiny(True)), 0)
    jm.eval()
    model = build_tiny(False)
    load_jax_params(model, state)
    return jm, state, model.eval()


def serve_batch(seed=0, b=2):
    rng = np.random.default_rng(seed)
    batch = {"img": rng.uniform(0, 1, (b, CAMS) + HW + (3,)).astype(
        np.float32)}
    batch.update(chip_smoke.bevdet_rig(HW, CAMS, b, tilt=0.02, bda_yaw=0.3))
    return batch


def train_batch(seed=1, b=2):
    batch = serve_batch(seed, b)
    rng = np.random.default_rng(seed + 10)
    batch["img_adj"] = rng.uniform(0, 1, batch["img"].shape).astype(
        np.float32)
    batch["rots_adj"] = batch["rots"]
    batch["trans_adj"] = batch["trans"] + np.float32(0.3)
    boxes = np.zeros((b, 4, 7), np.float32)
    boxes[..., :2] = rng.uniform(-6, 6, (b, 4, 2))
    boxes[..., 2] = rng.uniform(-2, -1, (b, 4))
    boxes[..., 3:6] = rng.uniform([1.5, 3.5, 1.4], [2.0, 4.5, 1.8], (b, 4, 3))
    boxes[..., 6] = rng.uniform(-3, 3, (b, 4))
    labels = np.zeros((b, 4), np.int64)
    labels[1, 3] = -1                           # a padded slot
    boxes[1, 3] = 0
    batch.update(gt_boxes=boxes, gt_labels=labels)
    return batch


def to_torch(batch, dtype=torch.float32):
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.to(dtype) if t.is_floating_point() else t
    return out


def to_jax(batch, dtype=jnp.float32):
    return {k: jnp.asarray(v).astype(dtype) if v.dtype == np.float32
            else jnp.asarray(v.astype(np.int32)) for k, v in batch.items()}


# ------------------------------------------------------------- geometry
def jax_ranks(vt, mats):
    """The JAX view transformer's frustum points, and its rank and valid as
    lift_splat computes them, under jit."""
    def run(m):
        coor = vt.get_lidar_coor(**m)
        gx, gy, gz = vt.grid_size
        vox = jnp.floor((coor - jnp.asarray(vt.grid_lower)) /
                        jnp.asarray(vt.grid_interval)).astype(jnp.int32)
        valid = ((vox[..., 0] >= 0) & (vox[..., 0] < gx) &
                 (vox[..., 1] >= 0) & (vox[..., 1] < gy) &
                 (vox[..., 2] >= 0) & (vox[..., 2] < gz))
        return coor, vox[..., 1] * gx + vox[..., 0], valid
    return [np.asarray(x) for x in jax.jit(run)(
        {k: jnp.asarray(v) for k, v in mats.items()})]


@pytest.mark.parametrize("case", ["tiny", "full_level", "full_tilted",
                                  "full_tilted_batch3"])
def test_lidar_coor_rank_and_valid_index_equal(case):
    """get_lidar_coor bit for bit, the rank and valid index for index,
    against the JAX functions under jit: the tiny grid (two frames, tilted
    cameras, a BEV yaw), and the full-width grid (128 x 128 at 0.8 m, 59
    bins over six 256 x 704 cameras: 249,216 rows) under chip_smoke's rig
    and tilted."""
    if case == "tiny":
        grid, hw, mats = GRID, HW, chip_smoke.bevdet_rig(
            HW, CAMS, 2, tilt=0.02, bda_yaw=0.3)
    else:
        grid = JaxConfig(path=FULL).dic["model"]["img_view_transformer"][
            "grid_config"]
        hw = chip_smoke.BEVDET_HW
        tilted = case != "full_level"
        mats = chip_smoke.bevdet_rig(
            hw, b=3 if case.endswith("batch3") else 1,
            tilt=0.02 if tilted else 0.0, bda_yaw=0.2 if tilted else 0.0)
    jv = nnx.eval_shape(lambda: JaxLSSViewTransformer(
        grid, input_size=hw, downsample=16, in_channels=8, out_channels=4,
        rngs=nnx.Rngs(0)))
    coor, rank, valid = jax_ranks(jv, mats)
    vt = LSSViewTransformer(grid, input_size=hw, downsample=16,
                            in_channels=8, out_channels=4)
    tm = {k: torch.from_numpy(v) for k, v in mats.items()}
    got = vt.get_lidar_coor(**tm).numpy()
    np.testing.assert_array_equal(got.view(np.int32), coor.view(np.int32))
    my_rank, my_valid = (x.numpy() for x in vt.frustum_ranks(**tm))
    np.testing.assert_array_equal(my_valid, valid)
    np.testing.assert_array_equal(np.where(valid, my_rank, -1),
                                  np.where(valid, rank, -1))
    assert 0.3 < valid.mean() < 1.0
    if case != "tiny":
        assert valid[0].size == 6 * 59 * 16 * 44
        assert sorted_scatter.kernel_for(valid[0].size, 128 * 128) == \
            "sorted_segment_sum_dense"


# ---------------------------------------------------------------- layers
def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def test_custom_resnet_and_fpn_lss_match_jax():
    """CustomResNet (three stages of two blocks, 16 -> 16, 32, 64, strides
    2) and FPN_LSS (the first and the last stage: a bilinear resize by 4)
    in eval mode on a 2 x 16 x 16 x 16 BEV."""
    def build(rngs):
        return (JaxCustomResNet(16, num_layer=(2, 2, 2),
                                num_channels=(16, 32, 64), rngs=rngs),
                JaxFPN_LSS(16 + 64, 24, rngs=rngs))
    (jres, jfpn), state = seeded_state(nnx.eval_shape(
        lambda: build(nnx.Rngs(0))), 3)
    res = CustomResNet(16, num_layer=(2, 2, 2), num_channels=(16, 32, 64))
    fpn = FPN_LSS(16 + 64, 24)
    load_jax_params(res, {k[2:]: v for k, v in state.items()
                          if k.startswith("0.")})
    load_jax_params(fpn, {k[2:]: v for k, v in state.items()
                          if k.startswith("1.")})
    jres.eval()
    jfpn.eval()
    x = np.random.default_rng(4).normal(size=(2, 16, 16, 16)).astype(
        np.float32)
    ref = nnx.jit(lambda r, f, x: (r(x), f(r(x))))(jres, jfpn,
                                                   jnp.asarray(x))
    with torch.no_grad():
        feats = res.eval()(nchw(x))
        out = fpn.eval()(feats)
    assert [tuple(f.shape) for f in feats] == [(2, 16, 8, 8), (2, 32, 4, 4),
                                               (2, 64, 2, 2)]
    for g, r in zip(feats, ref[0]):
        close(g.permute(0, 2, 3, 1).numpy(), np.asarray(r), 1e-5)
    assert tuple(out.shape) == (2, 24, 8, 8)
    close(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref[1]), 1e-5)


def test_lift_splat_matches_jax():
    """lift_splat on seeded depth probabilities and context features
    through the tiny rig (the pool of 2 x 384 rows onto 32 x 32 cells)."""
    jv = nnx.eval_shape(lambda: JaxLSSViewTransformer(
        GRID, input_size=HW, downsample=16, in_channels=8, out_channels=16,
        rngs=nnx.Rngs(0)))
    vt = LSSViewTransformer(GRID, input_size=HW, downsample=16,
                            in_channels=8, out_channels=16)
    rng = np.random.default_rng(5)
    b, n, h, w, d = 2, CAMS, 4, 6, 8
    logits = rng.normal(size=(b, n, d, h, w)).astype(np.float32)
    depth = np.exp(logits) / np.exp(logits).sum(axis=2, keepdims=True)
    feat = rng.normal(size=(b, n, 16, h, w)).astype(np.float32)
    mats = chip_smoke.bevdet_rig(HW, CAMS, b, tilt=0.02, bda_yaw=0.3)
    ref, ref_depth = jax.jit(lambda dp, f, m: jv.lift_splat(
        dp, f, (b, n, h, w), **m))(
            jnp.asarray(depth.transpose(0, 1, 3, 4, 2).reshape(
                b * n, h, w, d)),
            jnp.asarray(feat.transpose(0, 1, 3, 4, 2).reshape(
                b * n, h, w, 16)),
            {k: jnp.asarray(v) for k, v in mats.items()})
    got = vt.lift_splat(torch.from_numpy(depth), torch.from_numpy(feat),
                        **{k: torch.from_numpy(v) for k, v in mats.items()})
    assert tuple(got.shape) == (b, 32, 32, 16)
    close(got.numpy(), np.asarray(ref), 1e-6)
    assert (np.abs(np.asarray(ref)).sum(-1) > 0).mean() > 0.05


# ------------------------------------------------------------------ model
def test_tiny_test_forward_with_prev_bev_matches_jax(tiny):
    """The tiny BEVDet4D's test_forward with a prev_bev state (the decode
    + NMS, bev_feature: the current BEV then prev_bev)."""
    jm, _, model = tiny
    batch = serve_batch()
    batch["prev_bev"] = np.random.default_rng(6).normal(
        size=(2, 32, 32, 16)).astype(np.float32)
    ref = jax.device_get(nnx.jit(lambda m, b: m.test_forward(b))(
        jm, to_jax(batch)))
    got = model.test_forward(to_torch(batch))
    assert set(got) == set(ref)
    assert tuple(got["box3d_lidar"].shape) == (2, 8, 7)
    assert tuple(got["bev_feature"].shape) == (2, 32, 32, 32)
    np.testing.assert_array_equal(got["label_preds"].numpy(),
                                  ref["label_preds"])
    close(got["scores"].numpy(), ref["scores"], 1e-5)
    close(got["box3d_lidar"].numpy(), ref["box3d_lidar"], 1e-4)
    close(got["bev_feature"].numpy(), ref["bev_feature"], 1e-5)
    assert (ref["scores"] > 0).all()
    assert len(np.unique(ref["scores"])) == ref["scores"].size
    np.testing.assert_array_equal(got["bev_feature"][..., 16:].numpy(),
                                  batch["prev_bev"])


def test_tiny_train_forward_with_adjacent_frame_matches_jax_in_f64(tiny):
    """train_forward with an adjacent frame (encoded without gradient,
    its BN running stats updated after the current frame's) in train mode:
    losses, every gradient and the running stats against the JAX step's,
    both in f64."""
    _, state, _ = tiny
    batch = train_batch()
    jm, _ = seeded_state(nnx.eval_shape(lambda: build_tiny(True)), 0)
    jm.train()
    with jax.enable_x64():
        graphdef, st = nnx.split(jm)
        jm64 = nnx.merge(graphdef, jax.tree.map(
            lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32
            else x, st))

        @nnx.jit
        def grads_of(m, b):
            def loss_fn(m):
                losses = m.train_forward(b)
                return losses["loss"], losses
            return nnx.grad(loss_fn, has_aux=True)(m)

        grads, want = jax.device_get(grads_of(jm64, to_jax(batch,
                                                           jnp.float64)))
        stats = flat_state(jm64)
    model = build_tiny(False)
    load_jax_params(model, state)
    model.double().train()
    got = model.train_forward(to_torch(batch, torch.float64))
    got["loss"].backward()
    assert set(got) == set(want) == {"loss", "hm_loss_0", "loc_loss_0"}
    for key in want:
        close(got[key].item(), want[key], 1e-8)
    ref = to_torch_names(model, {
        ".".join(map(str, k)): np.asarray(v[...])
        for k, v in nnx.state(grads, nnx.Param).flat_state()})
    assert set(ref) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        if p.grad is None:          # ResNet stage 3, whose output is unused
            assert name.startswith("img_backbone.stages.3."), name
            assert not ref[name].numpy().any(), name
        else:
            close(p.grad.numpy(), ref[name].numpy(), 1e-7)
    after = to_torch_names(model, {k: v for k, v in stats.items()
                                   if k.endswith((".mean", ".var"))})
    sd = model.state_dict()
    for name, v in after.items():
        close(sd[name].numpy(), v.numpy(), 1e-12)


def test_bevdet_refuses_train_mode_serving(tiny):
    _, _, model = tiny
    model.train()
    try:
        with pytest.raises(RuntimeError, match="eval"):
            model.test_forward(to_torch(serve_batch()))
    finally:
        model.eval()
    # postprocess_to_samples, once refused (item 5), is CenterPoint's,
    # as in the JAX package: no meta, no sample
    assert BEVDet.postprocess_to_samples(
        {"box3d_lidar": np.zeros((0, 4, 9)), "scores": np.zeros((0, 4)),
         "label_preds": np.zeros((0, 4))}, []) == []


# --------------------------------------------------------------- configs
def test_full_config_builds_with_jax_state():
    """configs/bevdet/bevdet4d_r50_depth_nuscenes.yml through both
    packages' Config (the port's on the meta device): the state's names
    and shapes, load_jax_params filling every parameter and running stat
    from the JAX state's paths, and the view transformer's geometry."""
    jm = nnx.eval_shape(lambda: JaxConfig(path=FULL).model)
    with torch.device("meta"):
        model = Config(path=FULL, device="meta").model
    shapes = abstract_shapes(jm)
    check_state_names(model, shapes)
    load_jax_params(model, {k: np.zeros(s, np.float32)
                            for k, s in shapes.items()})
    vt, jvt = model.img_view_transformer, jm.img_view_transformer
    assert (vt.grid_size, vt.D, vt.h_feat, vt.w_feat) == (
        jvt.grid_size, jvt.D, jvt.h_feat, jvt.w_feat) == (
            (128, 128, 1), 59, 16, 44)
    assert model.num_adj == jm.num_adj == 1
    assert model.test_cfg == jm.test_cfg
    assert model.bbox_head.num_classes == [10]
