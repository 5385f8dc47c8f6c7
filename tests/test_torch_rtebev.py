"""Port parity of RTEBev, the ninth camera model: the BEVDepth depth nets
(DepthNet, MSDepthNet, the simplified SPPF, the camera BatchNorm), the
camera terms, the depth labels and loss, the frustum's ranks at RTEBev's
full shape, RTEBevHead's forward, hybrid loss and decode, a tiny RTEBev
end to end (serving with bev_adj, with img_adj and with neither; one
train step with an adjacent frame and a gt_depth), BEVDet's depth-loss
branch and the four positional encodings, on the CPU against the JAX
package, with inputs made from a seed by numpy; and both full configs'
state.

The JAX models are built abstractly (nnx.eval_shape) and filled from a
seed by numpy (tests/test_torch_petr.py's seeded_state); utils/convert
.load_jax_params carries the state across. The cameras are
chip_smoke.bevdet_rig's (tools/bench_camera.py's ring as BEVDet's test
pipeline hands it), tilted and under a BEV yaw where the test says so.

Tolerances and why:
  * the frustum's rank and valid, the depth labels: index for index (the
    port computes in XLA's compiled arithmetic, ops/xla_arith); the 27
    camera terms bit for bit;
  * the depth nets and feature maps in eval mode: 1e-5 of the largest
    value (CPU convolutions summed in other orders, jax.image.resize's
    bilinear against torch's); in train mode both sides run in f64: most
    of the 27 camera terms are the same for every camera, and the
    BatchNorm's E[x^2] - E[x]^2 of such a column is cancellation noise
    that depends on the summation order (in f32 up to ~0.1 where the
    true variance is 0, so its normalised column is noise of up to
    ~2e-2, on either side); in f64 that noise is ~1e-10, and outputs are
    held to 1e-9 of their largest value, running stats to 1e-12;
  * the head: its outputs 1e-5 (matmuls, LayerNorms and the deformable
    sampling's sums in other orders); the losses and decode on the JAX
    head's own outputs: losses 1e-6 relative, labels equal, scores and
    boxes 1e-6 (torch's and XLA's f32 sigmoid differ by an ulp);
  * test_forward: labels equal, scores 1e-5, boxes 1e-4 of the largest
    value;
  * the train step in f64, every Hungarian assignment equal; the
    attention softmax runs in f32 on both sides, so losses 1e-7 relative,
    grads 1e-5 of the larger of their tensor's largest value and 1e-3 of
    the step's largest grad, as PETR's step is held; running stats 1e-9
    of their largest value (the camera BatchNorm's variance noise, above);
  * the positional encodings: 1e-6 of the largest value (sin / cos of
    the same f32 arguments), the learned ones equal.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import chip_smoke
from paddle3d_tpu.apis.config import Config as JaxConfig
from paddle3d_tpu.models import backbones as jax_backbones
from paddle3d_tpu.models import necks as jax_necks
from paddle3d_tpu.models.detection import BEVDet as JaxBEVDet
from paddle3d_tpu.models.detection import CenterHead as JaxCenterHead
from paddle3d_tpu.models.detection import RTEBev as JaxRTEBev
from paddle3d_tpu.models.heads import RTEBevHead as JaxRTEBevHead
from paddle3d_tpu.models.heads import target_assigners as jax_ta
from paddle3d_tpu.models.transformers import bevdet_transformer as jax_bt
from paddle3d_tpu.models.transformers import positional_encoding as jax_pe
from paddle3d_tpu_torch.apis import Config
from paddle3d_tpu_torch.models.backbones import CustomResNet, ResNet
from paddle3d_tpu_torch.models.detection import BEVDet, CenterHead, RTEBev
from paddle3d_tpu_torch.models.heads import RTEBevHead, target_assigners
from paddle3d_tpu_torch.models.necks import FPN, FPN_LSS
from paddle3d_tpu_torch.models.transformers import (
    DepthNet, LearnedPositionalEncoding, LearnedPositionalEncoding3D,
    LSSViewTransformer, LSSViewTransformerBEVDepth, MSDepthNet,
    MSLSSViewTransformerBEVDepth, SinePositionalEncoding,
    SinePositionalEncoding3D)
from paddle3d_tpu_torch.models.transformers import bevdet_transformer
from paddle3d_tpu_torch.ops import sorted_scatter
from paddle3d_tpu_torch.utils.convert import load_jax_params, to_torch_names
from tests.test_torch_bevdet import HEAD, TEST_CFG, jax_ranks
from tests.test_torch_petr import (abstract_shapes, check_state_names, close,
                                   flat_state, seeded_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "rtebev")
CONFIGS = ["rtebev_r50_nuscenes_256x704_msdepth_hybrid_1f",
           "rtebev_r50_nuscenes_256x704_msdepth_hybrid_4f"]
FULL = os.path.join(CFG, CONFIGS[0] + ".yml")
HW, CAMS = (64, 96), 2          # the tiny model's images and cameras
GRID = dict(x=[-8., 8., 0.5], y=[-8., 8., 0.5], z=[-3., 3., 6.],
            depth=[1., 9., 1.])
TINY_HEAD = dict(num_classes=3, in_channels=16, embed_dims=32, num_query=24,
                 num_queries_one2one=8, k_one2many=2, num_layers=2,
                 num_heads=4, feedforward_channels=64, bev_h=32, bev_w=32,
                 pc_range=[-8., -8., -3., 8., 8., 3.])


def to_torch(batch, dtype=torch.float32):
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.to(dtype) if t.is_floating_point() else t
    return out


def to_jax(batch, dtype=jnp.float32):
    return {k: jnp.asarray(v).astype(dtype) if v.dtype == np.float32
            else jnp.asarray(v.astype(np.int32)) for k, v in batch.items()}


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def as_f64(module):
    """An nnx module's copy with its f32 state in f64 (inside
    jax.enable_x64())."""
    graphdef, st = nnx.split(module)
    return nnx.merge(graphdef, jax.tree.map(
        lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32 else x,
        st))


# ------------------------------------------------------------ depth nets
def mlp_input(b=2, n=3):
    """The 27 camera terms of b frames of n cameras of the tiny rig."""
    mats = chip_smoke.bevdet_rig(HW, n, b, tilt=0.02, bda_yaw=0.3)
    vt = nnx.eval_shape(lambda: jax_bt.MSLSSViewTransformerBEVDepth(
        GRID, input_size=HW, downsample=8, in_channels=8, out_channels=4,
        rngs=nnx.Rngs(0)))
    return np.asarray(vt.get_mlp_input(**{k: jnp.asarray(v)
                                          for k, v in mats.items()}))


def depth_case(kind):
    """-> (JAX module, its state, port module, inputs) of a depth net at
    16 channels (10 bins, 8 context channels) or a SimSPPF 16 -> 16."""
    rng = np.random.default_rng(3)
    if kind == "sppf":
        jm, state = seeded_state(nnx.eval_shape(lambda: jax_bt._SimSPPF(
            16, 16, rngs=nnx.Rngs(0))), 4)
        pm = bevdet_transformer._SimSPPF(16, 16, torch.Generator())
        inputs = [rng.normal(size=(6, 7, 9, 16)).astype(np.float32)]
    elif kind == "depthnet":
        jm, state = seeded_state(nnx.eval_shape(lambda: jax_bt.DepthNet(
            16, 16, 8, 10, use_sppf=True, rngs=nnx.Rngs(0))), 4)
        pm = DepthNet(16, 16, 8, 10, use_sppf=True)
        inputs = [rng.normal(size=(6, 7, 9, 16)).astype(np.float32),
                  mlp_input()]
    else:
        jm, state = seeded_state(nnx.eval_shape(lambda: jax_bt.MSDepthNet(
            16, 16, 8, 10, rngs=nnx.Rngs(0))), 4)
        pm = MSDepthNet(16, 16, 8, 10)
        inputs = [rng.normal(size=(6, 8, 12, 16)).astype(np.float32),
                  rng.normal(size=(6, 4, 6, 16)).astype(np.float32),
                  rng.normal(size=(6, 2, 3, 16)).astype(np.float32),
                  mlp_input()]
    load_jax_params(pm, state)
    return jm, state, pm, inputs


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("kind", ["sppf", "depthnet", "msdepthnet"])
def test_depth_nets_match_jax(kind, mode):
    """_SimSPPF, DepthNet (3 blocks + SPPF) and MSDepthNet (the depth from
    the two coarser levels, upsampled twice) on six camera images, their
    SE gates from the rig's 27 camera terms: eval mode in f32; train mode
    (batch statistics, the camera BatchNorm's fast variance, the running
    stats updated) in f64 on both sides."""
    jm, _, pm, inputs = depth_case(kind)
    images = [nchw(x) if x.ndim == 4 else torch.from_numpy(x)
              for x in inputs]
    if mode == "eval":
        jm.eval()
        ref = nnx.jit(lambda m, *a: m(*a))(jm, *map(jnp.asarray, inputs))
        with torch.no_grad():
            got = pm.eval()(*images)
        tol, after = 1e-5, None
    else:
        jm.train()
        with jax.enable_x64():
            jm64 = as_f64(jm)
            ref = nnx.jit(lambda m, *a: m(*a))(jm64, *(
                jnp.asarray(x, jnp.float64) for x in inputs))
            ref = jax.device_get(ref)
            after = {k: v for k, v in flat_state(jm64).items()
                     if k.endswith((".mean", ".var"))}
        pm.double().train()
        with torch.no_grad():
            got = pm(*(x.double() for x in images))
        tol = 1e-9
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        close(g.permute(0, 2, 3, 1).numpy(), np.asarray(r), tol)
    if kind != "sppf":
        assert tuple(got[0].shape[1:]) == (10,) + tuple(images[0].shape[2:])
    if after is not None:
        sd = pm.state_dict()
        for name, v in to_torch_names(pm, after).items():
            close(sd[name].numpy(), v.numpy(), 1e-12)


def test_camera_batchnorm_is_flax_fast_variance():
    """CameraBatchNorm in train mode on the rig's 27 terms: the batch
    variance is E[x^2] - E[x]^2 clipped at 0, as flax computes it (a
    column the same for every camera gets cancellation noise or 0, not
    torch's exact 0), and the output is x - mean times rsqrt(var + eps) *
    scale, plus bias; in f32 against the JAX BatchNorm within 1e-6 of the
    largest value where the columns vary."""
    x = mlp_input()
    jbn = nnx.BatchNorm(27, rngs=nnx.Rngs(0))
    bn = bevdet_transformer.CameraBatchNorm(27)
    ref = np.asarray(jbn(jnp.asarray(x)))
    got = bn.train()(torch.from_numpy(x)).detach().numpy()
    t = torch.from_numpy(x)
    var = ((t * t).mean(0) - t.mean(0) ** 2).clamp(min=0)
    np.testing.assert_array_equal(
        bn.running_var.numpy(), (0.99 * torch.ones(27) + 0.01 * var).numpy())
    varies = x.std(axis=0) > 1e-3 * np.abs(x).max(axis=0)
    assert 0 < varies.sum() < 27
    close(got[:, varies], ref[:, varies], 1e-6)


def test_mlp_input_and_depth_labels_match_jax():
    """get_mlp_input bit for bit (a tilted rig, a BEV yaw); at RTEBev's
    full shape (six 256 x 704 depth maps, stride 8, 118 bins of 0.5 m
    from 1 m) the one-hot labels of get_downsampled_gt_depth index for
    index (patches with no return, returns on bin edges, past the last
    bin and nearer than the first), and get_depth_loss on random
    probabilities within 1e-6."""
    vt = nnx.eval_shape(lambda: JaxConfig(path=FULL).model.img_view_transformer)
    pvt = meta_model(CONFIGS[0]).img_view_transformer
    mats = chip_smoke.bevdet_rig(chip_smoke.BEVDET_HW, b=2, tilt=0.02,
                                 bda_yaw=0.3)
    want = np.asarray(vt.get_mlp_input(**{k: jnp.asarray(v)
                                          for k, v in mats.items()}))
    got = pvt.get_mlp_input(**{k: torch.from_numpy(v)
                               for k, v in mats.items()}).numpy()
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(5)
    depth = rng.uniform(0.2, 65, (1, 6, 256, 704)).astype(np.float32)
    edges = rng.random(depth.shape) < 0.3
    depth[edges] = np.round(depth[edges] * 2) / 2          # on bin edges
    depth[rng.random(depth.shape) < 0.6] = 0.              # no return
    depth[0, 0, :8, :8] = 0.                               # an empty patch
    labels = np.asarray(jax.jit(vt.get_downsampled_gt_depth)(
        jnp.asarray(depth)))
    mine = pvt.get_downsampled_gt_depth(torch.from_numpy(depth)).numpy()
    np.testing.assert_array_equal(mine, labels)
    assert labels.shape == (6 * 32 * 88, 118)
    fg = labels.max(axis=1) > 0
    assert 0.5 < fg.mean() < 1.0 and labels.sum(axis=1).max() == 1
    probs = rng.dirichlet(np.ones(118), (1, 6, 32, 88)).astype(np.float32)
    ref = float(jax.jit(vt.get_depth_loss)(jnp.asarray(depth),
                                           jnp.asarray(probs)))
    loss = pvt.get_depth_loss(torch.from_numpy(depth),
                              torch.from_numpy(probs).permute(0, 1, 4, 2, 3))
    close(loss.item(), ref, 1e-6)


@pytest.mark.parametrize("case", ["level", "tilted", "tilted_batch2"])
def test_full_shape_ranks_index_equal(case):
    """RTEBev's frustum (118 bins over six 32 x 88 feature maps: 1,993,728
    rows a frame onto 128 x 128 cells at 0.8 m, z collapsed): the points
    bit for bit, the rank and valid index for index, against the JAX
    functions under jit; the density rule sends the pool to K7."""
    grid = JaxConfig(path=FULL).dic["model"]["img_view_transformer"][
        "grid_config"]
    hw = chip_smoke.BEVDET_HW
    tilted = case != "level"
    mats = chip_smoke.bevdet_rig(hw, b=2 if case.endswith("batch2") else 1,
                                 tilt=0.02 if tilted else 0.0,
                                 bda_yaw=0.2 if tilted else 0.0)
    jv = nnx.eval_shape(lambda: jax_bt.LSSViewTransformer(
        grid, input_size=hw, downsample=8, in_channels=8, out_channels=4,
        rngs=nnx.Rngs(0)))
    coor, rank, valid = jax_ranks(jv, mats)
    vt = LSSViewTransformer(grid, input_size=hw, downsample=8,
                            in_channels=8, out_channels=4)
    tm = {k: torch.from_numpy(v) for k, v in mats.items()}
    got = vt.get_lidar_coor(**tm).numpy()
    np.testing.assert_array_equal(got.view(np.int32), coor.view(np.int32))
    my_rank, my_valid = (x.numpy() for x in vt.frustum_ranks(**tm))
    np.testing.assert_array_equal(my_valid, valid)
    np.testing.assert_array_equal(np.where(valid, my_rank, -1),
                                  np.where(valid, rank, -1))
    assert valid[0].size == 6 * 118 * 32 * 88 == 1993728
    assert 0.3 < valid.mean() < 1.0
    assert sorted_scatter.kernel_for(valid[0].size, 128 * 128) == \
        "sorted_segment_sum_dense"


# ------------------------------------------------------------------ head
@pytest.fixture(scope="module")
def head_pair():
    jm, state = seeded_state(nnx.eval_shape(lambda: JaxRTEBevHead(
        rngs=nnx.Rngs(0), **TINY_HEAD)), 7)
    pm = RTEBevHead(**TINY_HEAD)
    load_jax_params(pm, state)
    return jm, state, pm


def head_gt(b=2, g=5):
    rng = np.random.default_rng(9)
    boxes = np.zeros((b, g, 9), np.float32)
    boxes[..., :2] = rng.uniform(-7, 7, (b, g, 2))
    boxes[..., 2] = rng.uniform(-1.5, 0.5, (b, g))
    boxes[..., 3:6] = rng.uniform([1.5, 3.5, 1.4], [2.0, 4.5, 1.8],
                                  (b, g, 3))
    boxes[..., 6] = rng.uniform(-3, 3, (b, g))
    boxes[..., 7:] = rng.normal(0, 1, (b, g, 2))
    labels = rng.integers(0, 3, (b, g))
    labels[1, g - 1] = -1
    boxes[1, g - 1] = 0
    return boxes, labels


@pytest.mark.parametrize("training", [False, True], ids=["serve", "train"])
def test_head_forward_loss_and_predict_match_jax(head_pair, training):
    """RTEBevHead at 32 channels (an input projection from 16, 8 one2one
    and 16 one2many queries, 2 layers) over a 32 x 32 BEV: both layers'
    outputs (in training with the block-diagonal mask: the one2one rows
    as in serving); on the JAX outputs, the hybrid loss (the one2many queries
    against the gt tiled twice) and the decode of the one2one queries."""
    jm, _, pm = head_pair
    rng = np.random.default_rng(8)
    bev = rng.normal(size=(2, 32, 32, 16)).astype(np.float32)
    ref = nnx.jit(lambda m, x: m(x, training=training))(jm, jnp.asarray(bev))
    with torch.no_grad():
        got = pm(nchw(bev), training=training)
    qt = 24 if training else 8
    for g, r in zip(got, ref):
        assert tuple(g.shape[:3]) == (2, 2, qt) == r.shape[:3]
        close(g.numpy(), np.asarray(r), 1e-5)
    if training:
        # the mask keeps the one2many queries out of the one2one ones'
        # self-attention: their rows are the serving ones
        with torch.no_grad():
            alone = pm(nchw(bev), training=False)
        torch.testing.assert_close(got[0][:, :, :8], alone[0], rtol=0,
                                   atol=1e-5)
    cls, bbox = (np.asarray(r) for r in ref)
    boxes, labels = head_gt()
    if training:
        want = nnx.jit(lambda m, c, b, g, lab: m.loss(c, b, g, lab))(
            jm, jnp.asarray(cls), jnp.asarray(bbox), jnp.asarray(boxes),
            jnp.asarray(labels))
        mine = pm.loss(torch.from_numpy(cls), torch.from_numpy(bbox),
                       torch.from_numpy(boxes), torch.from_numpy(labels))
        assert set(mine) == set(want) == {
            "loss", "loss_cls", "loss_bbox", "loss_cls_one2many",
            "loss_bbox_one2many"}
        for k in want:
            close(mine[k].item(), float(want[k]), 1e-6)
    want = jax.device_get(jm.predict(jnp.asarray(cls), jnp.asarray(bbox),
                                     score_threshold=0.45))
    pred = pm.predict(torch.from_numpy(cls), torch.from_numpy(bbox),
                      score_threshold=0.45)
    assert tuple(pred["box3d_lidar"].shape) == (2, 24, 9)
    np.testing.assert_array_equal(pred["label_preds"].numpy(),
                                  want["label_preds"])
    close(pred["scores"].numpy(), want["scores"], 1e-6)
    close(pred["box3d_lidar"].numpy(), want["box3d_lidar"], 1e-6)
    assert (want["scores"] == -1).any() and (want["scores"] > 0.45).any()


# ------------------------------------------------------------------ model
def build_tiny(jax_side):
    """A tiny RTEBev in either package: ResNet-18 at base 8 to C3-C5, FPN
    to 16 channels at three levels, the multi-scale depth LSS (8 bins onto
    a 32 x 32 grid of 8 channels, SPPF), one adjacent frame's BEV
    concatenated, CustomResNet (16 -> 16, 32) + FPN_LSS, TINY_HEAD."""
    if jax_side:
        kw = {"rngs": nnx.Rngs(0)}
        mods = (jax_backbones.ResNet, jax_necks.FPN,
                jax_bt.MSLSSViewTransformerBEVDepth,
                jax_backbones.CustomResNet, jax_necks.FPN_LSS, JaxRTEBevHead,
                JaxRTEBev)
    else:
        kw = {}
        mods = (ResNet, FPN, MSLSSViewTransformerBEVDepth, CustomResNet,
                FPN_LSS, RTEBevHead, RTEBev)
    res, fpn, lss, cres, fpn_lss, head, model = mods
    return model(
        img_backbone=res(depth=18, base_channels=8, out_indices=(1, 2, 3),
                         **kw),
        img_neck=fpn([16, 32, 64], 16, num_outs=3, **kw),
        img_view_transformer=lss(GRID, input_size=HW, downsample=8,
                                 in_channels=16, out_channels=8,
                                 depthnet_cfg=dict(use_sppf=True), **kw),
        img_bev_encoder_backbone=cres(16, num_layer=(1, 1),
                                      num_channels=(16, 32), stride=(1, 2),
                                      **kw),
        img_bev_encoder_neck=fpn_lss(16 + 32, 16, **kw),
        pts_bbox_head=head(**TINY_HEAD, **kw), num_adj=1, use_depth=True,
        use_ms_depth=True, test_cfg=dict(score_threshold=0.0))


@pytest.fixture(scope="module")
def tiny():
    """The tiny RTEBev on both sides, the seeded JAX state carried across,
    in eval mode."""
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


def adjacent(batch, seed):
    rng = np.random.default_rng(seed)
    return {"img_adj": rng.uniform(0, 1, batch["img"].shape).astype(
                np.float32),
            "rots_adj": batch["rots"],
            "trans_adj": batch["trans"] + np.float32(0.3)}


@pytest.mark.parametrize("history", ["bev_adj", "img_adj", "none"])
def test_tiny_test_forward_matches_jax(tiny, history):
    """The tiny RTEBev's test_forward with an earlier frame's BEV fed back
    (bev_adj: the first frame's own pooled BEV), with an adjacent frame's
    images, and with neither (the current BEV repeated)."""
    jm, _, model = tiny
    batch = serve_batch()
    if history == "bev_adj":
        first = serve_batch(5)
        with torch.no_grad():
            bev = model._frame_bev(*to_torch(first).values())[0]
        batch["bev_adj"] = bev.numpy()
        assert batch["bev_adj"].shape == (2, 32, 32, 8)
        assert np.abs(batch["bev_adj"]).sum(-1).astype(bool).mean() > 0.05
    elif history == "img_adj":
        batch.update(adjacent(batch, 6))
    ref = jax.device_get(nnx.jit(lambda m, b: m.test_forward(b))(
        jm, to_jax(batch)))
    got = model.test_forward(to_torch(batch))
    assert set(got) == set(ref) == {"box3d_lidar", "scores", "label_preds"}
    assert tuple(got["box3d_lidar"].shape) == (2, 24, 9)
    np.testing.assert_array_equal(got["label_preds"].numpy(),
                                  ref["label_preds"])
    close(got["scores"].numpy(), ref["scores"], 1e-5)
    close(got["box3d_lidar"].numpy(), ref["box3d_lidar"], 1e-4)
    # the decode orders scores that differ: the labels' order is tested
    assert (np.ptp(ref["scores"], axis=1) > 0.05).all()


def test_rtebev_refuses_train_mode_serving(tiny):
    _, _, model = tiny
    model.train()
    try:
        with pytest.raises(RuntimeError, match="eval"):
            model.test_forward(to_torch(serve_batch()))
    finally:
        model.eval()
    # postprocess_to_samples, once refused (item 5), is PETR's,
    # as in the JAX package: no meta, no sample
    assert RTEBev.postprocess_to_samples(
        {"box3d_lidar": np.zeros((0, 4, 9)), "scores": np.zeros((0, 4)),
         "label_preds": np.zeros((0, 4))}, []) == []
    assert model.export_forward.__func__ is RTEBev.export_forward


def gt_depth(batch, seed):
    """A [B, N, H, W] depth map: a return at 40 % of the pixels, 0.5 to
    11 m (some past the 8 bins)."""
    rng = np.random.default_rng(seed)
    shape = batch["img"].shape[:2] + HW
    d = rng.uniform(0.5, 11, shape).astype(np.float32)
    d[rng.random(shape) < 0.6] = 0.
    return d


def train_batch(seed=1):
    batch = serve_batch(seed)
    batch.update(adjacent(batch, seed + 20))
    boxes, labels = head_gt()
    batch.update(gt_boxes=boxes, gt_labels=labels,
                 gt_depth=gt_depth(batch, seed + 30))
    return batch


def test_tiny_train_step_matches_jax_in_f64(tiny, monkeypatch):
    """train_forward with an adjacent frame (encoded without gradient, its
    BN stats updated after the current frame's) and a gt_depth, in train
    mode, both sides in f64: every Hungarian assignment (one2one and
    one2many, each layer and sample), the losses (the depth loss among
    them), every gradient and the running stats."""
    _, state, _ = tiny
    batch = train_batch()
    jm, _ = seeded_state(nnx.eval_shape(lambda: build_tiny(True)), 0)
    jm.train()
    solves = {"jax": [], "port": []}

    def recorder(side, solve):
        def rec(cost, valid):
            out = solve(cost, valid)
            solves[side].append((np.array(cost), np.array(out)))
            return out
        return rec
    monkeypatch.setattr(jax_ta, "_solve_host",
                        recorder("jax", jax_ta._solve_host))
    monkeypatch.setattr(target_assigners, "_solve_host",
                        recorder("port", target_assigners._solve_host))
    with jax.enable_x64():
        jm64 = as_f64(jm)

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
    assert len(solves["port"]) == len(solves["jax"]) == 2 * 2 * 2
    # XLA may run the two set losses' host solves in either order: pair
    # each of the port's with the JAX solve of the nearest cost
    for cost, out in solves["port"]:
        errs = [np.abs(cost - c).max() if c.shape == cost.shape
                else np.inf for c, _ in solves["jax"]]
        j = int(np.argmin(errs))
        assert errs[j] <= 1e-5 * np.abs(cost).max()
        np.testing.assert_array_equal(out, solves["jax"][j][1])
    assert set(got) == set(want) == {
        "loss", "loss_cls", "loss_bbox", "loss_cls_one2many",
        "loss_bbox_one2many", "loss_depth"}
    for k in want:
        close(got[k].item(), want[k], 1e-7)
    ref = to_torch_names(model, {
        ".".join(map(str, k)): np.asarray(v[...])
        for k, v in nnx.state(grads, nnx.Param).flat_state()})
    assert set(ref) == {n for n, _ in model.named_parameters()}
    largest = max(v.abs().max().item() for v in ref.values())
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        err = (g - ref[name]).abs().max().item()
        assert err <= 1e-5 * max(ref[name].abs().max().item(),
                                 1e-3 * largest), name
    dn = model.img_view_transformer.depth_net
    assert dn.depth_out.weight.grad.abs().max() > 0
    after = to_torch_names(model, {k: v for k, v in stats.items()
                                   if k.endswith((".mean", ".var"))})
    sd = model.state_dict()
    for name, v in after.items():
        close(sd[name].numpy(), v.numpy(), 1e-9)


def build_bevdet_depth(jax_side):
    """tests/test_torch_bevdet.py's tiny BEVDet4D with the BEVDepth view
    transformer (its DepthNet at 32 channels)."""
    if jax_side:
        kw = {"rngs": nnx.Rngs(0)}
        mods = (jax_backbones.ResNet, jax_bt.LSSViewTransformerBEVDepth,
                jax_backbones.CustomResNet, jax_necks.FPN_LSS, JaxCenterHead,
                JaxBEVDet)
    else:
        kw = {}
        mods = (ResNet, LSSViewTransformerBEVDepth, CustomResNet, FPN_LSS,
                CenterHead, BEVDet)
    res, lss, cres, fpn, head, model = mods
    return model(
        img_backbone=res(depth=18, base_channels=8, out_indices=(2,), **kw),
        img_neck=None,
        img_view_transformer=lss(GRID, input_size=HW, downsample=16,
                                 in_channels=32, out_channels=16,
                                 loss_depth_weight=3.0, **kw),
        img_bev_encoder_backbone=cres(32, num_layer=(1, 1),
                                      num_channels=(16, 32), stride=(1, 2),
                                      **kw),
        img_bev_encoder_neck=fpn(16 + 32, 16, **kw),
        bbox_head=head(**HEAD, **kw), test_cfg=TEST_CFG,
        target_assign_cfg=dict(down_ratio=1, max_objs=8), temporal=True)


def test_bevdet_depth_loss_branch_matches_jax():
    """BEVDet's train_forward with a BEVDepth view transformer and a
    gt_depth, in train mode, f64 on both sides: the losses (loss_depth
    added to the total) against the JAX model's; without gt_depth, no
    loss_depth; the depth loss reaches the depth net's gradients."""
    jm, state = seeded_state(nnx.eval_shape(lambda: build_bevdet_depth(
        True)), 2)
    jm.train()
    batch = serve_batch(3)
    batch.update(adjacent(batch, 4))
    boxes, _ = head_gt()
    batch.update(gt_boxes=boxes[..., :7].copy(),
                 gt_labels=np.array([[0, 0, 0, 0, 0], [0, 0, 0, 0, -1]]),
                 gt_depth=gt_depth(batch, 5))
    with jax.enable_x64():
        want = jax.device_get(nnx.jit(lambda m, b: m.train_forward(b))(
            as_f64(jm), to_jax(batch, jnp.float64)))
    model = build_bevdet_depth(False)
    load_jax_params(model, state)
    model.double().train()
    got = model.train_forward(to_torch(batch, torch.float64))
    assert set(got) == set(want) == {"loss", "hm_loss_0", "loc_loss_0",
                                     "loss_depth"}
    for k in want:
        close(got[k].item(), want[k], 1e-8)
    got["loss_depth"].backward()
    assert model.img_view_transformer.depth_net.depth_out.weight.grad \
        .abs().max() > 0
    del batch["gt_depth"]
    with torch.no_grad():
        assert "loss_depth" not in model.train_forward(
            to_torch(batch, torch.float64))


# --------------------------------------------------------------- configs
@functools.lru_cache(maxsize=None)
def meta_model(name):
    with torch.device("meta"):
        return Config(path=os.path.join(CFG, name + ".yml"),
                      device="meta").model


@pytest.mark.parametrize("name", CONFIGS)
def test_full_config_builds_with_jax_state(name):
    """Both RTEBev configs through both packages' Config (the port's on the
    meta device): the state's names and shapes (the 27-wide camera
    BatchNorm, the SE layers' linears, the bare reference points),
    load_jax_params filling every parameter and running stat from the JAX
    state's paths, and the geometry and head settings."""
    path = os.path.join(CFG, name + ".yml")
    jm = nnx.eval_shape(lambda: JaxConfig(path=path).model)
    model = meta_model(name)
    shapes = abstract_shapes(jm)
    check_state_names(model, shapes)
    load_jax_params(model, {k: np.zeros(s, np.float32)
                            for k, s in shapes.items()})
    vt, jvt = model.img_view_transformer, jm.img_view_transformer
    assert (vt.grid_size, vt.D, vt.h_feat, vt.w_feat, vt.out_channels) == (
        jvt.grid_size, jvt.D, jvt.h_feat, jvt.w_feat, jvt.out_channels) == (
            (128, 128, 1), 118, 32, 88, 80)
    assert isinstance(vt.depth_net.bn, bevdet_transformer.CameraBatchNorm)
    assert len(vt.depth_net.depth_conv_low) == 2           # block + SPPF
    assert model.num_adj == jm.num_adj == (1 if name.endswith("1f") else 4)
    assert model.use_depth and model.use_ms_depth
    head = model.bbox_head
    assert (head.num_query, head.num_queries_one2one, head.k_one2many,
            len(head.layers), head.input_proj) == (
                jm.bbox_head.num_query, jm.bbox_head.num_queries_one2one,
                jm.bbox_head.k_one2many, len(jm.bbox_head.layers), None)
    assert model.img_bev_encoder_backbone.stages[0][0].conv1.in_channels \
        == 80 * (1 + model.num_adj)


# ------------------------------------------------------- positional enc.
def test_positional_encodings_match_jax():
    """The four positional encodings against the JAX package's: the sine
    ones (2-D at 5 x 7, 3-D over 3 cameras; normalised and not) and the
    learned ones with the JAX tables carried across."""
    for normalize in (True, False):
        kw = dict(num_feats=16, normalize=normalize)
        close(SinePositionalEncoding(**kw)(5, 7).numpy(),
              np.asarray(jax_pe.SinePositionalEncoding(**kw)(5, 7)), 1e-6)
        close(SinePositionalEncoding3D(**kw)(3, 5, 7).numpy(),
              np.asarray(jax_pe.SinePositionalEncoding3D(**kw)(3, 5, 7)),
              1e-6)
    for jcls, pcls, args in (
            (jax_pe.LearnedPositionalEncoding, LearnedPositionalEncoding,
             (5, 7)),
            (jax_pe.LearnedPositionalEncoding3D, LearnedPositionalEncoding3D,
             (3, 5, 7))):
        jm, state = seeded_state(nnx.eval_shape(lambda: jcls(
            num_feats=8, row_num_embed=10, col_num_embed=12,
            rngs=nnx.Rngs(0))), 11)
        pm = pcls(num_feats=8, row_num_embed=10, col_num_embed=12)
        load_jax_params(pm, state)
        with torch.no_grad():
            got = pm(*args)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jm(*args)))
        assert tuple(got.shape) == args + (8 * len(args),)
