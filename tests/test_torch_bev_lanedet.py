"""Port parity of BEV-LaneDet (models/detection/bev_lanedet/bev_lanedet.py:
bilinear_warp, BEVLaneDet) on the CPU against the JAX package, with inputs
made from a seed by numpy.

The JAX model is built abstractly (nnx.eval_shape) and filled from a seed
by numpy (tests/test_torch_petr.py's seeded_state). The small model is a
ResNet-18 at base 8 to its third stage (32 channels at stride 16), reduced
to 8 channels and warped onto a 20 x 8 BEV.

Tolerances and why:
  * bilinear_warp: 1e-6 of the largest value in f32 (the JAX arithmetic
    and sum order, elementwise; the f32 products may round apart where
    either framework fuses a multiply-add), 1e-12 in f64;
  * test_forward after .eval() on both sides (the running statistics):
    1e-5 of each output's largest value (CPU convolutions summed in other
    orders);
  * the train step in f64 on both sides (in f32 a relu input within
    rounding of 0 moves gradients far more): losses 1e-10 of their value,
    gradients 1e-9 of each tensor's largest value; the embedding head's
    bias, which the loss does not see (a shift of every embedding moves
    neither term), 1e-9 of the step's largest gradient.
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
from paddle3d_tpu.models.detection import BEVLaneDet as JaxBEVLaneDet
from paddle3d_tpu.models.detection.bev_lanedet import \
    bev_lanedet as jax_lanedet
from paddle3d_tpu_torch.apis import Config
from paddle3d_tpu_torch.models.backbones import ResNet
from paddle3d_tpu_torch.models.detection import BEVLaneDet
from paddle3d_tpu_torch.models.detection.bev_lanedet import bilinear_warp
from paddle3d_tpu_torch.utils.convert import load_jax_params, to_torch_names
from tests.test_torch_petr import (abstract_shapes, check_state_names, close,
                                   nchw, nhwc, seeded_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "bev_lanedet",
                      "bev_lanedet_apollo_576x1024.yml")
HW, BEV = (64, 96), (20, 8)


def build(jax_side):
    """The small BEV-LaneDet in either package."""
    if jax_side:
        kw = {"rngs": nnx.Rngs(0)}
        res, det = JaxResNet, JaxBEVLaneDet
    else:
        kw = {}
        res, det = ResNet, BEVLaneDet
    return det(res(depth=18, base_channels=8, out_indices=(2,), **kw),
               bev_size=BEV, in_channels=32, feat_channels=8, **kw)


@pytest.fixture(scope="module")
def small():
    jm, state = seeded_state(nnx.eval_shape(lambda: build(True)), 0)
    model = build(False)
    load_jax_params(model, state)
    return jm, state, model


def lane_batch(seed, b=2):
    """Uniform-pixel images, the identity grid with some taps pushed out
    of the map, and chip_smoke.lane_targets' lanes; frame 1 also holds
    cells of instance id 9, which the loss ignores (max 8)."""
    rng = np.random.default_rng(seed)
    grid = np.broadcast_to(chip_smoke.lane_grid(*BEV), (b,) + BEV + (2,))
    grid = grid + rng.normal(0, 0.05, grid.shape)
    conf, offset, height, inst = chip_smoke.lane_targets(rng, b, *BEV)
    inst[1, :2, :2] = 9
    return {"data": rng.uniform(0, 255, (b,) + HW + (3,)).astype(np.float32),
            "bev_grid": grid.astype(np.float32), "lane_conf": conf,
            "lane_offset": offset, "lane_height": height,
            "lane_instance": inst}


def to_jax(batch, dt=jnp.float32):
    return {k: jnp.asarray(v, dt) if v.dtype == np.float32 else
            jnp.asarray(v.astype(np.int32)) for k, v in batch.items()}


def to_torch(batch, dt=torch.float32):
    return {k: torch.from_numpy(v).to(dt) if v.dtype == np.float32 else
            torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("dt,tol", [(np.float32, 1e-6), (np.float64, 1e-12)])
def test_bilinear_warp_matches_jax(dt, tol):
    """The four-tap warp against the JAX _bilinear_warp per frame: grid
    points inside, on the last row and column, on integer cells, and out
    of range on every side (their taps 0)."""
    rng = np.random.default_rng(1)
    feat = rng.normal(size=(2, 7, 11, 5)).astype(dt)
    grid = rng.uniform(-0.3, 1.3, (2, 6, 9, 2))
    grid[0, 0] = [[0, 0], [1, 1], [1, 0], [0, 1], [0.5, 0.5], [0.1, 1.0],
                  [1.0, 0.3], [-1e-7, 0.5], [0.25, 1 + 1e-7]]
    grid = grid.astype(dt)
    with jax.enable_x64(dt == np.float64):
        ref = np.stack([np.asarray(jax_lanedet._bilinear_warp(
            jnp.asarray(feat[i]), jnp.asarray(grid[i]))) for i in range(2)])
    got = bilinear_warp(nchw(feat), torch.from_numpy(grid))
    close(nhwc(got), ref, tol)
    assert (ref[0, 0, 7] != 0).all() and (np.abs(ref) == 0).any()


def test_small_test_forward_matches_jax(small):
    """test_forward after .eval() on both sides: conf (sigmoid), offset,
    height and the NHWC embedding; train mode refused."""
    jm, _, model = small
    jm.eval()
    model.eval()
    batch = lane_batch(2)
    serve = {k: batch[k] for k in ("data", "bev_grid")}
    ref = jax.device_get(nnx.jit(lambda m, b: m.test_forward(b))(
        jm, to_jax(serve)))
    got = model.test_forward(to_torch(serve))
    assert set(got) == set(ref)
    assert tuple(got["lane_embed"].shape) == (2,) + BEV + (4,)
    for k in ref:
        close(got[k].detach().numpy(), ref[k], 1e-5)
    model.train()
    with pytest.raises(RuntimeError, match="eval"):
        model.test_forward(to_torch(serve))


def test_small_train_step_matches_jax_in_f64(small):
    """train_forward in train mode (the balanced BCE, the L1 terms on the
    lane cells, the push-pull embedding loss with at most 8 instances and
    its eps inside the sqrt): losses and every gradient against the JAX
    step's, both in f64."""
    jm, state, _ = small
    batch = lane_batch(3)
    with jax.enable_x64():
        graphdef, st = nnx.split(jm)
        jm64 = nnx.merge(graphdef, jax.tree.map(
            lambda x: x.astype(jnp.float64) if x.dtype == jnp.float32
            else x, st))
        jm64.train()

        @nnx.jit
        def grads_of(m, b):
            def loss_fn(m):
                losses = m.train_forward(b)
                return losses["loss"], losses
            return nnx.grad(loss_fn, has_aux=True)(m)

        grads, want = jax.device_get(grads_of(jm64, to_jax(
            batch, jnp.float64)))
    model = build(False)
    load_jax_params(model, state)
    model.double().train()
    got = model.train_forward(to_torch(batch, torch.float64))
    got["loss"].backward()
    assert set(got) == set(want) == {"loss", "loss_conf", "loss_offset",
                                     "loss_height", "loss_embed"}
    for key in want:
        close(got[key].item(), want[key], 1e-10)
    assert want["loss_embed"] > 0
    ref = to_torch_names(model, {
        ".".join(map(str, k)): np.asarray(v[...])
        for k, v in nnx.state(grads, nnx.Param).flat_state()})
    assert set(ref) == {n for n, _ in model.named_parameters()}
    top = max(np.abs(v.numpy()).max() for v in ref.values())
    for name, p in model.named_parameters():
        if p.grad is None:
            # the ResNet's fourth stage runs (as in the JAX package) but
            # feeds nothing: nnx.grad gives it zeros, autograd none
            assert name.startswith("backbone.stages.3.")
            assert not ref[name].numpy().any()
        elif name == "embed_head.bias":
            # the embedding loss is invariant to a shift of every
            # embedding: no gradient, rounding noise on both sides
            assert np.abs(ref[name].numpy()).max() < 1e-10 * top
            assert np.abs(p.grad.numpy() - ref[name].numpy()).max() < \
                1e-9 * top
        else:
            close(p.grad.numpy(), ref[name].numpy(), 1e-9)


def test_embed_loss_is_finite_where_means_coincide(small):
    """Two instances with the same embedding mean: the push term's
    distance is sqrt(0 + 1e-8), its gradient finite; one instance alone
    pushes nothing; an id past 8 pulls nothing."""
    _, _, model = small
    emb = torch.zeros((3, 4) + BEV, dtype=torch.float64, requires_grad=True)
    inst = torch.zeros((3,) + BEV, dtype=torch.int64)
    inst[0, :4, :2], inst[0, 4:8, :2] = 1, 2   # coinciding means
    inst[1, :4, :2] = 3                        # one instance
    inst[2, :4, :2] = 9                        # ignored
    loss = model._embed_loss(emb, inst)
    loss.backward()
    assert torch.isfinite(emb.grad).all()
    margin = model.push_margin
    want = ((margin - 1e-4) ** 2) / 3          # frame 0's push, averaged
    assert loss.item() == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("default", [False, True])
def test_configs_build_with_jax_state(default):
    """The Apollo config (ResNet-34 to its third stage, 256 channels, a
    100 x 25 BEV) through both packages' Config, the port's on the meta
    device, and the default model (ResNet-34 to its fourth stage, 512
    channels): every state name and shape; the config's AdamW."""
    if default:
        jm = nnx.eval_shape(lambda: JaxBEVLaneDet(rngs=nnx.Rngs(0)))
        with torch.device("meta"):
            model = BEVLaneDet()
    else:
        jm = nnx.eval_shape(lambda: JaxConfig(path=CONFIG).model)
        with torch.device("meta"):
            cfg = Config(path=CONFIG, device="meta")
            model = cfg.model
            opt = cfg.optimizer
        assert type(opt) is torch.optim.AdamW
        assert opt.param_groups[0]["lr"] == 0.001
    check_state_names(model, abstract_shapes(jm))
    assert (model.bev_h, model.bev_w) == (jm.bev_h, jm.bev_w) == (100, 25)
    assert model.reduce.conv.in_channels == (512 if default else 256)
    assert model.backbone.out_indices == ((3,) if default else (2,))


def test_postprocess_matches_jax(small):
    _, _, model = small
    rng = np.random.default_rng(4)
    out = {"lane_conf": rng.random((2,) + BEV),
           "lane_offset": rng.random((2,) + BEV),
           "lane_height": rng.random((2,) + BEV),
           "lane_embed": rng.random((2,) + BEV + (4,))}
    metas = [{"path": "a.jpg", "id": 0}, {"path": "b.jpg", "id": 1}]
    ref = JaxBEVLaneDet.postprocess_to_samples(out, metas)
    got = BEVLaneDet.postprocess_to_samples(
        {k: torch.from_numpy(v) for k, v in out.items()}, metas)
    for g, r in zip(got, ref):
        assert (g.path, g.modality, dict(g.meta)) == (r.path, r.modality,
                                                      dict(r.meta))
        for k in ("lane_conf", "lane_offset", "lane_embed"):
            np.testing.assert_array_equal(g[k], r[k])
