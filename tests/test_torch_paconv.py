"""Port parity of PAConv (models/classification/paconv.py) and the
ModelNet40 dataset and accuracy metric, on the CPU against the JAX
package, with inputs made from a seed by numpy.

The JAX model is built abstractly (nnx.eval_shape) and filled from a seed
by numpy (tests/test_torch_petr.py's seeded_state); the bare weight banks
(nnx.Param in an nnx.List) land in the port's nn.ParameterList under the
same dotted names (`weight_banks.<i>`) through utils/convert.

Tolerances and why:
  * assign_score_withk: the port transforms each point once and weights
    the gathered rows (P = F W, then sum_m s (P[j] - P[n])), the JAX
    package transforms each difference (sum_m s ((F[j] - F[n]) W)): the
    same function summed in another order. In f64 within 1e-12 of the
    largest value (rounding of sums of ~100 terms of unit size); in f32
    within 1e-5 (measured ~1e-7: f32 rounding of those sums, the
    difference of two transformed rows instead of the transform of a
    difference);
  * the tiny config's test_forward in f32: logits 1e-5 of the largest
    value, classes equal (the order above, LayerNorm's two-pass variance
    against flax's E[x^2] - E[x]^2);
  * the train step in f64 on both sides (in f32 a relu or max input
    within rounding of a tie moves a gradient wholly to another element):
    losses 1e-10 of their value, gradients 1e-9 of each tensor's largest
    value (sums of a few thousand f64 terms in other orders).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from paddle3d_tpu.apis.config import Config as JaxConfig
from paddle3d_tpu.datasets.modelnet40 import AccuracyMetric as JaxAccuracy
from paddle3d_tpu.datasets.modelnet40 import ModelNet40 as JaxModelNet40
from paddle3d_tpu.models.classification import PAConv as JaxPAConv
from paddle3d_tpu.models.classification import paconv as jax_paconv
from paddle3d_tpu.ops.pointnet2 import knn_query as jax_knn
from paddle3d_tpu_torch.apis import Config
from paddle3d_tpu_torch.datasets import AccuracyMetric, ModelNet40
from paddle3d_tpu_torch.models.classification import PAConv, paconv
from paddle3d_tpu_torch.utils.convert import load_jax_params, to_torch_names
from tests.test_torch_petr import (abstract_shapes, check_state_names, close,
                                   jax_model)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "paconv")
TINY = os.path.join(CFG, "paconv_synthetic_tiny.yml")
FULL = os.path.join(CFG, "paconv_modelnet40.yml")
N = 128                     # the tiny config's points a cloud


def clouds(seed, b=2, n=N):
    """b clouds of n points on a unit sphere's surface and inside it."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(b, n, 3))
    pts[:, : n // 2] /= np.linalg.norm(pts[:, : n // 2], axis=-1,
                                       keepdims=True)
    return (pts * rng.uniform(0.5, 1.0, (b, 1, 1))).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    """The tiny config (k 8, 4 kernels, channels [16, 16, 32], 4
    classes) on both sides, the seeded JAX state carried across."""
    jm, state = jax_model(TINY)
    model = Config(path=TINY, device="cpu").model
    load_jax_params(model, state)
    return jm, state, model


# ------------------------------------------------------ assign_score_withk
def assign_inputs(seed, dt, b=2, n=24, k=5, m=4, cin=6, cout=7):
    rng = np.random.default_rng(seed)
    scores = rng.dirichlet(np.ones(m), (b, n, k)).astype(dt)
    feats = rng.normal(size=(b, n, cin)).astype(dt)
    idx = rng.integers(0, n, (b, n, k)).astype(np.int32)
    idx[..., 0] = np.arange(n)          # self first, as the knn gives it
    bank = rng.normal(size=(m, cin, cout)).astype(dt)
    return scores, feats, idx, bank


@pytest.mark.parametrize("dt,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_assign_score_withk_orders_match_jax(dt, tol):
    """The transformed order and the JAX order (plain) against the JAX
    function per cloud, in f64 and f32."""
    scores, feats, idx, bank = assign_inputs(0, dt)
    with jax.enable_x64(dt == np.float64):
        ref = np.stack([np.asarray(jax_paconv.assign_score_withk(
            jnp.asarray(scores[i]), jnp.asarray(feats[i]),
            jnp.asarray(feats[i]), jnp.asarray(idx[i]), jnp.asarray(bank)))
            for i in range(len(feats))])
    t = [torch.from_numpy(a) for a in (scores, feats, idx, bank)]
    got = paconv.assign_score_withk(t[0], t[1], t[1], t[2], t[3])
    plain = paconv.assign_score_withk_plain(t[0], t[1], t[1], t[2], t[3])
    assert got.dtype == torch.from_numpy(feats).dtype
    close(got.numpy(), ref, tol)
    close(plain.numpy(), ref, tol)


@pytest.mark.parametrize("chunk", [None, 5 * 4 * 7])
def test_scored_gather_backward_matches_autograd_of_the_plain_form(
        chunk, monkeypatch):
    """_ScoredGather's hand-written backward (gathers again for the
    scores, index_add_ into the table's rows) against autograd through the
    JAX-order plain form, in f64, with a separate centre feature and
    repeated neighbours, in one chunk and in chunks of 5 rows; and
    torch.autograd.gradcheck on it."""
    if chunk:
        monkeypatch.setattr(paconv, "_CHUNK_ELEMS", chunk)
    scores, feats, idx, bank = assign_inputs(1, np.float64, n=10, k=4)
    idx[0, 3, 1:] = 7                    # one neighbour three times
    centre = np.random.default_rng(2).normal(size=feats.shape)
    grads = []
    for fn in (paconv.assign_score_withk, paconv.assign_score_withk_plain):
        t = [torch.from_numpy(a.copy()).requires_grad_(True)
             for a in (scores, feats, centre, bank)]
        out = fn(t[0], t[1], t[2], torch.from_numpy(idx), t[3])
        (out * torch.linspace(-1, 1, out.numel(), dtype=out.dtype)
         .reshape(out.shape)).sum().backward()
        grads.append([a.grad.numpy() for a in t])
    for g, r in zip(*grads):
        close(g, r, 1e-12)
    trans = torch.randn((2, 10, 4, 3), dtype=torch.float64,
                        requires_grad=True)
    s = torch.from_numpy(scores).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, b: paconv._ScoredGather.apply(a, b, torch.from_numpy(idx)),
        (s, trans))


# ---------------------------------------------------------------- model
def test_tiny_test_forward_matches_jax(tiny):
    """test_forward (the stable-tie knn, ScoreNet, the four PAConv
    layers, the classifier) against the JAX model's: logits and classes;
    the knn's neighbours equal the JAX per-cloud top_k's."""
    jm, _, model = tiny
    pts = clouds(3)
    ref = jax.device_get(nnx.jit(lambda m, b: m.test_forward(b))(
        jm, {"data": jnp.asarray(pts)}))
    got = model.test_forward({"data": torch.from_numpy(pts)})
    assert set(got) == set(ref) == {"logits", "pred"}
    close(got["logits"].detach().numpy(), ref["logits"], 1e-5)
    np.testing.assert_array_equal(got["pred"].numpy(), ref["pred"])
    idx, _ = model.neighbours(torch.from_numpy(pts))
    for i in range(len(pts)):
        want = jax_knn(model.k, jnp.asarray(pts[i]), jnp.asarray(pts[i]),
                       jnp.ones(N, bool))[0]
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(want))


def test_tiny_train_step_matches_jax_in_f64(tiny):
    """train_forward (label smoothing 0.2 spread as eps / (C - 1), the
    accuracy) and every gradient, the weight banks' included, against the
    JAX step's, both in f64."""
    jm, state, _ = tiny
    pts = clouds(4)
    labels = np.array([1, 3])
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

        grads, want = jax.device_get(grads_of(jm64, {
            "data": jnp.asarray(pts, jnp.float64),
            "labels": jnp.asarray(labels, jnp.int32)}))
    model = Config(path=TINY, device="cpu").model
    load_jax_params(model, state)
    model.double().train()
    got = model.train_forward({"data": torch.from_numpy(pts).double(),
                               "labels": torch.from_numpy(labels)})
    got["loss"].backward()
    assert set(got) == set(want) == {"loss", "acc"}
    for key in want:
        close(got[key].item(), want[key], 1e-10)
    ref = to_torch_names(model, {
        ".".join(map(str, k)): np.asarray(v[...])
        for k, v in nnx.state(grads, nnx.Param).flat_state()})
    assert set(ref) == {n for n, _ in model.named_parameters()}
    assert {"weight_banks.0", "weight_banks.2"} <= set(ref)
    for name, p in model.named_parameters():
        close(p.grad.numpy(), ref[name].numpy(), 1e-9)


def test_full_config_builds_with_jax_state():
    """paconv_modelnet40.yml through both packages' Config, the port's on
    the meta device: every state name and shape (the banks [8, Cin,
    Cout], LayerNorms, ScoreNets, classifier) and the settings."""
    jm = nnx.eval_shape(lambda: JaxConfig(path=FULL).model)
    with torch.device("meta"):
        model = Config(path=FULL, device="meta").model
    shapes = abstract_shapes(jm)
    check_state_names(model, shapes)
    assert [tuple(p.shape) for p in model.weight_banks] == [
        (8, 3, 64), (8, 64, 64), (8, 64, 128), (8, 128, 256)]
    assert shapes["weight_banks.3"] == (8, 128, 256)
    assert (model.k, model.num_classes, model.label_smoothing) == (
        jm.k, jm.num_classes, jm.label_smoothing) == (20, 40, 0.2)
    assert all(bn.eps == 1e-6 for bn in model.bns)
    with torch.device("meta"):
        opt = Config(path=FULL, device="meta").optimizer
    assert type(opt) is torch.optim.SGD
    assert opt.param_groups[0]["lr"] == 0.1


def test_postprocess_and_accuracy_match_jax(tiny):
    """postprocess_to_samples on both sides' outputs, then each package's
    AccuracyMetric over them."""
    jm, _, model = tiny
    pts = clouds(5, b=4)
    metas = [{"id": i, "label": lab} for i, lab in enumerate([3, 3, 0, 1])]
    ref = JaxPAConv.postprocess_to_samples(jax.device_get(nnx.jit(
        lambda m, b: m.test_forward(b))(jm, {"data": jnp.asarray(pts)})),
        metas)
    got = PAConv.postprocess_to_samples(
        model.test_forward({"data": torch.from_numpy(pts)}), metas)
    assert [s.labels for s in got] == [s.labels for s in ref]
    assert [dict(s.meta) for s in got] == [dict(s.meta) for s in ref]
    ours, theirs = AccuracyMetric(), JaxAccuracy()
    ours.update(got)
    theirs.update(ref)
    assert ours.compute() == theirs.compute()


# -------------------------------------------------------------- dataset
def write_modelnet(root, layout):
    """Three classes of clouds: an `{mode}.npz` (points [6, 40, 3],
    labels) or per-class folders of .npy files (one cloud with fewer
    points than asked)."""
    rng = np.random.default_rng(6)
    for mode in ("train", "test"):
        if layout == "npz":
            np.savez(os.path.join(root, mode + ".npz"),
                     points=rng.normal(size=(6, 40, 3)).astype(np.float32),
                     labels=np.array([0, 1, 2, 2, 1, 0]))
            continue
        for cname, n in (("airplane", 40), ("bed", 40), ("chair", 20)):
            d = os.path.join(root, mode, cname)
            os.makedirs(d)
            for i in range(2):
                np.save(os.path.join(d, "{}.npy".format(i)),
                        rng.normal(size=(n, 3)).astype(np.float32))


class _JaxModelNet40(JaxModelNet40):
    """The JAX class with a plain class attribute over BaseDataset's
    read-only `labels` property, which its constructor assigns to."""
    labels = None


@pytest.mark.parametrize("layout", ["npz", "npy"])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_modelnet40_matches_jax(tmp_path, layout, mode):
    """Both datasets on the same fixture files: classes, every sample
    (numpy's global RNG seeded alike before each draw), the collated
    batch and metas. The JAX constructor raises (a reference fault the
    port does not copy): the JAX side runs with its `labels` assignable."""
    write_modelnet(str(tmp_path), layout)
    with pytest.raises(AttributeError, match="labels"):
        JaxModelNet40(str(tmp_path), num_points=32, mode=mode)
    ours = ModelNet40(str(tmp_path), num_points=32, mode=mode)
    theirs = _JaxModelNet40(str(tmp_path), num_points=32, mode=mode)
    assert len(ours) == len(theirs) == 6
    assert ours.class_names == theirs.class_names == ours.labels
    np.testing.assert_array_equal(ours.cloud_labels, theirs.labels)
    got, want = [], []
    for i in range(len(ours)):
        for ds, into in ((ours, got), (theirs, want)):
            np.random.seed(100 + i)
            into.append(ds[i])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.data, w.data)
        assert g.labels == w.labels and g.meta.id == w.meta.id
    (gb, gm), (wb, wm) = ours.collate_fn(got), theirs.collate_fn(want)
    assert gm == wm and set(gb) == set(wb)
    for k in gb:
        np.testing.assert_array_equal(gb[k], wb[k])
        assert gb[k].dtype == wb[k].dtype
