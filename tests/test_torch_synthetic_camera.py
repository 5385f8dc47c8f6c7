"""Port parity of the synthetic camera datasets and the camera tiny configs'
runtime against the JAX package, on the CPU: SyntheticMonoDataset (with
Gt2SmokeTarget and its flips under a seed), SyntheticDepthDataset and
SyntheticMVDataset sample for sample and batch for batch, their metrics on
the same predictions, the three tiny configs built and collated through the
port's Config (the batches equal at 1 and 4 loader threads), and the slice
as a whole: the tiny SMOKE config's val split through the port's Trainer
evaluate() against the JAX test_forward, postprocess_to_samples and
SyntheticMonoMetric on the same batches.

Tolerances: the datasets, batches and metrics are exact (the same numpy
code, the same scenes); the tiny SMOKE's outputs hold labels equal, scores
to 1e-5, boxes and 2-D boxes to 1e-4 and alphas to 5e-4 of the largest
value, tests/test_torch_smoke.py's tolerances for the same model (flax's
fast-variance GroupNorm and the convolutions' summation order). The JAX
model is built abstractly (nnx.eval_shape) and filled from a seed by numpy.
"""
import os

import jax
import numpy as np
import pytest
import torch
from flax import nnx

from paddle3d_tpu.apis.config import Config as JaxConfig
from paddle3d_tpu.datasets import synthetic as jsyn
from paddle3d_tpu.models.detection.petr.petr3d import PETR as JaxPETR
from paddle3d_tpu.models.detection.smoke.smoke import SMOKE as JaxSMOKE
from paddle3d_tpu.models.detection.smoke.smoke_coder import \
    SMOKECoder as JaxSMOKECoder
from paddle3d_tpu.transforms.target_generator import \
    Gt2SmokeTarget as JaxGt2SmokeTarget
from paddle3d_tpu_torch.apis import Config, DataLoader, Trainer
from paddle3d_tpu_torch.datasets import synthetic as syn
from paddle3d_tpu_torch.models.detection import CADDN, PETR, SMOKE
from paddle3d_tpu_torch.transforms import Gt2SmokeTarget
from paddle3d_tpu_torch.utils.convert import load_jax_params
from tests.test_torch_petr import close, flat_state, seeded_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {name: os.path.join(REPO, "configs", name.split("_")[0], name +
                           ".yml")
        for name in ("smoke_synthetic_tiny", "caddn_synthetic_tiny",
                     "petr_synthetic_tiny")}
CLS_GAIN = 8.0          # tests/test_torch_smoke.py's contrast for the decode


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke_gen(cls, mode="train", flip_prob=0.5):
    return cls(mode=mode, num_classes=1, flip_prob=flip_prob, max_objs=8,
               input_size=(128, 96), output_stride=(4, 4))


def equal_arrays(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            equal_arrays(a[k], b[k])
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], k)


# ------------------------------------------------------------ datasets
def test_synthetic_mono_dataset_matches_jax():
    """Rendered images, intrinsics, boxes and labels, then Gt2SmokeTarget
    with flips of probability 0.5 (the JAX transform after np.random.seed,
    the port's from the sample's generator): samples and batches equal."""
    kw = dict(num_samples=6, image_hw=(96, 128), max_boxes=3, seed=2)
    jds = jsyn.SyntheticMonoDataset(transforms=[smoke_gen(
        JaxGt2SmokeTarget)], **kw)
    pds = syn.SyntheticMonoDataset(transforms=[smoke_gen(Gt2SmokeTarget)],
                                   **kw)
    js_all, ps_all = [], []
    for i in range(6):
        raw_j, raw_p = jds._gen(i), pds._gen(i)
        for a, b in zip(raw_j, raw_p):
            np.testing.assert_array_equal(a, b)
        np.random.seed(i)
        js_all.append(jds[i])
        ps_all.append(pds.get(i, np.random.RandomState(i)))
        equal_arrays(ps_all[-1].target, js_all[-1].target)
    assert 0 < sum(int(s.target["flip_mask"].max()) for s in ps_all) < 6
    (jb, jm), (pb, pm) = jds.collate_fn(js_all), pds.collate_fn(ps_all)
    equal_arrays(pb, jb)
    assert pm == jm
    np.testing.assert_array_equal(pds._intrinsic(), jds._intrinsic())


def test_synthetic_depth_and_mv_datasets_match_jax():
    """The depth set (image, img2lidar, depth map, LiDAR boxes) and the
    multi-view set (rendered views, lidar2imgs / img2lidars, nine-column
    boxes) give the JAX samples' arrays and batches."""
    kw = dict(num_samples=4, image_hw=(64, 96), depth_downsample_factor=16,
              max_boxes=3, seed=3)
    jds, pds = jsyn.SyntheticDepthDataset(**kw), \
        syn.SyntheticDepthDataset(**kw)
    js, ps = [jds[i] for i in range(4)], [pds[i] for i in range(4)]
    for a, b in zip(js, ps):
        np.testing.assert_array_equal(b.data, a.data)
        np.testing.assert_array_equal(b.meta.depth_map, a.meta.depth_map)
        np.testing.assert_array_equal(np.asarray(b.bboxes_3d),
                                      np.asarray(a.bboxes_3d))
    equal_arrays(pds.collate_fn(ps)[0], jds.collate_fn(js)[0])
    kw = dict(num_samples=3, num_cams=3, image_hw=(32, 48), max_boxes=4,
              seed=7)
    jds, pds = jsyn.SyntheticMVDataset(**kw), syn.SyntheticMVDataset(**kw)
    js, ps = [jds[i] for i in range(3)], [pds[i] for i in range(3)]
    for a, b in zip(js, ps):
        np.testing.assert_array_equal(b.img, a.img)
        np.testing.assert_array_equal(np.asarray(b.bboxes_3d),
                                      np.asarray(a.bboxes_3d))
        for key in ("lidar2imgs", "img2lidars"):
            np.testing.assert_array_equal(b.meta[key], a.meta[key])
    (jb, jm), (pb, pm) = jds.collate_fn(js), pds.collate_fn(ps)
    equal_arrays(pb, jb)
    assert pm == jm


# ------------------------------------------------------------- metrics
def _predictions(rng, gts, frame_cols):
    """Per frame: the gt boxes jittered (some by more than 2 m) and a
    spurious box, as model outputs [B, K, C] with -1 padded scores."""
    b, k = len(gts), 6
    c = max(g.shape[1] for g in gts)
    boxes = np.zeros((b, k, c), np.float32)
    scores = np.full((b, k), -1.0, np.float32)
    for i, g in enumerate(gts):
        n, frame = len(g), boxes[i]
        frame[:n] = g
        frame[:n, frame_cols] += rng.normal(0, 1.5, (n, 2))
        frame[n] = g[0]
        frame[n, frame_cols] += 9.0
        scores[i, :n + 1] = rng.uniform(0.1, 1.0, n + 1)
    labels = np.where(scores >= 0, 0, -1).astype(np.int32)
    return boxes, scores, labels


@pytest.mark.parametrize("which", ["mono", "depth", "mv"])
def test_synthetic_metrics_match_jax(which):
    """Each camera set's metric over the same predictions, handed through
    the port's and the JAX model's postprocess_to_samples (SMOKE's for the
    mono set, CADDN's / CenterPoint's for the depth set, PETR's for the
    multi-view set): equal recall and precision."""
    rng = np.random.default_rng(11)
    n = 5
    if which == "mono":
        jds, pds = (mod.SyntheticMonoDataset(num_samples=n)
                    for mod in (jsyn, syn))
        gts = [pds._gen(i)[1] for i in range(n)]
        boxes, scores, labels = _predictions(rng, gts, [0, 2])
        out = {"box3d_cam": boxes, "scores": scores, "label_preds": labels,
               "bbox_2d": np.zeros(boxes.shape[:2] + (4,), np.float32),
               "alphas": np.zeros(boxes.shape[:2], np.float32)}
        models = (SMOKE, JaxSMOKE)
    elif which == "depth":
        jds, pds = (mod.SyntheticDepthDataset(num_samples=n)
                    for mod in (jsyn, syn))
        gts = [pds._gen(i)[2] for i in range(n)]
        boxes, scores, labels = _predictions(rng, gts, [0, 1])
        out = {"box3d_lidar": boxes, "scores": scores, "label_preds": labels}
        from paddle3d_tpu.models.detection.caddn.caddn import CADDN as JaxC
        models = (CADDN, JaxC)
    else:
        jds, pds = (mod.SyntheticMVDataset(num_samples=n)
                    for mod in (jsyn, syn))
        gts = [pds._gen(i)[1] for i in range(n)]
        boxes, scores, labels = _predictions(rng, gts, [0, 1])
        out = {"box3d_lidar": boxes, "scores": scores, "label_preds": labels}
        models = (PETR, JaxPETR)
    metas = [{"path": "synthetic://{}".format(i), "id": i} for i in range(n)]
    pm, jm = pds.metric, jds.metric
    pm.update(models[0].postprocess_to_samples(out, metas))
    jm.update(models[1].postprocess_to_samples(out, metas))
    got = pm.compute()
    assert got == jm.compute()
    assert 0 < got["recall@2m"] < 1 and 0 < got["precision@2m"] < 1


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_camera_configs_build_and_collate(name):
    """The three tiny configs' datasets through the port's Config: the JAX
    config's dataset types, lengths and first batch."""
    cfg, jcfg = Config(path=TINY[name], device="cpu"), JaxConfig(
        path=TINY[name])
    for split in ("train_dataset", "val_dataset"):
        ds, jds = getattr(cfg, split), getattr(jcfg, split)
        assert type(ds).__name__ == type(jds).__name__
        assert len(ds) == len(jds)
        np.random.seed(0)
        jb, jm = jds.collate_fn([jds[i] for i in range(2)])
        pb, pm = ds.collate_fn([ds.get(i, np.random.RandomState(0))
                                for i in range(2)])
        equal_arrays(pb, jb)
        assert pm == jm


def test_loader_batches_do_not_depend_on_threads():
    """A SyntheticMonoDataset with flips of probability 0.5 through the
    DataLoader at 1 and 4 threads: the same batches (each sample draws
    from its own generator)."""
    ds = syn.SyntheticMonoDataset(num_samples=8,
                                  transforms=[smoke_gen(Gt2SmokeTarget)])
    got = [list(DataLoader(ds, batch_size=2, shuffle=True, num_workers=w))
           for w in (1, 4)]
    assert len(got[0]) == len(got[1]) == 4
    flips = 0
    for (a, am), (b, bm) in zip(*got):
        equal_arrays(a, b)
        assert am == bm
        flips += int(a["target"]["flip_mask"].max(axis=1).sum())
    assert 0 < flips < 8


# ------------------------------------------------------- the slice
@pytest.fixture(scope="module")
def tiny_smoke():
    """The tiny SMOKE config on both sides: the JAX model built abstractly
    and filled from a seed (its coder made concretely), the class head's
    last kernel scaled by CLS_GAIN, the state carried to the port's; both
    in f64 (see test_tiny_smoke_evaluate_matches_jax)."""
    path = TINY["smoke_synthetic_tiny"]
    jm, _ = seeded_state(nnx.eval_shape(lambda: JaxConfig(path=path).model),
                         5)
    jm.coder = JaxSMOKECoder((20.0, 10.0), ((3.88, 1.63, 1.53),))
    conv = jm.head.cls_conv2
    conv.kernel.value = conv.kernel.value * CLS_GAIN
    cfg = Config(path=path, device="cpu")
    model = cfg.model
    load_jax_params(model, flat_state(jm))
    return jm, model.double().eval(), cfg


def f64(tree):
    """The f32 arrays or tensors of a (nested) batch in f64."""
    if isinstance(tree, dict):
        return {k: f64(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.double() if tree.dtype == torch.float32 else tree
    return jax.numpy.asarray(tree, np.float64 if tree.dtype == np.float32
                             else tree.dtype)


def test_tiny_smoke_evaluate_matches_jax(tiny_smoke, tmp_path):
    """The tiny SMOKE config's val split (8 frames, batches of 4) through
    the port's Trainer.evaluate() (loader, padding, eval step,
    postprocess_to_samples, SyntheticMonoMetric) against the JAX package
    on the same batches: the batches equal, the JAX test_forward's outputs
    within 1e-9 of the largest value (labels equal), and the JAX
    SMOKE.postprocess_to_samples and SyntheticMonoMetric giving the port's
    metrics. Both models run in f64 (the eval step casts the batch): in f32
    the seeded weights' heatmaps differed by 1.9e-3 (flax's fast-variance
    GroupNorm, amplified by CLS_GAIN), in f64 the outputs by 5e-13."""
    jm, model, cfg = tiny_smoke
    trainer = Trainer(model=model, optimizer=torch.optim.SGD(
        model.parameters(), lr=0.0), val_dataset=cfg.val_dataset,
        batch_size=cfg.batch_size, save_dir=str(tmp_path))
    got, batches = [], []
    step = trainer._eval_step

    def rec(m, batch):
        batches.append(batch)
        out = step(m, f64(batch))
        got.append({k: v.numpy() for k, v in out.items()})
        return out
    trainer._eval_step = rec
    metrics = trainer.evaluate()
    jds = JaxConfig(path=TINY["smoke_synthetic_tiny"]).val_dataset
    jmetric = jds.metric
    jm.eval()
    b = cfg.batch_size
    assert len(got) == len(jds) // b == 2
    with jax.enable_x64(True):
        state = nnx.state(jm)
        nnx.update(jm, jax.tree.map(lambda v: v.astype(np.float64) if
                                    v.dtype == np.float32 else v, state))
        fwd = nnx.jit(lambda m, x: m.test_forward(x))
        for i in range(len(got)):
            jb, metas = jds.collate_fn([jds[j] for j in range(i * b,
                                                              (i + 1) * b)])
            equal_arrays({k: (v.numpy() if isinstance(v, torch.Tensor) else
                              {n: t.numpy() for n, t in v.items()})
                          for k, v in batches[i].items()}, jb)
            ref = jax.device_get(fwd(jm, f64(jb)))
            np.testing.assert_array_equal(got[i]["label_preds"],
                                          ref["label_preds"])
            for key in ("scores", "box3d_cam", "bbox_2d", "alphas"):
                close(got[i][key], ref[key], 1e-9)
            jmetric.update(JaxSMOKE.postprocess_to_samples(ref, metas))
    assert metrics == jmetric.compute()
    assert sum(int((g["scores"] >= 0).sum()) for g in got) > 0
