"""Port parity of the Waymo point-cloud runtime against the JAX package:
WaymoPCDataset (the converted layout: {mode}_infos.pkl and .npy scans) and
WaymoMetric (L1 / L2 AP and APH), on a small tree of chip_smoke.waymo_tree
(vehicles, pedestrians and cyclists on a 10 m grid, 3,000 points a scan).
Both sides are numpy and every comparison is exact.

A JAX transform draws from numpy's global state: it runs after
`np.random.seed(s)`, the port's under `np.random.RandomState(s)`.

Also pinned here: the JAX dataset sets the points itself, so the
LoadPointCloud that starts iassd_waymo.yml's pipelines raises there; the
port's pipeline reads them. And iassd_waymo.yml building and collating a
train batch through the port's Config, and IA-SSD's postprocess_to_samples
handing WaymoMetric the frame ids.
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
from paddle3d_tpu.datasets.waymo import waymo_det as jwaymo
from paddle3d_tpu.transforms import reader as jreader
from paddle3d_tpu.transforms import transform as jtf
from paddle3d_tpu_torch.apis import Config
from paddle3d_tpu_torch.datasets.waymo import waymo_det as pwaymo
from paddle3d_tpu_torch.geometries import BBoxes3D
from paddle3d_tpu_torch.models.detection.iassd import IASSD
from paddle3d_tpu_torch.sample import Sample
from paddle3d_tpu_torch.transforms import reader
from paddle3d_tpu_torch.transforms import transform as tf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAYMO = os.path.join(REPO, "configs", "iassd", "iassd_waymo.yml")
RANGE = [-75.2, -75.2, -2.0, 75.2, 75.2, 4.0]
TRAIN, VAL, POINTS = 3, 2, 3000


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def waymo_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("waymo"))
    chip_smoke.waymo_tree(root, train=TRAIN, val=VAL, points=POINTS)
    return root


def samples_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a.data), np.asarray(b.data))
    np.testing.assert_array_equal(np.asarray(a.bboxes_3d),
                                  np.asarray(b.bboxes_3d))
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_array_equal(a.num_points_in_gt, b.num_points_in_gt)
    assert a.meta.id == b.meta.id and a.bboxes_3d.origin == b.bboxes_3d.origin


@pytest.mark.parametrize("mode", ["train", "val"])
def test_dataset_matches_jax(waymo_root, mode):
    """Without transforms (the dataset loads the .npy) and with the config's
    val pipeline after the loader (range filter, 65,536 sampled points)
    under a seed: samples and collated batches (180,000 rows) equal."""
    jds = jwaymo.WaymoPCDataset(waymo_root, mode=mode)
    pds = pwaymo.WaymoPCDataset(waymo_root, mode=mode)
    assert len(pds) == len(jds) == (TRAIN if mode == "train" else VAL)
    for i in range(len(pds)):
        samples_equal(pds[i], jds[i])
        assert pds[i].data.shape == (POINTS, 4)
    jds = jwaymo.WaymoPCDataset(waymo_root, mode=mode, transforms=[
        jtf.FilterPointOutsideRange(RANGE), jtf.SamplePoint(65536)])
    pds = pwaymo.WaymoPCDataset(waymo_root, mode=mode, transforms=[
        tf.FilterPointOutsideRange(RANGE), tf.SamplePoint(65536)])
    js_all, ps_all = [], []
    for i in range(len(pds)):
        np.random.seed(i)
        js_all.append(jds[i])
        ps_all.append(pds.get(i, np.random.RandomState(i)))
        samples_equal(ps_all[-1], js_all[-1])
    (jb, _), (pb, _) = jds.collate_fn(js_all), pds.collate_fn(ps_all)
    assert pb["data"].shape == (len(pds), 180000, 4)
    for k in jb:
        np.testing.assert_array_equal(pb[k], jb[k])


def test_jax_pipeline_cannot_load_and_the_port_reads_the_npy(waymo_root):
    """iassd_waymo.yml's pipelines start with LoadPointCloud: the JAX
    dataset has already set the points, so it raises; the port's dataset
    leaves them to the loader, which reads the .npy (the JAX reader's
    np.fromfile would read its header as points) and gives the points the
    JAX dataset loads itself."""
    jds = jwaymo.WaymoPCDataset(waymo_root, mode="val", transforms=[
        jreader.LoadPointCloud(dim=4, use_dim=4)])
    with pytest.raises(ValueError, match="already set"):
        jds[0]
    pds = pwaymo.WaymoPCDataset(waymo_root, mode="val", transforms=[
        reader.LoadPointCloud(dim=4, use_dim=4)])
    samples_equal(pds[0], jwaymo.WaymoPCDataset(waymo_root, mode="val")[0])
    with pytest.raises(ValueError, match="not \\[N, 5\\]"):
        reader.LoadPointCloud(dim=5)(pds[0].__class__(
            path=pds[0].path, modality="lidar"))


def _predictions(ds, rng, jitter, extra):
    """Per frame: its boxes moved by `jitter` m and turned by up to 0.3
    rad, and `extra` random false boxes, random scores."""
    preds = []
    for info in ds.infos:
        boxes = np.asarray(info["boxes"], np.float32)
        g = len(boxes)
        fake = rng.uniform([-60, -60, -1, .5, .5, 1, -3],
                           [60, 60, 1, 3, 6, 2, 3], (extra, 7))
        b = np.concatenate([boxes, fake]).astype(np.float32)
        b[:g, :2] += rng.normal(0, jitter, (g, 2))
        b[:g, 6] += rng.uniform(-0.3, 0.3, g)
        s = Sample(path=None, modality="lidar")
        s.bboxes_3d = BBoxes3D(b, origin=[.5, .5, 0.])
        s.labels = np.concatenate([info["labels"],
                                   rng.integers(0, 3, extra)])
        s.confidences = rng.uniform(0, 1, len(b)).astype(np.float32)
        s.meta.id = info["frame_id"]
        preds.append(s)
    return preds


@pytest.mark.parametrize("jitter,extra", [(0.0, 0), (0.3, 6), (1.0, 30)])
def test_metric_matches_jax(waymo_root, jitter, extra):
    """The same predictions through both metrics: every AP and APH equal;
    the unjittered boxes score 100 AP at both levels."""
    jds = jwaymo.WaymoPCDataset(waymo_root, mode="val")
    pds = pwaymo.WaymoPCDataset(waymo_root, mode="val")
    preds = _predictions(pds, np.random.default_rng(int(10 * jitter)),
                         jitter, extra)
    got, want = pds.metric, jds.metric
    got.update(preds)
    want.update(preds)
    g, w = got.compute(), want.compute()
    assert g == w and len(g) == 12
    if jitter == 0.0:
        assert all(g["{} {} AP".format(c, lv)] == 100.0
                   for c in ("Vehicle", "Pedestrian", "Cyclist")
                   for lv in ("L1", "L2"))


def test_iassd_postprocess_hands_the_metric_frame_ids(waymo_root):
    """The val boxes as IA-SSD's outputs through postprocess_to_samples
    (the collated metas carry the frame ids) into WaymoMetric: 100 AP."""
    pds = pwaymo.WaymoPCDataset(waymo_root, mode="val")
    samples = [pds[i] for i in range(len(pds))]
    _, metas = pds.collate_fn(samples)
    g = max(len(s.labels) for s in samples)
    out = np.zeros((len(samples), g, 7), np.float32)
    scores = np.full((len(samples), g), -1.0, np.float32)
    labels = np.full((len(samples), g), -1, np.int32)
    for i, s in enumerate(samples):
        n = len(s.labels)
        out[i, :n], scores[i, :n], labels[i, :n] = s.bboxes_3d, 1.0, s.labels
    metric = pds.metric
    metric.update(IASSD.postprocess_to_samples(
        {"box3d_lidar": out, "scores": scores, "label_preds": labels},
        metas))
    res = metric.compute()
    assert all(v == 100.0 for k, v in res.items() if k.endswith(" AP"))


def test_waymo_config_builds_and_collates_a_train_batch(waymo_root):
    """iassd_waymo.yml through the port's Config on the tree: both datasets
    build, and two train samples (65,536 sampled points) collate to
    180,000 rows of 4 columns with their boxes."""
    dic = chip_smoke.lidar_dic(WAYMO, waymo_root)
    cfg = Config(dic=dic, device="cpu")
    ds, val = cfg.train_dataset, cfg.val_dataset
    assert type(ds).__name__ == type(val).__name__ == "WaymoPCDataset"
    assert (len(ds), len(val)) == (TRAIN, VAL)
    batch, metas = ds.collate_fn([ds[0], ds[1]])
    assert batch["data"].shape == (2, 180000, 4)
    assert np.isfinite(batch["data"][:, :65536]).all()
    assert np.isnan(batch["data"][:, 65536:]).all()
    assert (batch["gt_labels"] >= 0).sum() > 20
    assert [m["id"] for m in metas] == [ds.infos[0]["frame_id"],
                                        ds.infos[1]["frame_id"]]
