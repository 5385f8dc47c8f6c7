"""Port parity of the nuScenes point-cloud runtime against the JAX package:
utils/transform3d, NuscenesPCDataset (the v1.0 tables, poses, the sweep
chain LoadPointCloud aggregates, bottom-z boxes with velocities, collate)
and NuScenesMetric, on a small tree of chip_smoke.nuscenes_tree (a train
and a val scene, 10 sweeps before each key frame, 2,000 points a sweep,
objects of the ten detection classes moving at their own speeds). Both
sides are numpy and every comparison is exact, except transform3d's
(1e-15 absolute: the same float64 formulas).

A JAX transform draws from numpy's global state: it runs after
`np.random.seed(s)`, the port's under `np.random.RandomState(s)`.

Also pinned here: reference fault 3 (the JAX SamplingDatabase drops the
velocities, and the collate then writes zero velocity for every box of a
pasted sample), the hand-computed NDS of
tests/parity/test_nuscenes_nds_golden.py, CenterPoint's
postprocess_to_samples handing the metric velocities and sample tokens,
and every nuScenes LiDAR config of configs/ building and collating a train
batch through the port's Config.
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
from paddle3d_tpu.datasets.nuscenes import nuscenes_det as jnusc
from paddle3d_tpu.datasets.nuscenes import nuscenes_metric as jmetric
from paddle3d_tpu.transforms import reader as jreader
from paddle3d_tpu.transforms import sampling as jsampling
from paddle3d_tpu.utils import transform3d as jt3d
from paddle3d_tpu_torch.apis import Config, DataLoader
from paddle3d_tpu_torch.datasets.nuscenes import nuscenes_det as pnusc
from paddle3d_tpu_torch.datasets.nuscenes import nuscenes_metric as pmetric
from paddle3d_tpu_torch.geometries import BBoxes3D
from paddle3d_tpu_torch.models.detection.centerpoint import CenterPoint
from paddle3d_tpu_torch.sample import Sample
from paddle3d_tpu_torch.tools import create_det_gt_database as ptool
from paddle3d_tpu_torch.transforms import reader, sample_rng
from paddle3d_tpu_torch.transforms import sampling as psampling
from paddle3d_tpu_torch.utils import transform3d as pt3d

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PILLARS = os.path.join(REPO, "configs", "centerpoint",
                       "centerpoint_pillars_02voxel_nuscenes_10sweep.yml")
NUSC_CONFIGS = [
    "centerpoint/centerpoint_pillars_02voxel_nuscenes_10sweep.yml",
    "centerpoint/centerpoint_voxels_0075voxel_nuscenes_10sweep.yml",
    "bevfusion/bevf_lidar_nuscenes.yml"]
CLASSES = list(chip_smoke.NUSC_CLASSES)
TRAIN, VAL, POINTS = 3, 2, 2000


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nusc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nuscenes"))
    chip_smoke.nuscenes_tree(root, train=TRAIN, val=VAL, points=POINTS)
    return root


def loader(jax):
    """The configs' LoadPointCloud (5 columns in, 4 used, the time lag)."""
    mod = jreader if jax else reader
    return mod.LoadPointCloud(dim=5, use_dim=4, use_time_lag=True,
                              sweep_remove_radius=1)


def datasets(root, mode, **kw):
    kw = dict(dataset_root=root, version="v1.0-trainval", mode=mode,
              class_names=CLASSES, max_sweeps=10, **kw)
    return (jnusc.NuscenesPCDataset(transforms=[loader(True)], **kw),
            pnusc.NuscenesPCDataset(transforms=[loader(False)], **kw))


def test_transform3d_matches_jax():
    """Every function on random quaternions and poses, within 1e-15."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        q, r = rng.normal(size=4), rng.normal(size=4)
        t = rng.normal(0, 10, 3)
        for name, args in (("quat_to_matrix", (q,)),
                           ("quat_multiply", (q, r)),
                           ("quat_inverse", (q,)), ("quat_yaw", (q,)),
                           ("make_transform", (t, q))):
            np.testing.assert_allclose(getattr(pt3d, name)(*args),
                                       getattr(jt3d, name)(*args),
                                       rtol=0, atol=1e-15)
        m = jt3d.make_transform(t, q)
        np.testing.assert_array_equal(pt3d.invert_transform(m),
                                      jt3d.invert_transform(m))
    assert pt3d.__all__ == jt3d.__all__


@pytest.mark.parametrize("mode", ["train", "val"])
def test_dataset_matches_jax(nusc_root, mode):
    """The split's samples: points (the key frame and its 10 sweeps moved
    into its frame, their order drawn under the seed), boxes, velocities,
    labels, attributes, ids and the sweep references are equal; the tree's
    objects move, so the velocities are not zero; the collated batches
    (velocity columns appended) are equal; frame_labels too."""
    jds, pds = datasets(nusc_root, mode)
    assert pds.sample_tokens == jds.sample_tokens
    assert len(pds) == (TRAIN if mode == "train" else VAL)
    js_all, ps_all = [], []
    for i in range(len(pds)):
        np.random.seed(i)
        js = jds[i]
        ps = pds.get(i, np.random.RandomState(i))
        np.testing.assert_array_equal(np.asarray(ps.data),
                                      np.asarray(js.data))
        assert ps.data.shape[1] == 5 and len(ps.data) > 10 * POINTS
        np.testing.assert_array_equal(np.asarray(ps.bboxes_3d),
                                      np.asarray(js.bboxes_3d))
        np.testing.assert_array_equal(ps.bboxes_3d.velocities,
                                      js.bboxes_3d.velocities)
        np.testing.assert_array_equal(ps.labels, js.labels)
        assert ps.attrs == js.attrs and ps.meta.id == js.meta.id
        assert ps.bboxes_3d.origin == js.bboxes_3d.origin
        assert len(ps.sweeps) == len(js.sweeps) == 10
        for a, b in zip(ps.sweeps, js.sweeps):
            assert a.path == b.path and a.meta.time_lag == b.meta.time_lag
            np.testing.assert_array_equal(a.meta.ref_from_curr,
                                          b.meta.ref_from_curr)
        np.testing.assert_array_equal(pds.frame_labels(i),
                                      jds.frame_labels(i))
        assert np.abs(ps.bboxes_3d.velocities).max() > 1.0
        js_all.append(js)
        ps_all.append(ps)
    (jb, jm), (pb, pm) = jds.collate_fn(js_all), pds.collate_fn(ps_all)
    assert pb["gt_boxes"].shape == (len(pds), pds.max_gt_boxes, 9)
    assert pb["data"].shape == (len(pds), 300000, 5)
    for k in jb:
        np.testing.assert_array_equal(pb[k], jb[k])
    assert [m["id"] for m in pm] == [m["id"] for m in jm]


def test_sample_generator_comes_from_seed_epoch_and_index(nusc_root):
    """ds[i] is ds.get(i) under sample_rng(0, 0, i); the loader hands
    sample_rng(seed, epoch, index); its batches at 1 and 4 threads are
    equal."""
    _, pds = datasets(nusc_root, "train")
    a, b = pds[1], pds.get(1, sample_rng(0, 0, 1))
    np.testing.assert_array_equal(np.asarray(a.data), np.asarray(b.data))
    c = pds.get(1, sample_rng(0, 1, 1))
    assert not np.array_equal(np.asarray(a.data), np.asarray(c.data))
    runs = [[b for b in DataLoader(pds, batch_size=1, shuffle=True, seed=3,
                                   num_workers=w)] for w in (1, 4)]
    for (b1, _), (b4, _) in zip(*runs):
        for k in b1:
            np.testing.assert_array_equal(b1[k], b4[k])


def _predictions(ds, rng, jitter, extra):
    """Per sample: its ground truths moved by `jitter` m with noisy
    velocities, and `extra` random false boxes, random scores; as port
    Samples with pred attributes left to the velocity rule."""
    preds = []
    for tok in ds.sample_tokens:
        boxes, labels, _, _, _ = ds.annotations(tok)
        g = len(boxes)
        fake = rng.uniform([-50, -50, -3, .5, .5, .5, -3, -2, -2],
                           [50, 50, 1, 3, 6, 3, 3, 2, 2], (extra, 9))
        b = np.concatenate([boxes, fake]).astype(np.float32)
        b[:g, :2] += rng.normal(0, jitter, (g, 2))
        b[:, 7:9] += rng.normal(0, 0.3, (len(b), 2))
        s = Sample(path=None, modality="lidar")
        s.bboxes_3d = BBoxes3D(b[:, :7], origin=[.5, .5, 0.],
                               velocities=b[:, 7:9])
        s.labels = np.concatenate([labels, rng.integers(0, 10, extra)])
        s.confidences = rng.uniform(0, 1, len(b)).astype(np.float32)
        s.meta.id = tok
        preds.append(s)
    return preds


@pytest.mark.parametrize("jitter,extra", [(0.0, 0), (0.4, 5), (1.5, 20)])
def test_metric_matches_jax(nusc_root, jitter, extra):
    """The same predictions through both metrics: every value equal; the
    ground truths as predictions score mAP 1 (to 1e-12: the AP is a mean
    of 91 interpolated precisions)."""
    _, pds = datasets(nusc_root, "val")
    jds, _ = datasets(nusc_root, "val")
    preds = _predictions(pds, np.random.default_rng(int(10 * jitter)),
                         jitter, extra)
    got, want = pmetric.NuScenesMetric(pds), jmetric.NuScenesMetric(jds)
    got.update(preds)
    want.update(preds)
    g, w = got.compute(), want.compute()
    assert g == w
    if jitter == 0.0:
        assert g["mAP"] == pytest.approx(1.0, abs=1e-12)
        assert g["mATE"] == 0.0


def test_metric_golden_nds():
    """The hand-computed scene of tests/parity/test_nuscenes_nds_golden.py
    through the port's metric (its stub dataset, the same predictions as
    port Samples): mAP 195/364 and NDS 0.6134375 as derived there."""
    from tests.parity.test_nuscenes_nds_golden import (_make_pred,
                                                        _StubDataset)
    j = _make_pred()
    s = Sample(path=None, modality="lidar")
    s.bboxes_3d = BBoxes3D(np.asarray(j.bboxes_3d), origin=[.5, .5, .5],
                           velocities=np.asarray(j.bboxes_3d.velocities))
    s.labels, s.confidences = j.labels, j.confidences
    s.pred_attrs, s.meta.id = j.pred_attrs, j.meta.id
    metric = pmetric.NuScenesMetric(_StubDataset())
    metric.update([s])
    res = metric.compute()
    map_ = (24 / 91 + 3 * 57 / 91) / 4
    mate = (23 * 0.3 + 33 * 0.425) / 56
    maoe = (23 * 0.2 + 33 * 0.15) / 56
    np.testing.assert_allclose(res["mAP"], map_, atol=1e-9)
    np.testing.assert_allclose(res["mATE"], mate, atol=1e-9)
    np.testing.assert_allclose(res["mAOE"], maoe, atol=1e-9)
    np.testing.assert_allclose(
        res["NDS"], (5 * map_ + (1 - mate) + 1 + (1 - maoe) + 0 + 1) / 10,
        atol=1e-9)


def test_centerpoint_postprocess_hands_the_metric_velocities(nusc_root):
    """The val ground truths as CenterPoint's 9-column outputs (x, y, z,
    w, l, h, vx, vy, yaw), through postprocess_to_samples (the collated
    metas carry the sample tokens) into NuScenesMetric: mAP 1, mATE and
    mAVE 0."""
    _, pds = datasets(nusc_root, "val")
    samples = [pds[i] for i in range(len(pds))]
    _, metas = pds.collate_fn(samples)
    g = max(len(s.bboxes_3d) for s in samples)
    out = np.zeros((len(samples), g, 9), np.float32)
    scores = np.full((len(samples), g), -1.0, np.float32)
    labels = np.full((len(samples), g), -1, np.int32)
    for i, s in enumerate(samples):
        b, n = np.asarray(s.bboxes_3d), len(s.bboxes_3d)
        out[i, :n] = np.c_[b[:, :6], s.bboxes_3d.velocities, b[:, 6]]
        scores[i, :n] = np.linspace(1.0, 0.5, n)
        labels[i, :n] = s.labels
    preds = CenterPoint.postprocess_to_samples(
        {"box3d_lidar": out, "scores": scores, "label_preds": labels}, metas)
    assert [p.meta.id for p in preds] == pds.sample_tokens
    metric = pds.metric
    metric.update(preds)
    res = metric.compute()
    assert res["mAP"] == pytest.approx(1.0, abs=1e-12)
    assert res["mATE"] == 0.0
    assert res["mAVE"] < 1e-6


@pytest.fixture(scope="module")
def nusc_db(nusc_root, tmp_path_factory):
    """The CenterPoint-pillars nuScenes config pointed at the tree, its
    database built by the port tool. -> (dic, SamplingDatabase kwargs)."""
    dic = chip_smoke.lidar_dic(PILLARS, nusc_root)
    yml = chip_smoke.write_yaml(dic, str(
        tmp_path_factory.mktemp("cfg") / "cp_nusc.yml"))
    ptool.main(ptool.parse_args(["--config", yml]))
    entry = [t for t in dic["train_dataset"]["transforms"]
             if t["type"] == "SamplingDatabase"][0]
    return dic, {k: v for k, v in entry.items() if k != "type"}


def test_database_keeps_five_columns_and_velocities(nusc_db):
    """The port tool's nuScenes database: entries of 5 columns (x, y, z,
    intensity, time lag) with the boxes' velocities, under the config's
    own paths."""
    _, kw = nusc_db
    db = psampling.SamplingDatabase(**kw)
    assert set(db.samplers) <= set(CLASSES) and len(db.samplers) >= 8
    for sampler in db.samplers.values():
        for a in sampler.annos:
            assert a["lidar_dim"] == 5 and len(a["velocity"]) == 2
            pts = db._load_points(a)
            assert pts.shape == (a["num_points_in_box"], 5)
    moving = [a["velocity"] for a in db.samplers["car"].annos]
    assert np.abs(moving).max() > 1.0


def test_jax_sampling_drops_velocities_and_the_port_keeps_them(nusc_root,
                                                                nusc_db):
    """Reference fault 3: after a paste the JAX transform's boxes carry no
    velocities, so the JAX collate writes zero velocity for every box of
    the sample, the scene's moving boxes included. The port's pasted sample
    keeps its boxes' velocities and gives each pasted box its database
    entry's; its pasted points have the scene's 5 columns."""
    _, kw = nusc_db
    jdb, pdb = jsampling.SamplingDatabase(**kw), psampling.SamplingDatabase(
        **kw)
    jds, pds = datasets(nusc_root, "train")
    np.random.seed(0)
    js = jdb(jds[0])
    ps0 = pds.get(0, sample_rng(0, 0, 0))
    g0, n0 = len(ps0.labels), len(ps0.data)
    vel0 = np.array(ps0.bboxes_3d.velocities)
    ps = pdb(ps0)
    assert len(js.labels) > g0 and len(ps.labels) > g0
    assert js.bboxes_3d.velocities is None
    jbatch, _ = jds.collate_fn([js])
    assert np.abs(jbatch["gt_boxes"][0, :g0, 7:9]).max() == 0.0
    vel = ps.bboxes_3d.velocities
    assert vel.shape == (len(ps.labels), 2)
    np.testing.assert_array_equal(vel[:g0], vel0)
    entries = {tuple(np.float32(a["box3d"])): a["velocity"]
               for s in pdb.samplers.values() for a in s.annos}
    for box, v in zip(np.asarray(ps.bboxes_3d)[g0:], vel[g0:]):
        np.testing.assert_array_equal(v, np.float32(entries[tuple(box)]))
    assert np.abs(vel[g0:]).max() > 1.0
    pbatch, _ = pds.collate_fn([ps])
    np.testing.assert_array_equal(pbatch["gt_boxes"][0, :len(vel), 7:9], vel)
    assert ps.data.shape[1] == 5 and len(ps.data) > n0


@pytest.mark.parametrize("path", NUSC_CONFIGS)
def test_nuscenes_configs_build_and_collate_a_train_batch(path, nusc_root,
                                                          tmp_path):
    """Every nuScenes LiDAR config of configs/ through the port's Config on
    the tree (a SamplingDatabase's database built by the port tool from the
    config itself): both datasets build, and two train samples collate to
    300,000 rows of 5 columns and 9-column boxes whose velocities are not
    all zero."""
    path = os.path.join(REPO, "configs", path)
    dic = chip_smoke.lidar_dic(path, nusc_root)
    types = [t["type"] for t in dic["train_dataset"]["transforms"]]
    if "SamplingDatabase" in types:
        entry = dic["train_dataset"]["transforms"][types.index(
            "SamplingDatabase")]
        entry["database_anno_path"] = str(tmp_path / "db" / "anno.pkl")
        yml = chip_smoke.write_yaml(dic, str(tmp_path / "cfg.yml"))
        ptool.main(ptool.parse_args(["--config", yml]))
    cfg = Config(dic=dic, device="cpu")
    ds, val = cfg.train_dataset, cfg.val_dataset
    assert type(ds).__name__ == type(val).__name__ == "NuscenesPCDataset"
    assert (len(ds), len(val)) == (TRAIN, VAL)
    batch, metas = ds.collate_fn([ds[0], ds[1]])
    assert batch["data"].shape == (2, 300000, 5)
    assert batch["gt_boxes"].shape == (2, 128, 9)
    assert np.abs(batch["gt_boxes"][..., 7:9]).max() > 1.0
    assert [m["id"] for m in metas] == ds.sample_tokens[:2]
