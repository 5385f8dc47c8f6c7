"""Port parity of the nuScenes multi-view and Apollo camera runtime against
the JAX package on the CPU, on small trees of chip_smoke.nuscenes_tree
(six cameras a key frame as 90 x 160 baseline JPEGs from its numpy
encoder, `prev` links between key frames, 2,000-point sweeps, BEV map
npz files) and chip_smoke.apollo_tree (90 x 160 JPEGs): NuscenesMVDataset
(plain, bevdet_format + adjacent, two adjacent frames, with_depth),
NuscenesMVSegDataset with LoadMapsFromFiles, NuscenesMMDataset with
LoadPointCloud, every multi-view transform under a seed, batches at 1 and
4 loader threads, the four camera models' postprocess_to_samples (the
JAX package's aliases), NuScenesSegMetric, the nine configs of configs/
that read these datasets, ApolloLaneDataset and ApolloLaneMetric.

Every comparison is exact: the JAX datasets decode with Pillow and the
port with its own JPEG decoder and resize, byte-equal to Pillow's. A JAX
transform draws from numpy's global state after `np.random.seed(s)`; the
port's from `np.random.RandomState(s)`.

Pinned here (ROADMAP.md, section 3): the JAX BEV-LaneDet
postprocess_to_samples drops `lane_height`, which its ApolloLaneMetric
reads at every confident cell; the JAX GlobalRotScaleTransImage raises on
a sample without gt.
"""
import copy
import os

import numpy as np
import pytest
import torch

import chip_smoke
from paddle3d_tpu.apis.config import Config as JaxConfig
from paddle3d_tpu.datasets.apollo import apollo_lane as japollo
from paddle3d_tpu.datasets.nuscenes import nuscenes_multi_modality as jmm
from paddle3d_tpu.datasets.nuscenes import nuscenes_multiview_det as jmv
from paddle3d_tpu.models.detection.bev_lanedet.bev_lanedet import \
    BEVLaneDet as JaxBEVLaneDet
from paddle3d_tpu.models.detection.bevdet.bevdet import BEVDet as JaxBEVDet
from paddle3d_tpu.models.detection.bevformer.bevformer import \
    BEVFormer as JaxBEVFormer
from paddle3d_tpu.models.detection.bevfusion.bevfusion import \
    BEVFusion as JaxBEVFusion
from paddle3d_tpu.models.detection.rtebev.rtebev import RTEBev as JaxRTEBev
from paddle3d_tpu.sample import Sample as JaxSample
from paddle3d_tpu.transforms import multiview as jtf
from paddle3d_tpu.transforms import reader as jreader
from paddle3d_tpu_torch.apis import Config, DataLoader
from paddle3d_tpu_torch.datasets.apollo import apollo_lane as papollo
from paddle3d_tpu_torch.datasets.nuscenes import \
    nuscenes_multi_modality as pmm
from paddle3d_tpu_torch.datasets.nuscenes import \
    nuscenes_multiview_det as pmv
from paddle3d_tpu_torch.models.detection import (BEVDet, BEVFormer,
                                                 BEVFusion, BEVLaneDet,
                                                 RTEBev)
from paddle3d_tpu_torch.sample import Sample
from paddle3d_tpu_torch.transforms import multiview as ptf
from paddle3d_tpu_torch.transforms import reader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
TRAIN, VAL, POINTS = 4, 2, 2000
CAM_HW = (90, 160)
HW = (64, 176)          # the datasets' image_size here
MAP_HW = (32, 32)
VERSION = "v1.0-trainval"
MV_CONFIGS = [
    "petr/petr_vovnet_gridmask_p4_800x320",
    "bevdet/bevdet4d_r50_depth_nuscenes",
    "bevformer/bevformer_tiny_r50_fpn_nuscenes",
    "cape/cape_t_v99_800x320",
    "rtebev/rtebev_r50_nuscenes_256x704_msdepth_hybrid_1f",
    "bevfusion/bevf_cam_nuscenes",
    "petr/petrv2_BEVseg_800x320",
    "bevfusion/bevf_pp_nuscenes",
    "bev_lanedet/bev_lanedet_apollo_576x1024"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nusc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nuscenes_mv"))
    chip_smoke.nuscenes_tree(root, train=TRAIN, val=VAL, points=POINTS,
                             cameras=CAM_HW, maps=MAP_HW)
    return root


@pytest.fixture(scope="module")
def apollo_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("apollo"))
    chip_smoke.apollo_tree(root, 3, 2, hw=CAM_HW)
    return root


def seeded(ds, i, jax):
    """Sample i of a dataset: the JAX one after np.random.seed(i), the
    port's under RandomState(i)."""
    if jax:
        np.random.seed(i)
        return ds[i]
    return ds.get(i, np.random.RandomState(i))


def assert_batches_equal(pb, jb):
    assert sorted(pb) == sorted(jb)
    for k in jb:
        np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)


@pytest.mark.parametrize("kw", [
    {}, {"bevdet_format": True, "adjacent": True}, {"adjacent": 2},
    {"with_depth": True, "bevdet_format": True, "adjacent": 1}],
    ids=["plain", "bevdet_adjacent", "two_adjacent", "depth"])
@pytest.mark.parametrize("mode", ["train", "val"])
def test_mv_dataset_matches_jax(nusc_root, kw, mode):
    """Images byte-equal (decode and BICUBIC resize), matrices, can_bus,
    depth maps and gt equal; the can_bus moves between key frames."""
    p = pmv.NuscenesMVDataset(nusc_root, VERSION, mode, image_size=HW, **kw)
    j = jmv.NuscenesMVDataset(nusc_root, VERSION, mode, image_size=HW, **kw)
    assert len(p) == len(j) == (TRAIN if mode == "train" else VAL)
    idx = [0, len(p) - 1]
    pb, pm = p.collate_fn([p[i] for i in idx])
    jb, jm = j.collate_fn([j[i] for i in idx])
    assert_batches_equal(pb, jb)
    assert pm == jm
    assert pb["img"].shape == (2, 6, *HW, 3)
    assert np.abs(pb["can_bus"][1, :3]).max() > 0.1
    if kw.get("with_depth"):
        assert (pb["gt_depth"] > 0).sum(axis=(2, 3)).min() > 10


def test_seg_dataset_and_map_loader_match_jax(nusc_root):
    tf = [{"LoadMapsFromFiles": {}}, {"NormalizeMultiviewImage": {
        "mean": [103.53, 116.28, 123.675], "std": [57.375, 57.12, 58.395]}}]

    def build(mod, tmod):
        return mod.NuscenesMVSegDataset(
            nusc_root, VERSION, "train", image_size=HW, transforms=[
                getattr(tmod, name)(**a) for t in tf
                for name, a in t.items()])
    p = build(pmv, type("M", (), {"LoadMapsFromFiles":
                                  reader.LoadMapsFromFiles,
                                  "NormalizeMultiviewImage":
                                  ptf.NormalizeMultiviewImage}))
    j = build(jmv, type("M", (), {"LoadMapsFromFiles":
                                  jreader.LoadMapsFromFiles,
                                  "NormalizeMultiviewImage":
                                  jtf.NormalizeMultiviewImage}))
    pb, _ = p.collate_fn([p[0], p[2]])
    jb, _ = j.collate_fn([j[0], j[2]])
    assert_batches_equal(pb, jb)
    assert pb["gt_semantic_map"].shape == (2, *MAP_HW, 3)
    assert pb["gt_semantic_map"].dtype == np.float32


def test_mm_dataset_matches_jax(nusc_root):
    """Points with their sweeps (the sweep order under a seed), six views,
    the BEVDet matrices, 9-column gt and the Gaussian depth targets."""
    kw = dict(image_size=HW, max_sweeps=3, with_depth_dist=True,
              depth_stride=16)
    p = pmm.NuscenesMMDataset(nusc_root, VERSION, "train", transforms=[
        reader.LoadPointCloud(dim=5, use_dim=4, use_time_lag=True)], **kw)
    j = jmm.NuscenesMMDataset(nusc_root, VERSION, "train", transforms=[
        jreader.LoadPointCloud(dim=5, use_dim=4, use_time_lag=True)], **kw)
    pb, pm = p.collate_fn([seeded(p, i, False) for i in (1, 3)])
    jb, jm = j.collate_fn([seeded(j, i, True) for i in (1, 3)])
    assert sorted(pb) == sorted(jb)
    for k in jb:
        np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
    assert pm == jm
    assert pb["img_depth"].shape == (2, 6, HW[0] // 16, HW[1] // 16, 42)
    assert np.abs(pb["gt_boxes"][..., 7:9]).max() > 1.0


def mv_sample(mod, rng, boxes3d=None):
    """A multi-view sample of 3 views of 24 x 40 (integer pixel values,
    as the datasets give them), random camera matrices and 9-column gt."""
    s = mod(path=None, modality="multiview")
    s.img = rng.integers(0, 256, (3, 24, 40, 3)).astype(np.float32)
    l2i = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    l2i[:, :3, :] += rng.normal(0, 0.1, (3, 3, 4)).astype(np.float32)
    s.meta.lidar2imgs = l2i
    s.meta.img2lidars = np.linalg.inv(l2i)
    s.bboxes_3d = boxes3d if boxes3d is not None else rng.normal(
        0, 5, (4, 9)).astype(np.float32)
    return s


TRANSFORMS = [
    ("NormalizeMultiviewImage", {"mean": [1.0, 2.0, 3.0],
                                 "std": [2.0, 3.0, 4.0]}),
    ("PadMultiViewImage", {"size_divisor": 32}),
    ("ResizeCropFlipImage", {"resize_range": (0.8, 1.3),
                             "final_size": (24, 40)}),
    ("ResizeCropFlipImage", {"final_size": (20, 36), "rand_flip": False,
                             "training": False}),
    ("GridMask", {"ratio": 0.5, "prob": 0.9, "max_d": 20}),
    ("GlobalRotScaleTransImage", {"translation_std": (0.5, 0.5, 0.2)}),
    ("GlobalRotScaleTransImage", {}),
    ("PhotoMetricDistortionMultiViewImage", {}),
    ("RandomScaleImageMultiViewImage", {"scales": (0.5, 0.75, 1.25)}),
    ("MSResizeCropFlipImage", {"final_size": (24, 40)})]


@pytest.mark.parametrize("name,kw", TRANSFORMS,
                         ids=["{}{}".format(n, i) for i, (n, _) in
                              enumerate(TRANSFORMS)])
def test_multiview_transform_matches_jax_under_a_seed(name, kw):
    for seed in range(4):
        rng = np.random.default_rng(seed)
        ps = mv_sample(Sample, rng)
        js = mv_sample(JaxSample, np.random.default_rng(seed))
        ps.rng = np.random.RandomState(seed)
        np.random.seed(seed)
        js = getattr(jtf, name)(**kw)(js)
        ps = getattr(ptf, name)(**kw)(ps)
        np.testing.assert_array_equal(ps.img, js.img)
        for k in ("lidar2imgs", "img2lidars"):
            np.testing.assert_array_equal(ps.meta[k], js.meta[k])
        np.testing.assert_array_equal(np.asarray(ps.bboxes_3d),
                                      np.asarray(js.bboxes_3d))


def test_rot_scale_moves_bboxes3d_in_place_as_jax():
    """GlobalRotScaleTransImage on a 7-column BBoxes3D (the multi-modality
    dataset's): moved in place, equal to the JAX transform's."""
    from paddle3d_tpu.geometries import BBoxes3D as JaxBBoxes3D
    from paddle3d_tpu_torch.geometries import BBoxes3D
    boxes = np.random.default_rng(2).normal(0, 5, (5, 7)).astype(np.float32)
    ps = mv_sample(Sample, np.random.default_rng(1), BBoxes3D(boxes.copy()))
    js = mv_sample(JaxSample, np.random.default_rng(1),
                   JaxBBoxes3D(boxes.copy()))
    ps.rng = np.random.RandomState(9)
    np.random.seed(9)
    kept = ps.bboxes_3d
    ps = ptf.GlobalRotScaleTransImage()(ps)
    js = jtf.GlobalRotScaleTransImage()(js)
    assert ps.bboxes_3d is kept
    np.testing.assert_array_equal(np.asarray(ps.bboxes_3d),
                                  np.asarray(js.bboxes_3d))
    assert not np.array_equal(np.asarray(kept), boxes)


def test_rot_scale_without_boxes_moves_the_matrices_where_jax_raises():
    """A sample without gt (a test-mode sample): the JAX
    GlobalRotScaleTransImage takes len() of np.asarray(None) and raises
    TypeError; the port's moves the camera matrices alone (pinned,
    ROADMAP.md section 3)."""
    ps = mv_sample(Sample, np.random.default_rng(3))
    js = mv_sample(JaxSample, np.random.default_rng(3))
    ps.bboxes_3d = js.bboxes_3d = None
    ps.rng = np.random.RandomState(4)
    np.random.seed(4)
    with pytest.raises(TypeError):
        jtf.GlobalRotScaleTransImage()(js)
    before = ps.meta.lidar2imgs.copy()
    ps = ptf.GlobalRotScaleTransImage()(ps)
    assert ps.bboxes_3d is None
    assert not np.array_equal(ps.meta.lidar2imgs, before)
    np.testing.assert_allclose(ps.meta.img2lidars @ ps.meta.lidar2imgs,
                               np.tile(np.eye(4), (3, 1, 1)), atol=1e-5)


def rooted(name, nusc_root, apollo_root):
    path = os.path.join(CONFIGS, name + ".yml")
    root = apollo_root if "apollo" in name else nusc_root
    dic = Config(path=path, device="cpu").dic
    jdic = JaxConfig(path=path).dic
    for d in (dic, jdic):
        for split in ("train_dataset", "val_dataset"):
            d[split]["dataset_root"] = root
    return dic, jdic


def test_loader_batches_do_not_depend_on_workers(nusc_root, apollo_root):
    """PETR's train pipeline (a random resize, crop and flip, a BEV
    rotation and scale, GridMask) through the port's DataLoader: the
    batches at 1 and 4 threads are equal."""
    dic, _ = rooted(MV_CONFIGS[0], nusc_root, apollo_root)
    dic["train_dataset"]["image_size"] = [32, 80]
    for t in dic["train_dataset"]["transforms"]:
        if "final_size" in t:
            t["final_size"] = [32, 80]
    ds = Config(dic={"train_dataset": dic["train_dataset"]},
                device="cpu").train_dataset
    runs = [list(DataLoader(ds, batch_size=2, shuffle=True, seed=3,
                            num_workers=w)) for w in (1, 4)]
    assert len(runs[0]) == TRAIN // 2
    for (b1, m1), (b4, m4) in zip(*runs):
        assert m1 == m4
        assert_batches_equal(b1, b4)


@pytest.mark.parametrize("name", MV_CONFIGS)
def test_configs_build_and_collate_a_train_batch(name, nusc_root,
                                                 apollo_root):
    """Each of the nine configs builds both datasets through the port's
    Config on the small trees (of the JAX config's type and length), and
    two train samples collate to the JAX config's keys, shapes and
    dtypes, images included at the config's own size."""
    dic, jdic = rooted(name, nusc_root, apollo_root)
    cfg = Config(dic=dic, device="cpu")
    ds, val = cfg.train_dataset, cfg.val_dataset
    jds = JaxConfig(dic={"train_dataset": jdic["train_dataset"]}
                    ).train_dataset
    assert type(ds).__name__ == type(jds).__name__
    assert len(ds) == len(jds) and len(val) > 0
    pb, _ = ds.collate_fn([seeded(ds, i, False) for i in (0, 1)])
    jb, _ = jds.collate_fn([seeded(jds, i, True) for i in (0, 1)])
    assert {k: (v.shape, v.dtype) for k, v in pb.items()} == \
        {k: (v.shape, v.dtype) for k, v in jb.items()}


def lidar_outputs(rng, b=2, k=8, cols=9):
    scores = np.where(rng.random((b, k)) < 0.3, -1.0,
                      rng.random((b, k))).astype(np.float32)
    return {"box3d_lidar": rng.normal(0, 8, (b, k, cols)).astype(np.float32),
            "scores": scores,
            "label_preds": rng.integers(0, 10, (b, k)).astype(np.int32)}


@pytest.mark.parametrize("port,jax", [(BEVDet, JaxBEVDet),
                                      (BEVFusion, JaxBEVFusion),
                                      (BEVFormer, JaxBEVFormer),
                                      (RTEBev, JaxRTEBev)],
                         ids=["BEVDet", "BEVFusion", "BEVFormer", "RTEBev"])
def test_postprocess_to_samples_matches_jax(port, jax):
    """BEVDet and BEVFusion's are CenterPoint's, BEVFormer and RTEBev's
    PETR's, in both packages: equal boxes, velocities, labels, scores,
    frames and metas on the same outputs."""
    rng = np.random.default_rng(3)
    out = lidar_outputs(rng)
    metas = [{"path": "a", "id": "t0"}, {"path": "b", "id": "t1"}]
    ps = port.postprocess_to_samples(out, metas)
    js = jax.postprocess_to_samples(out, metas)
    assert len(ps) == len(js) == 2
    for p, j in zip(ps, js):
        assert (p.path, p.modality, dict(p.meta)) == (j.path, j.modality,
                                                      dict(j.meta))
        np.testing.assert_array_equal(np.asarray(p.bboxes_3d),
                                      np.asarray(j.bboxes_3d))
        np.testing.assert_array_equal(p.bboxes_3d.velocities,
                                      j.bboxes_3d.velocities)
        assert p.bboxes_3d.coordmode.name == j.bboxes_3d.coordmode.name
        for k in ("labels", "confidences"):
            np.testing.assert_array_equal(p[k], j[k])


def test_seg_metric_matches_jax(nusc_root):
    """Detections and BEV probabilities for the val frames through both
    NuScenesSegMetric: every value equal; the gt maps as probabilities
    give IoU 1."""
    p = pmv.NuscenesMVSegDataset(nusc_root, VERSION, "val", image_size=HW)
    j = jmv.NuscenesMVSegDataset(nusc_root, VERSION, "val", image_size=HW)
    rng = np.random.default_rng(4)
    out = lidar_outputs(rng, b=len(p))
    metas = [{"path": "x", "id": t} for t in p.sample_tokens]
    res = []
    for exact in (False, True):
        gt = np.stack([np.load(os.path.join(p.maps_root, t + ".npz"))[
            "arr_0"] for t in p.sample_tokens]).astype(np.float32)
        out["seg_probs"] = gt if exact else rng.random(gt.shape).astype(
            np.float32)
        got = pmv.NuScenesSegMetric(p)
        want = jmv.NuScenesSegMetric(j)
        from paddle3d_tpu.models.detection.petr.petr3d import PETR as JPETR
        from paddle3d_tpu_torch.models.detection import PETR
        got.update(PETR.postprocess_to_samples(out, metas))
        want.update(JPETR.postprocess_to_samples(out, metas))
        g, w = got.compute(), want.compute()
        assert g == w
        res.append(g)
    assert res[1]["IoU_drive"] == res[1]["IoU_lane"] == \
        res[1]["IoU_vehicle"] == 1.0
    assert res[0]["IoU_drive"] < 0.5


def test_apollo_dataset_matches_jax(apollo_root):
    kw = dict(image_size=(48, 80), bev_size=(100, 25))
    for mode, anno in (("train", "standard/train.json"),
                       ("val", "standard/test.json")):
        p = papollo.ApolloLaneDataset(apollo_root, anno, mode, **kw)
        j = japollo.ApolloLaneDataset(apollo_root, anno, mode, **kw)
        assert len(p) == len(j) > 0
        pb, pm = p.collate_fn([p[i] for i in range(len(p))])
        jb, jm = j.collate_fn([j[i] for i in range(len(j))])
        assert_batches_equal(pb, jb)
        assert pm == jm
        assert pb["lane_conf"].sum() > 50


def lane_outputs(ds):
    """The dataset's own targets as BEV-LaneDet's outputs: confidence,
    offset, height, and an embedding that puts each lane 10 apart."""
    samples = [ds[i] for i in range(len(ds))]
    emb = np.stack([s.lane_instance for s in samples]).astype(
        np.float32)[..., None] * np.array([10.0, 0, 0, 0], np.float32)
    return {"lane_conf": np.stack([s.lane_conf for s in samples]),
            "lane_offset": np.stack([s.lane_offset for s in samples]),
            "lane_height": np.stack([s.lane_height for s in samples]),
            "lane_embed": emb}, [{"path": s.path, "id": s.meta.id}
                                 for s in samples]


def test_apollo_metric_matches_jax_and_the_jax_postprocess_drops_height(
        apollo_root):
    """The val targets as outputs: the port's postprocess_to_samples into
    both metrics gives equal results, every lane found (F-score 1). The
    JAX postprocess_to_samples drops lane_height, so its own metric raises
    at the first confident cell (pinned, ROADMAP.md section 3)."""
    kw = dict(image_size=(48, 80), bev_size=(100, 25))
    p = papollo.ApolloLaneDataset(apollo_root, "standard/test.json", "val",
                                  **kw)
    j = japollo.ApolloLaneDataset(apollo_root, "standard/test.json", "val",
                                  **kw)
    out, metas = lane_outputs(p)
    preds = BEVLaneDet.postprocess_to_samples(
        {k: torch.from_numpy(v) for k, v in out.items()}, metas)
    got, want = papollo.ApolloLaneMetric(p), japollo.ApolloLaneMetric(j)
    got.update(preds)
    want.update(copy.deepcopy(preds))
    assert got.compute() == want.compute()
    assert got.compute()["F-score"] == 1.0
    jpreds = JaxBEVLaneDet.postprocess_to_samples(out, metas)
    with pytest.raises(AttributeError, match="lane_height"):
        japollo.ApolloLaneMetric(j).update(jpreds)
