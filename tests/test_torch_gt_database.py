"""Port parity of the GT-paste database against the JAX package: the
database tool (`paddle3d_tpu_torch.tools.create_det_gt_database` against
`tools/create_det_gt_database.py`) and the SamplingDatabase transform, on
small KITTI trees of chip_smoke.kitti_tree (cars, pedestrians and
cyclists). Both sides are numpy; every comparison is exact (bytes, ==,
assert_array_equal) unless it says otherwise.

Also pinned here: two reference faults the port does not copy (the JAX
tool cannot build a database for the repo's configs; its paths do not meet
the configs'; the third, the JAX transform dropping velocities, is in
tests/test_torch_nuscenes.py), the sampler's
draws (the sample's own generator: the loader's batches do not depend on
its thread count), what Voxel-RCNN's config does with a database built
from PV-RCNN's, and every KITTI LiDAR config of configs/ building and
collating a train batch through the port's Config.
"""
import argparse
import filecmp
import importlib.util
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from paddle3d_tpu.apis.config import Config as JaxConfig
from paddle3d_tpu.transforms import sampling as jsampling
from paddle3d_tpu_torch.apis import Config, DataLoader, make_train_step
from paddle3d_tpu_torch.geometries import points_in_rbbox_bev
from paddle3d_tpu_torch.tools import create_det_gt_database as ptool
from paddle3d_tpu_torch.transforms import sample_rng
from paddle3d_tpu_torch.transforms import sampling as psampling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ("Car", "Pedestrian", "Cyclist")
PV_RCNN = os.path.join(REPO, "configs", "pv_rcnn",
                       "pv_rcnn_005voxel_kitti.yml")
VOXEL_RCNN = os.path.join(REPO, "configs", "voxel_rcnn",
                          "voxel_rcnn_005voxel_kitti_car.yml")
# every KITTI LiDAR config of configs/
KITTI_CONFIGS = [
    "pointpillars/pointpillars_xyres16_kitti_car.yml",
    "pointpillars/pointpillars_xyres16_kitti_cyclist_pedestrian.yml",
    "centerpoint/centerpoint_pillars_016voxel_kitti.yml",
    "centerpoint/centerpoint_voxels_008voxel_kitti.yml",
    "pv_rcnn/pv_rcnn_005voxel_kitti.yml",
    "voxel_rcnn/voxel_rcnn_005voxel_kitti_car.yml",
    "iassd/iassd_kitti.yml"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small numpy-bound work beside the suite's other workers: torch's
    intra-op threads only add fork-and-join time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tree(tmp_path):
    """A KITTI tree of 6 train and 2 val frames of 2,000 points with cars,
    pedestrians and cyclists."""
    root = str(tmp_path / "KITTI")
    chip_smoke.kitti_tree(root, train=6, val=2, points=2000, classes=CLASSES)
    return root


def jax_tool():
    """tools/create_det_gt_database.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_gt_tool",
        os.path.join(REPO, "tools", "create_det_gt_database.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config_yml(path, root, tmp, **train):
    """The config at path pointed at root (chip_smoke.lidar_dic), its train
    dataset's keys updated by `train`, written as a YAML under tmp."""
    dic = chip_smoke.lidar_dic(path, root)
    dic["train_dataset"].update(train)
    os.makedirs(str(tmp), exist_ok=True)
    name = os.path.basename(path).replace(".yml", "_tree.yml")
    return dic, chip_smoke.write_yaml(dic, os.path.join(str(tmp), name))


def db_entry(dic):
    return [t for t in dic["train_dataset"]["transforms"]
            if t["type"] == "SamplingDatabase"][0]


def load_only(dic):
    """The train pipeline up to its SamplingDatabase."""
    return ptool.loading_config(dic)[0]["transforms"]


def same_tree(a, b):
    """Two directories hold the same file names with the same bytes."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors


# ------------------------------------------------------------- the tool
def test_port_tool_matches_jax_tool(tree, tmp_path):
    """On PV-RCNN's train dataset with LoadPointCloud alone (the JAX tool
    builds the whole pipeline): under --save_dir the port tool writes the
    JAX tool's bins byte for byte and its pickle entry for entry. By
    default (the config's own paths) the bins are the same bytes and the
    entries equal apart from lidar_file, which is relative to the config's
    database_root and resolves there."""
    dic, yml = config_yml(PV_RCNN, tree, tmp_path)
    _, flat = config_yml(PV_RCNN, tree, tmp_path / "flat",
                         transforms=load_only(dic))
    jdir, pdir = str(tmp_path / "jax_db"), str(tmp_path / "port_db")
    jax_tool().main(argparse.Namespace(cfg=flat, save_dir=jdir,
                                       mode="train"))
    ptool.main(ptool.parse_args(["--config", flat, "--save_dir", pdir]))
    same_tree(os.path.join(jdir, "bins"), os.path.join(pdir, "bins"))
    with open(os.path.join(jdir, "anno_info_train.pkl"), "rb") as f:
        want = pickle.load(f)
    with open(os.path.join(pdir, "anno_info_train.pkl"), "rb") as f:
        got = pickle.load(f)
    assert got == want and set(want) == set(CLASSES)
    assert all(len(v) >= 6 for v in want.values())

    entry = db_entry(dic)
    res = subprocess.run(
        [sys.executable, "-m",
         "paddle3d_tpu_torch.tools.create_det_gt_database", "--config", yml], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    with open(entry["database_anno_path"], "rb") as f:
        own = pickle.load(f)
    bins = os.path.join(os.path.dirname(entry["database_anno_path"]), "bins")
    same_tree(os.path.join(jdir, "bins"), bins)
    assert set(own) == set(want)
    for cls in want:
        for a, b in zip(own[cls], want[cls]):
            assert a["lidar_file"] == os.path.relpath(
                os.path.join(bins, os.path.basename(b["lidar_file"])),
                entry["database_root"])
            assert os.path.exists(os.path.join(entry["database_root"],
                                               a["lidar_file"]))
            assert {k: v for k, v in a.items() if k != "lidar_file"} == \
                {k: v for k, v in b.items() if k != "lidar_file"}


def test_jax_tool_cannot_build_the_configs_database(tree, tmp_path):
    """Reference fault 1: the JAX tool builds the config's whole train
    pipeline, whose SamplingDatabase opens the pickle the tool is to write:
    FileNotFoundError on a fresh tree. The port tool builds it from the
    loading transforms and writes it where the config reads it."""
    dic, yml = config_yml(PV_RCNN, tree, tmp_path)
    anno = db_entry(dic)["database_anno_path"]
    with pytest.raises(FileNotFoundError, match="anno_info_train.pkl"):
        jax_tool().main(argparse.Namespace(
            cfg=yml, save_dir=str(tmp_path / "jax_db"), mode="train"))
    assert not os.path.exists(anno)
    assert ptool.main(ptool.parse_args(["--config", yml])) == anno
    assert os.path.exists(anno)


def test_jax_tool_paths_do_not_meet_the_configs(tree, tmp_path):
    """Reference fault 2: the JAX tool writes lidar_file relative to
    --save_dir and names its pickle anno_info_{mode}.pkl; the configs join
    lidar_file to a database_root that is not the pickle's directory. With
    --save_dir at the pickle's directory (the only one whose pickle the
    config finds), the JAX transform built from the config cannot read the
    points; the port's database, built by default, reads them all."""
    dic, yml = config_yml(PV_RCNN, tree, tmp_path)
    entry = db_entry(dic)
    save_dir = os.path.dirname(entry["database_anno_path"])
    assert os.path.basename(entry["database_anno_path"]) == \
        "anno_info_train.pkl"
    assert os.path.normpath(save_dir) != os.path.normpath(
        entry["database_root"])
    _, flat = config_yml(PV_RCNN, tree, tmp_path / "flat",
                         transforms=load_only(dic))
    jax_tool().main(argparse.Namespace(cfg=flat, save_dir=save_dir,
                                       mode="train"))
    kw = {k: v for k, v in entry.items() if k != "type"}
    jdb = jsampling.SamplingDatabase(**kw)
    jds = JaxConfig(path=flat).train_dataset
    np.random.seed(0)
    with pytest.raises(FileNotFoundError):
        jdb(jds[0])
    ptool.main(ptool.parse_args(["--config", yml]))
    pdb = psampling.SamplingDatabase(**kw)
    for annos in (s.annos for s in pdb.samplers.values()):
        for a in annos:
            assert len(pdb._load_points(a)) == a["num_points_in_box"]


# ------------------------------------------------------ the transform
def paired(tree, tmp_path):
    """The JAX and the port datasets on PV-RCNN's loading transforms, and
    both transforms over one database (the port tool's, under
    --save_dir, which equals the JAX tool's)."""
    dic, _ = config_yml(PV_RCNN, tree, tmp_path)
    _, flat = config_yml(PV_RCNN, tree, tmp_path / "flat",
                         transforms=load_only(dic))
    db = str(tmp_path / "db")
    ptool.main(ptool.parse_args(["--config", flat, "--save_dir", db]))
    kw = {k: v for k, v in db_entry(dic).items() if k != "type"}
    kw.update(database_root=db, database_anno_path=os.path.join(
        db, "anno_info_train.pkl"))
    return (JaxConfig(path=flat).train_dataset,
            Config(path=flat, device="cpu").train_dataset,
            jsampling.SamplingDatabase(**kw),
            psampling.SamplingDatabase(**kw))


def test_sampling_database_matches_jax_on_the_same_draws(tree, tmp_path,
                                                         monkeypatch):
    """Both samplers patched to take each class's first n entries: on every
    train frame, the boxes, labels, difficulties and points after the
    paste are equal; the collision test rejected some pastes and kept
    others; the scene's points come first, unchanged."""
    jds, pds, jdb, pdb = paired(tree, tmp_path)
    monkeypatch.setattr(jsampling.Sampler, "sampling",
                        lambda self, num: self.annos[:num])
    monkeypatch.setattr(psampling.Sampler, "sampling",
                        lambda self, num, rng: self.annos[:num])
    pasted = kept = 0
    for i in range(len(pds)):
        js, ps = jds[i], pds[i]
        n0, g0 = len(ps.data), len(ps.labels)
        js, ps = jdb(js), pdb(ps)
        np.testing.assert_array_equal(np.asarray(ps.bboxes_3d),
                                      np.asarray(js.bboxes_3d))
        np.testing.assert_array_equal(ps.labels, js.labels)
        np.testing.assert_array_equal(ps.difficulties, js.difficulties)
        np.testing.assert_array_equal(np.asarray(ps.data),
                                      np.asarray(js.data))
        assert ps.bboxes_3d.origin == js.bboxes_3d.origin
        pasted += len(ps.labels) - g0
        kept += n0
        wanted = sum(max(0, pdb.max_num_samples[c] - int(np.sum(
            ps.labels[:g0] == pdb.class_names.index(c))))
            for c in pdb.samplers)
        assert len(ps.labels) - g0 <= wanted
    assert pasted > 0 and kept > 0
    assert ps.bboxes_3d.velocities is None is js.bboxes_3d.velocities


def test_sampler_draws_from_the_sample_generator(tree, tmp_path):
    """The port's picks are rng.permutation(len)[:n] of the sample's
    generator: a sample's paste depends on (seed, epoch, index) alone, a
    sample without a generator raises; over the train frames
    (chip_smoke.pasted_objects, phase 28's check) pastes of every class
    arrive and each pasted object's points lie in its box (grown by 2 mm:
    the crop stored them relative to the centre, and adding it back
    rounds)."""
    _, pds, _, pdb = paired(tree, tmp_path)
    s = pdb.samplers["Car"]
    rng = np.random.RandomState(3)
    want = [s.annos[i] for i in np.random.RandomState(3).permutation(
        s.length)[:4]]
    assert s.sampling(4, rng) == want
    assert len(s.sampling(s.length + 5, rng)) == s.length
    for i in range(len(pds)):
        a, b = (pdb(pds.get(i, sample_rng(7, 1, i))) for _ in range(2))
        np.testing.assert_array_equal(np.asarray(a.data), np.asarray(b.data))
        np.testing.assert_array_equal(a.labels, b.labels)
    smp = pds.get(0)
    del smp["rng"]
    with pytest.raises(ValueError, match="generator"):
        pdb(smp)
    dic, yml = config_yml(PV_RCNN, tree, tmp_path / "own")
    ptool.main(ptool.parse_args(["--config", yml]))
    pasted = chip_smoke.pasted_objects(dic, len(pds))
    assert all(ok for _, _, ok, _ in pasted)
    assert {k for lab, _, _, _ in pasted for k in lab} == {0, 1, 2}


def test_loader_batches_with_pastes_do_not_depend_on_workers(tree,
                                                             tmp_path):
    """PV-RCNN's whole train pipeline on a database built by the port tool:
    two epochs of batches at 1 and 4 loader threads are equal, pastes
    included, and the second epoch draws anew."""
    dic, yml = config_yml(PV_RCNN, tree, tmp_path)
    ptool.main(ptool.parse_args(["--config", yml]))
    ds = Config(dic={"train_dataset": dic["train_dataset"]},
                device="cpu").train_dataset
    runs = []
    for workers in (1, 4):
        loader = DataLoader(ds, batch_size=2, shuffle=True, seed=5,
                            num_workers=workers)
        runs.append([b for _ in range(2) for b in loader])
    assert len(runs[0]) == 6
    for (b1, m1), (b4, m4) in zip(*runs):
        assert [m["id"] for m in m1] == [m["id"] for m in m4]
        for k in b1:
            np.testing.assert_array_equal(b1[k], b4[k])
    labels = np.concatenate([b["gt_labels"].ravel() for b, _ in runs[0]])
    assert set(labels[labels >= 0].tolist()) == {0, 1, 2}
    assert not np.array_equal(runs[0][0][0]["data"], runs[0][3][0]["data"])


def test_voxel_rcnn_with_pv_rcnns_database(tree, tmp_path):
    """Voxel-RCNN's config keeps PV-RCNN's three-class SamplingDatabase
    (the YAML anchor) over a one-class ("Car") dataset, at the same pickle
    path. Built from its own config, the database holds cars alone and its
    batches only label 0. Built from PV-RCNN's config at that path, its
    pipeline pastes pedestrians and cyclists with labels 1 and 2 into the
    one-class batches, and the port's train step on such a label raises in
    the RPN head's one-hot target (what the port does; recorded in
    ROADMAP.md, section 3)."""
    vdic, vyml = config_yml(VOXEL_RCNN, tree, tmp_path)
    assert vdic["train_dataset"]["class_names"] == ["Car"]
    assert db_entry(vdic)["class_names"] == list(CLASSES)
    anno = ptool.main(ptool.parse_args(["--config", vyml]))
    with open(anno, "rb") as f:
        assert set(pickle.load(f)) == {"Car"}
    vds = Config(dic={"train_dataset": vdic["train_dataset"]},
                 device="cpu").train_dataset
    batch, _ = vds.collate_fn([vds[i] for i in range(len(vds))])
    assert set(batch["gt_labels"][batch["gt_labels"] >= 0].tolist()) == {0}

    pdic, pyml = config_yml(PV_RCNN, tree, tmp_path / "pv")
    assert db_entry(pdic)["database_anno_path"] == anno
    ptool.main(ptool.parse_args(["--config", pyml]))
    vds = Config(dic={"train_dataset": vdic["train_dataset"]},
                 device="cpu").train_dataset
    batch, _ = vds.collate_fn([vds[i] for i in range(len(vds))])
    assert {1, 2} <= set(batch["gt_labels"][batch["gt_labels"] >= 0].tolist())

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_two_stage import RANGE, tiny_overrides
    tiny = tmp_path / "voxel_rcnn_tiny.yml"
    tiny.write_text(yaml.safe_dump(tiny_overrides(VOXEL_RCNN)))
    torch.manual_seed(0)
    cfg = Config(path=str(tiny), device="cpu")
    rng = np.random.default_rng(0)
    lo, hi = RANGE[:3] + [0], RANGE[3:] + [1]
    points = torch.from_numpy(rng.uniform(lo, hi, (1, 3000, 4)).astype(
        np.float32))
    cx, cy = (RANGE[0] + RANGE[3]) / 2, (RANGE[1] + RANGE[4]) / 2
    boxes = torch.tensor([[[cx, cy, -1.7, 1.6, 3.9, 1.56, 0.0],
                           [cx + 3, cy + 3, -1.7, 0.6, 0.8, 1.73, 0.0]]])
    step = make_train_step(lr_scheduler=cfg.lr_scheduler)
    with pytest.raises(RuntimeError, match="smaller than num_classes"):
        step(cfg.model.train(), cfg.optimizer,
             {"data": points, "gt_boxes": boxes,
              "gt_labels": torch.tensor([[0, 1]])})


@pytest.mark.parametrize("path", KITTI_CONFIGS)
def test_kitti_configs_build_and_collate_a_train_batch(path, tree, tmp_path):
    """Every KITTI LiDAR config of configs/ through the port's Config on the
    tree (its SamplingDatabase's database built by the port tool from the
    config itself): both datasets build, of the config's types, and two
    train samples collate to the dataset's fixed shapes."""
    path = os.path.join(REPO, "configs", path)
    dic, yml = config_yml(path, tree, tmp_path)
    types = [t["type"] for t in dic["train_dataset"]["transforms"]]
    if "SamplingDatabase" in types:
        ptool.main(ptool.parse_args(["--config", yml]))
    cfg = Config(path=yml, device="cpu")
    ds, val = cfg.train_dataset, cfg.val_dataset
    assert type(ds).__name__ == dic["train_dataset"]["type"]
    assert (len(ds), len(val)) == (6, 2)
    batch, metas = ds.collate_fn([ds[0], ds[1]])
    assert batch["data"].shape == (2, ds.max_points, ds.point_dim)
    assert batch["gt_boxes"].shape == (2, ds.max_gt_boxes, 7)
    assert (batch["gt_labels"] >= 0).any() and len(metas) == 2
    assert (batch["gt_labels"] < len(ds.class_names)).all()


def test_crop_mask_is_the_full_points_in_box_test():
    """The tool's culled crop against points_in_rbbox_bev over every point
    and box: equal masks on uniform points and on points exactly on the
    boxes' faces (where rounding decides), KITTI's bottom-z origin and the
    centre origin."""
    rng = np.random.default_rng(0)
    boxes = np.c_[rng.uniform(-40, 40, (12, 2)), rng.uniform(-3, 0, 12),
                  rng.uniform(0.4, 6, (12, 3)), rng.uniform(-4, 4, 12)
                  ].astype(np.float32)
    pts = np.concatenate([
        rng.uniform([-50, -50, -4, 0], [50, 50, 4, 1], (20000, 4)),
        chip_smoke.surface_points(rng, boxes, 6000)]).astype(np.float32)
    for origin in ([.5, .5, 0.], [.5, .5, .5]):
        want = points_in_rbbox_bev(pts, boxes, origin=origin)
        got = ptool.crop_mask(pts, boxes, origin)
        np.testing.assert_array_equal(got, want)
        assert want.sum() > 1000
