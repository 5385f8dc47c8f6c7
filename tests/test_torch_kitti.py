"""Port parity of the LiDAR-KITTI host layer against the JAX package, both
sides numpy: the box geometry (BBoxes3D and its functions), the point and
box transforms under a seeded generator, the KITTI dataset on fixture files
made here (the PNG size included), the KITTI evaluator and metric, and the
synthetic datasets and metrics. Every comparison is exact (assert_array_equal
or ==): the port runs the JAX package's numpy code in the same order.

A JAX transform draws from numpy's global state: it runs after
`np.random.seed(s)`; the port's draws from the sample's generator,
`sample.rng = np.random.RandomState(s)`. The JAX `BBoxes3D.masked_select`
raises (it passes its attributes by position); the tests that reach it
(FilterBBoxOutsideRange, the KITTI car pipeline) patch the JAX method with
the keyword form the port uses, and one test pins the JAX failure.
"""
import numpy as np
import pytest
from PIL import Image

from paddle3d_tpu import geometries as jgeo
from paddle3d_tpu import sample as jsample
from paddle3d_tpu.datasets import synthetic as jsyn
from paddle3d_tpu.datasets.kitti import eval as jeval
from paddle3d_tpu.datasets.kitti import kitti_det as jkitti
from paddle3d_tpu.transforms import reader as jreader
from paddle3d_tpu.transforms import transform as jtf
from paddle3d_tpu_torch import geometries as geo
from paddle3d_tpu_torch import sample as psample
from paddle3d_tpu_torch.datasets import synthetic as syn
from paddle3d_tpu_torch.datasets.kitti import eval as keval
from paddle3d_tpu_torch.datasets.kitti import kitti_det, kitti_utils
from paddle3d_tpu_torch.transforms import reader, transform as tf

RANGE = [0, -39.68, -3, 69.12, 39.68, 1]
F, CX, CY = 700.0, 620.0, 190.0
CALIB = "\n".join([
    "P0: {0} 0 {1} 0 0 {0} {2} 0 0 0 1 0".format(F, CX, CY),
    "P1: {0} 0 {1} 0 0 {0} {2} 0 0 0 1 0".format(F, CX, CY),
    "P2: {0} 0 {1} 44.8 0 {0} {2} 0.2 0 0 1 0.003".format(F, CX, CY),
    "P3: {0} 0 {1} -33 0 {0} {2} 2 0 0 1 0.005".format(F, CX, CY),
    "R0_rect: 0.9999 0.0098 -0.0074 -0.0099 0.9999 -0.0043 0.0074 0.0044 "
    "0.9999",
    "Tr_velo_to_cam: 0.0075 -0.9999 -0.0006 -0.0041 0.0148 0.0007 -0.9999 "
    "-0.0763 0.9999 0.0075 0.0148 -0.2718", ""])


def _jax_masked_select(self, mask):
    vel = self.velocities[mask] if self.velocities is not None else None
    return jgeo.BBoxes3D(np.asarray(self)[mask], coordmode=self.coordmode,
                         velocities=vel, origin=self.origin,
                         rot_axis=self.rot_axis)


@pytest.fixture
def repaired(monkeypatch):
    """The JAX BBoxes3D.masked_select in the keyword form."""
    monkeypatch.setattr(jgeo.BBoxes3D, "masked_select", _jax_masked_select)


def test_jax_masked_select_raises_and_the_port_repairs_it():
    """The JAX method hands coordmode, velocities, origin and rot_axis to
    `_Structure.__new__` by position and raises TypeError, so the JAX
    FilterBBoxOutsideRange (in the KITTI car config's train pipeline)
    fails on any sample with boxes; the port's keeps the selected rows and
    the attributes."""
    _, boxes, _, _ = scene(0)
    mask = np.array([True, False, True, True, False])
    with pytest.raises(TypeError, match="positional"):
        jgeo.BBoxes3D(boxes, origin=[.5, .5, 0.]).masked_select(mask)
    b = geo.BBoxes3D(boxes, origin=[.5, .5, 0.], coordmode=1,
                     velocities=np.arange(10.).reshape(5, 2))
    got = b.masked_select(mask)
    np.testing.assert_array_equal(np.asarray(got), boxes[mask])
    np.testing.assert_array_equal(got.velocities, [[0, 1], [4, 5], [6, 7]])
    assert (got.origin, got.coordmode, got.rot_axis) == ([.5, .5, 0.], 1, 2)


def scene(seed, n=2000, boxes=5):
    """Points over the KITTI car range and non-overlapping car boxes
    (bottom z), labels and difficulties."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-2, -42, -4, 0], [72, 42, 2, 1], (n, 4))
    xs = rng.permutation(6)[:boxes] * 11.0 + 4.0
    b = np.stack([xs, rng.uniform(-30, 30, boxes), np.full(boxes, -1.7),
                  np.full(boxes, 1.6), np.full(boxes, 3.9),
                  np.full(boxes, 1.56), rng.uniform(-np.pi, np.pi, boxes)],
                 axis=1)
    b[0, 1] = 41.0                          # one box outside the range
    pts[:200, :2] = b[rng.integers(0, boxes, 200), :2] + rng.normal(
        0, 0.5, (200, 2))                   # points on the boxes
    labels = rng.integers(0, 3, boxes).astype(np.int32)
    return (pts.astype(np.float32), b.astype(np.float32), labels,
            rng.integers(-1, 3, boxes).astype(np.int32))


def both_samples(seed, **kw):
    """The same scene as a JAX Sample and a port Sample."""
    pts, boxes, labels, diff = scene(seed, **kw)
    out = []
    for S, G in ((jsample.Sample, jgeo), (psample.Sample, geo)):
        s = S(path=None, modality="lidar")
        s.data = G.PointCloud(pts.copy())
        s.bboxes_3d = G.BBoxes3D(boxes.copy(), origin=[.5, .5, 0.])
        s.labels = labels.copy()
        s.difficulties = diff.copy()
        out.append(s)
    return out


def assert_samples_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a.data), np.asarray(b.data))
    for k in ("bboxes_3d", "labels", "difficulties"):
        assert (k in a) == (k in b), k
        if k in a:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]))


TRANSFORMS = [
    ("GlobalRotate", dict(min_rot=-0.78539816, max_rot=0.78539816)),
    ("GlobalScale", dict(min_scale=0.95, max_scale=1.05)),
    ("GlobalTranslate", dict(translation_std=[0.2, 0.2, 0.2])),
    ("GlobalTranslate", dict(translation_std=[0.5, 0.5, 0.1],
                             distribution="uniform")),
    ("GlobalRotScaleTrans", dict(translation_std=[0.2, 0.2, 0.2])),
    ("RandomFlip3D", dict(flip_ratio_bev_horizontal=0.5,
                          flip_ratio_bev_vertical=0.5)),
    ("RandomVerticalFlip", {}),
    ("RandomHorizontalFlip", {}),
    ("FilterBBoxOutsideRange", dict(point_cloud_range=RANGE)),
    ("FilterPointOutsideRange", dict(point_cloud_range=RANGE)),
    ("SamplePoint", dict(num_points=500)),
    ("SamplePoint", dict(num_points=5000)),
    ("RandomObjectPerturb", dict(translation_std=[2.0, 2.0, 0.5])),
    ("SamplePointByVoxels", dict(num_points=300, voxel_size=[0.5, 0.5, 0.5],
                                 point_cloud_range=RANGE)),
    ("SamplePointByVoxels", dict(num_points=4000, voxel_size=[0.5, 0.5, 1],
                                 point_cloud_range=RANGE)),
]


@pytest.mark.parametrize("name,kw", TRANSFORMS,
                         ids=["{}-{}".format(n, i)
                              for i, (n, _) in enumerate(TRANSFORMS)])
def test_transform_matches_jax_under_a_seed(name, kw, repaired):
    """Four seeds (both flip branches): the port's transform with
    sample.rng = RandomState(s) gives the JAX transform's arrays after
    np.random.seed(s), exactly."""
    for s in range(4):
        js, ps = both_samples(s)
        np.random.seed(s)
        js = getattr(jtf, name)(**kw)(js)
        ps.rng = np.random.RandomState(s)
        ps = getattr(tf, name)(**kw)(ps)
        assert_samples_equal(js, ps)


def test_shuffle_point_draws_from_the_sample_generator():
    """The JAX ShufflePoint draws from an unseeded default_rng(); the port's
    permutes by the sample's generator: the rows of the JAX output, in
    RandomState(s).permutation order. A transform without a generator
    raises."""
    js, ps = both_samples(0)
    rows = np.asarray(ps.data).copy()
    jout = np.asarray(jtf.ShufflePoint()(js).data)
    ps.rng = np.random.RandomState(3)
    out = np.asarray(tf.ShufflePoint()(ps).data)
    np.testing.assert_array_equal(
        out, rows[np.random.RandomState(3).permutation(len(rows))])
    key = lambda a: a[np.lexsort(a.T[::-1])]   # noqa: E731
    np.testing.assert_array_equal(key(out), key(jout))
    _, bare = both_samples(0)
    with pytest.raises(ValueError, match="sample.rng"):
        tf.GlobalRotate()(bare)


def test_load_point_cloud_and_camera_filter_match_jax(tmp_path):
    """LoadPointCloud with use_dim, time lag and three sweeps (their order
    drawn, ego-close returns dropped, moved by ref_from_curr) and the two
    camera-frustum filters."""
    rng = np.random.default_rng(1)
    paths = []
    for i in range(4):
        p = tmp_path / "{}.bin".format(i)
        rng.uniform(-3, 40, (300 + 10 * i, 5)).astype(np.float32).tofile(p)
        paths.append(str(p))
    ref = np.eye(4)
    ref[:3, 3] = [0.5, -0.2, 0.1]
    outs = []
    for S, R, seed in ((jsample.Sample, jreader, None),
                       (psample.Sample, reader, 5)):
        s = S(path=paths[0], modality="lidar")
        for k, p in enumerate(paths[1:]):
            sweep = S(path=p, modality="lidar")
            sweep.meta.time_lag = 0.05 * (k + 1)
            sweep.meta.ref_from_curr = ref if k != 1 else None
            s.sweeps.append(sweep)
        if seed is None:
            np.random.seed(5)
        else:
            s.rng = np.random.RandomState(seed)
        s = R.LoadPointCloud(dim=5, use_dim=4, use_time_lag=True)(s)
        mats = kitti_utils.Calibration.from_file(_calib(tmp_path))
        s.calibs = mats.as_matrices()
        s.meta.image_shape = (375, 1242)
        a = np.asarray(R.RemoveCameraInvisiblePointsKITTI()(s).data)
        s.meta.image_shape = None
        b = np.asarray(R.RemoveCameraInvisiblePointsKITTIV2()(s).data)
        outs.append((a, b))
    for j, p in zip(*outs):
        np.testing.assert_array_equal(j, p)
    assert 0 < len(outs[1][1]) < 300 + 310 + 320 + 330


def _calib(tmp_path):
    p = tmp_path / "calib.txt"
    p.write_text(CALIB)
    return str(p)


# ------------------------------------------------------------------ geometry
def test_box_geometry_matches_jax(repaired):
    """BBoxes3D's corners and in-place ops, the rotations, the polygon and
    in-box tests, the collision test, circle NMS, SECOND coding and the
    camera / lidar conversions, on the same arrays."""
    pts, boxes, _, _ = scene(2)
    out = []
    for G in (jgeo, geo):
        b = G.BBoxes3D(boxes.copy(), origin=[.5, .5, 0.],
                       velocities=np.ones((len(boxes), 2), np.float32))
        r = {"c3": b.corners_3d, "c2": b.corners_2d,
             "out": b.get_mask_of_bboxes_outside_range(np.asarray(RANGE)),
             "pin": b.get_mask_of_points_outside_range(pts)}
        b.rotate_around_z(0.3)
        b.scale(1.02)
        b.translate(np.array([0.1, -0.2, 0.05], np.float32))
        b.horizontal_flip()
        b.vertical_flip()
        r["ops"] = np.asarray(b)
        r["vel"] = np.asarray(b.velocities)
        r["sel"] = np.asarray(b.masked_select(r["out"]))
        bev = boxes[:, [0, 1, 3, 4, 6]]
        r["rot"] = G.rotation_3d_in_axis(b.corners_3d, boxes[:, 6], axis=1)
        r["pib"] = G.points_in_rbbox_bev(pts, boxes, origin=(.5, .5, 0.))
        r["coll"] = G.box_collision_test(bev, bev + 0.8)
        r["cnms"] = G.circle_nms(np.c_[pts[:50, :2], np.sort(pts[:50, 3])[::-1]],
                                 2.0, post_max_size=20)
        r["enc"] = G.second_box_encode(boxes[1:], boxes[:-1] + 0.1, True)
        r["dec"] = G.second_box_decode(r["enc"], boxes[:-1] + 0.1, True)
        r["near"] = G.rbbox2d_to_near_bbox(bev)
        v2c = np.array(CALIB.split("Tr_velo_to_cam: ")[1].split(),
                       np.float32).reshape(3, 4)
        v2c = np.vstack([v2c, [0, 0, 0, 1]]).astype(np.float32)
        r0 = np.eye(4, dtype=np.float32)
        cam = G.boxes3d_lidar_to_kitti_camera(boxes, v2c, r0)
        r["cam"], r["lid"] = cam, G.boxes3d_kitti_camera_to_lidar(cam, v2c,
                                                                  r0)
        out.append(r)
    assert out[1]["coll"].any() and out[1]["pib"].any()
    for k in out[0]:
        np.testing.assert_array_equal(out[1][k], out[0][k], err_msg=k)


def _iou_cases():
    rng = np.random.default_rng(4)
    a = np.c_[rng.uniform(0, 10, (12, 2)), rng.uniform(0.5, 4, (12, 2)),
              rng.uniform(-np.pi, np.pi, 12)].astype(np.float32)
    b = np.c_[a[:, :2] + rng.normal(0, 1, (12, 2)), a[:, 2:4],
              a[:, 4] + rng.normal(0, .5, 12)].astype(np.float32)
    same = np.array([[1, 1, 2, 4, 0.3]], np.float32)
    degenerate = np.array([[1, 1, 2, 4, 0.3], [1, 1, 0, 4, 0.],
                           [3, 1, 2, 4, 0.], [1, 1, 2, 4, np.pi / 2],
                           [50, 50, 1, 1, 0.]], np.float32)
    return [(a, b), (same, degenerate), (degenerate, degenerate),
            (a, np.zeros((0, 5), np.float32))]


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("criterion", [-1, 0, 1])
def test_rotated_iou_2d_matches_jax(case, criterion):
    """Random pairs, a box against itself and degenerate boxes (zero
    width, touching edges, a quarter turn, far apart), an empty set."""
    a, b = _iou_cases()[case]
    np.testing.assert_array_equal(
        geo.rotated_iou_2d(a, b, criterion),
        jgeo.bbox.rotated_iou_2d(a, b, criterion))


# ---------------------------------------------------------------- evaluator
def _annos(seed, n_frames=5, dets=True):
    """Camera-frame annotations: Car / Van / Pedestrian / DontCare rows of
    every difficulty, and detections that are jittered copies plus false
    positives, some scores tied; frame 2 without objects, frame 3 without
    detections."""
    rng = np.random.default_rng(seed)
    gts, dts = [], []
    names = np.array(["Car", "Van", "Pedestrian", "DontCare"])
    for f in range(n_frames):
        n = 0 if f == 2 else int(rng.integers(2, 7))
        loc = np.c_[rng.uniform(-8, 8, n), rng.uniform(1, 2, n),
                    rng.uniform(5, 40, n)].astype(np.float32)
        dims = np.c_[rng.uniform(1.4, 1.7, n), rng.uniform(1.5, 1.8, n),
                     rng.uniform(3.5, 4.5, n)].astype(np.float32)
        top = rng.uniform(100, 200, n)
        bbox = np.c_[rng.uniform(0, 900, n), top, rng.uniform(950, 1200, n),
                     top + rng.choice([20., 30., 45., 80.], n)]
        gt = {"name": names[rng.integers(0, 4, n)],
              "truncated": rng.choice([0., 0.2, 0.4, 0.6], n).astype(
                  np.float32),
              "occluded": rng.integers(0, 3, n).astype(np.float32),
              "alpha": rng.uniform(-3, 3, n).astype(np.float32),
              "bbox": bbox.astype(np.float32), "dimensions": dims,
              "location": loc,
              "rotation_y": rng.uniform(-3, 3, n).astype(np.float32)}
        gts.append(gt)
        keep = rng.random(n) < 0.8
        m = 0 if f == 3 or not dets else int(keep.sum()) + 2
        jit = lambda x, s: (x + rng.normal(0, s, x.shape)).astype(  # noqa
            np.float32)
        dt = {"name": np.concatenate([gt["name"][keep], ["Car", "Car"]])[:m],
              "bbox": jit(np.concatenate([bbox[keep], bbox[:2] if n >= 2 else
                                          np.tile(bbox[:1], (2, 1)) if n
                                          else np.full((2, 4), 150.)]), 3)[:m],
              "dimensions": jit(np.concatenate(
                  [dims[keep], np.full((2, 3), 1.6, np.float32)]), .05)[:m],
              "location": jit(np.concatenate(
                  [loc[keep], np.array([[0, 1.5, 20], [3, 1.5, 30]],
                                       np.float32)]), .2)[:m],
              "rotation_y": jit(np.concatenate(
                  [gt["rotation_y"][keep], [0., 1.]]), .1)[:m],
              "alpha": jit(np.concatenate([gt["alpha"][keep], [0., 1.]]),
                           .1)[:m],
              "score": np.round(rng.uniform(0, 1, m), 1).astype(np.float32)}
        dt["truncated"] = np.zeros(m, np.float32)
        dt["occluded"] = np.zeros(m, np.float32)
        dts.append(dt)
    return gts, dts


@pytest.mark.parametrize("seed", [0, 1])
def test_kitti_eval_matches_jax(seed):
    """kitti_eval's AP11 / AP40 for Car and Pedestrian over bbox (with
    AOS), BEV and 3-D, and eval_class's precision / recall / aos arrays,
    equal to the JAX evaluator's on the same annotations."""
    gts, dts = _annos(seed)
    kw = dict(classes=["Car", "Pedestrian"], compute_aos=True)
    assert keval.kitti_eval(gts, dts, **kw) == jeval.kitti_eval(gts, dts,
                                                                  **kw)
    for metric in (0, 1, 2):
        for got, want in zip(
                keval.eval_class(gts, dts, "Car", 1, metric, 0.7, True),
                jeval.eval_class(gts, dts, "Car", 1, metric, 0.7, True)):
            np.testing.assert_array_equal(got, want)


def test_kitti_eval_degenerate_annotations_match_jax():
    """No detections anywhere, no ground truth anywhere, and one frame of
    a detection identical to its ground truth."""
    gts, _ = _annos(3, n_frames=3)
    _, dts = _annos(3, n_frames=3, dets=False)
    empty = [{k: v[:0] for k, v in g.items()} for g in gts]
    for g, d in ((gts, dts), (empty, dts), (gts, [dict(g, score=np.ones(
            len(g["name"]), np.float32)) for g in gts])):
        assert keval.kitti_eval(g, d, ["Car"]) == jeval.kitti_eval(g, d,
                                                                   ["Car"])


# ------------------------------------------------------------------ dataset
@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """Six frames: velodyne scans, calibs, labels (eight easy cars, a
    pedestrian, an occluded car, DontCare) and PNG images of five sizes;
    frame 5 has no image."""
    root = tmp_path_factory.mktemp("kitti")
    (root / "ImageSets").mkdir()
    for sub in ("velodyne", "label_2", "calib", "image_2"):
        (root / "training" / sub).mkdir(parents=True)
    ids = ["%06d" % i for i in range(6)]
    for split in ("train", "val"):
        (root / "ImageSets" / (split + ".txt")).write_text("\n".join(ids))
    rng = np.random.default_rng(0)
    for i, idx in enumerate(ids):
        (root / "training" / "calib" / (idx + ".txt")).write_text(CALIB)
        rows = [("Car", 0, 60., -17.5 + 5 * k + 0.1 * i, 10. + k,
                 0.3 * k - 1) for k in range(8)]
        rows += [("Pedestrian", 0, 50., 3., 30. + i, -1.),
                 ("Car", 2, 30., 4., 40., 1.2),
                 ("DontCare", 0, 10., -10., 50., -10.)]
        lines = [kitti_utils.format_label_line(
            n, 0.0, occ, 0.1, (500., 150., 600., 150. + h), (1.5, 1.6, 3.9),
            (x, 1.6, z), ry) for n, occ, h, x, z, ry in rows]
        (root / "training" / "label_2" / (idx + ".txt")).write_text(
            "\n".join(lines) + "\n")
        rng.uniform([0, -30, -3, 0], [60, 30, 1, 1], (3000, 4)).astype(
            np.float32).tofile(root / "training" / "velodyne" / (idx + ".bin"))
        if i < 5:
            Image.new("RGB", (1242 - 2 * i, 375 - i)).save(
                root / "training" / "image_2" / (idx + ".png"))
    return str(root)


def _car_transforms(T, R, shuffle=False):
    ts = [R.LoadPointCloud(dim=4, use_dim=4), T.RandomVerticalFlip(),
          T.GlobalRotate(min_rot=-0.78539816, max_rot=0.78539816),
          T.GlobalScale(min_scale=0.95, max_scale=1.05),
          T.GlobalTranslate(translation_std=[0.2, 0.2, 0.2]),
          T.FilterBBoxOutsideRange(point_cloud_range=RANGE)]
    return ts + [T.ShufflePoint()] if shuffle else ts


def test_kitti_dataset_matches_jax(kitti_root, repaired):
    """KittiPCDataset with the KITTI car config's train transforms (less
    the unseeded JAX ShufflePoint): points, boxes, labels, difficulties,
    calibs, ids and the image size read from the PNG header equal the JAX
    dataset's (Pillow); a missing image gives None; the collated batches
    are equal."""
    jds = jkitti.KittiPCDataset(kitti_root, class_names=["Car", "Pedestrian"],
                                transforms=_car_transforms(jtf, jreader))
    pds = kitti_det.KittiPCDataset(
        kitti_root, class_names=["Car", "Pedestrian"],
        transforms=_car_transforms(tf, reader))
    assert len(pds) == len(jds) == 6
    js_all, ps_all = [], []
    for i in range(6):
        np.random.seed(i)
        js = jds[i]
        ps = pds.get(i, np.random.RandomState(i))
        assert_samples_equal(js, ps)
        assert ps.meta.image_shape == js.meta.image_shape
        assert ps.meta.id == js.meta.id
        for a, b in zip(ps.calibs, js.calibs):
            np.testing.assert_array_equal(a, b)
        js_all.append(js)
        ps_all.append(ps)
    assert ps_all[1].meta.image_shape == (374, 1240)
    assert ps_all[5].meta.image_shape is None
    (jb, jm), (pb, pm) = jds.collate_fn(js_all), pds.collate_fn(ps_all)
    for k in jb:
        np.testing.assert_array_equal(pb[k], jb[k])
    assert [m["id"] for m in pm] == [m["id"] for m in jm]
    with pytest.raises(ValueError, match="not a PNG"):
        kitti_det.png_size(kitti_root + "/training/calib/000000.txt")


def test_kitti_shuffle_is_a_permutation_and_ds_index_is_seeded(kitti_root):
    """With ShufflePoint the sample holds the same rows; ds[i] is
    ds.get(i) under sample_rng(0, 0, i)."""
    pds = kitti_det.KittiPCDataset(
        kitti_root, class_names=["Car"],
        transforms=_car_transforms(tf, reader, shuffle=True))
    a = np.asarray(pds[2].data)
    b = np.asarray(pds.get(2, np.random.RandomState([0, 0, 2])).data)
    np.testing.assert_array_equal(a, b)
    plain = kitti_det.KittiPCDataset(
        kitti_root, class_names=["Car"],
        transforms=_car_transforms(tf, reader))
    c = np.asarray(plain.get(2, np.random.RandomState([0, 0, 2])).data)
    key = lambda x: x[np.lexsort(x.T[::-1])]   # noqa: E731
    np.testing.assert_array_equal(key(a), key(c))


def test_kitti_metric_matches_jax_and_gt_round_trip_scores_100(kitti_root):
    """The val ground truths (48 easy cars: the 41-point recall sampling
    needs 40 for a full curve) given back as predictions with score 1 score
    100 AP on Car 3-D and BEV at every difficulty; jittered predictions
    score the JAX metric's numbers exactly."""
    from paddle3d_tpu.transforms import LoadPointCloud as JLoad
    jds = jkitti.KittiPCDataset(kitti_root, class_names=["Car"],
                                transforms=[JLoad(dim=4, use_dim=4)],
                                mode="val")
    pds = kitti_det.KittiPCDataset(
        kitti_root, class_names=["Car"],
        transforms=[reader.LoadPointCloud(dim=4, use_dim=4)], mode="val")
    gt_preds = []
    for i in range(len(pds)):
        s = pds[i]
        s.confidences = np.ones(len(s.bboxes_3d), np.float32)
        gt_preds.append(s)
    metric = pds.metric
    metric.update(gt_preds)
    res = metric.compute()
    for m in ("3d", "bev"):
        for d in ("easy", "moderate", "hard"):
            assert res["Car {} {} AP_R40".format(m, d)] == 100.0
    rng = np.random.default_rng(0)
    scores = []
    for D, G in ((jds, jgeo), (pds, geo)):
        metric, preds = D.metric, []
        for i in range(len(D)):
            s = D[i]
            b = np.asarray(s.bboxes_3d) + rng.normal(0, 0.15, (len(
                s.bboxes_3d), 7)).astype(np.float32)
            s.bboxes_3d = G.BBoxes3D(b, origin=[.5, .5, 0.])
            s.confidences = rng.uniform(0, 1, len(b)).astype(np.float32)
            preds.append(s)
        metric.update(preds)
        scores.append(metric.compute())
        rng = np.random.default_rng(0)
    assert scores[0] == scores[1]
    assert 0 < scores[1]["Car 3d easy AP_R40"] < 100


# ---------------------------------------------------------------- synthetic
@pytest.mark.parametrize("kw", [
    dict(num_samples=4, num_points=1024, max_boxes=4,
         point_cloud_range=(0., -16., -2., 32., 16., 2.)),
    dict(num_samples=4, seed=7, point_dim=5, with_velocity=True,
         class_sizes=((1.6, 3.9, 1.56), (0.6, 0.8, 1.7)))])
def test_synthetic_dataset_matches_jax(kw):
    """Scenes array for array, the collated batches, and SyntheticMetric on
    predictions near the boxes."""
    jds, pds = jsyn.SyntheticDataset(**kw), syn.SyntheticDataset(**kw)
    js = [jds[i] for i in range(4)]
    ps = [pds[i] for i in range(4)]
    for a, b in zip(js, ps):
        assert_samples_equal(a, b)
        assert a.meta.id == b.meta.id and a.path == b.path
    (jb, _), (pb, _) = jds.collate_fn(js), pds.collate_fn(ps)
    for k in jb:
        np.testing.assert_array_equal(pb[k], jb[k])
    res = []
    for D, G, S in ((jds, jgeo, jsample.Sample), (pds, geo, psample.Sample)):
        metric = D.metric
        preds = []
        for i in range(4):
            p = S(path=None, modality="lidar")
            p.meta.id = i
            b = np.asarray(D[i].bboxes_3d)[:, :7] + 1.5 * (i % 2)
            p.bboxes_3d = G.BBoxes3D(b) if i != 3 else None
            preds.append(p)
        metric.update(preds)
        res.append(metric.compute())
    assert res[0] == res[1]


def test_synthetic_range_and_cls_datasets_match_jax():
    """SyntheticRangeDataset and SyntheticClsDataset array for array, their
    batches, and their metrics on the same predictions."""
    for J, P, MJ, MP in ((jsyn.SyntheticRangeDataset,
                          syn.SyntheticRangeDataset, None, None),
                         (jsyn.SyntheticClsDataset, syn.SyntheticClsDataset,
                          None, None)):
        jds, pds = J(num_samples=3, seed=2), P(num_samples=3, seed=2)
        js = [jds[i] for i in range(3)]
        ps = [pds[i] for i in range(3)]
        (jb, jm), (pb, pm) = jds.collate_fn(js), pds.collate_fn(ps)
        assert jm == pm
        for k in jb:
            np.testing.assert_array_equal(pb[k], jb[k])
        res = []
        for D, S in ((jds, jsample.Sample), (pds, psample.Sample)):
            metric = D.metric
            preds = []
            for i, s in enumerate(js):
                p = S(path=None, modality="lidar")
                p.meta.id = i
                p.labels = np.asarray(s.labels) * (i % 2)
                preds.append(p)
            metric.update(preds)
            res.append(metric.compute())
        assert res[0] == res[1]
