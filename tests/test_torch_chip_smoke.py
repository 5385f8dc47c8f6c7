"""CPU tests of chip_smoke.py's helpers that phase 11's reproducibility
check rests on: the saved train state restores to the same trajectory every
time, the deterministic mode is scoped to its block, and bit-pattern
equality tells -0 from +0 in f32 and f64; of the work counts that the
table gather's (K5) bound and the rotated-box intersection's (K11) chain
floor rest on; of phase 15's SMOKE batches and the row gather's (K14)
byte count and decode inputs; of the inputs of phases 24-26: the range
batch, the point clouds and the lane rasteriser; and of phase 27's KITTI
tree writer, read back through the port's dataset and metric; and of phase
29's PNG writer and camera tree."""
import numpy as np
import pytest
import torch
import yaml

import chip_smoke


def _trainer(seed=0):
    gen = torch.Generator().manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.ReLU(),
                                torch.nn.Linear(8, 1))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    optimizer = torch.optim.AdamW(model.parameters(), lr=1e-2,
                                  betas=(0.95, 0.99))
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: 1.0 / (1 + step))
    x = torch.randn((32, 6), generator=gen)
    y = torch.randn((32, 1), generator=gen)

    def step():
        optimizer.zero_grad(set_to_none=True)
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        optimizer.step()
        scheduler.step()
        return loss.item()
    return model, optimizer, scheduler, step


def test_saved_state_restores_the_same_trajectory():
    """Three steps, restore, the same three steps: equal losses and
    weights bit for bit, twice over (the optimizer keeps the state tensors
    it is given, so each restore must hand it a copy)."""
    model, optimizer, scheduler, step = _trainer()
    step()                                  # a state with moments in it
    restore = chip_smoke.saved_state(model, optimizer, scheduler)
    runs = []
    for _ in range(3):
        restore()
        losses = [step() for _ in range(3)]
        runs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
    for losses, params in runs[1:]:
        assert [v.hex() for v in losses] == [v.hex() for v in runs[0][0]]
        assert all(chip_smoke.same_bits(a, b)
                   for a, b in zip(params, runs[0][1]))


def test_deterministic_mode_is_scoped():
    """deterministic() turns torch's deterministic mode and deterministic
    cuDNN on inside its block only, and off again after an error."""
    assert not torch.are_deterministic_algorithms_enabled()
    with chip_smoke.deterministic():
        assert torch.are_deterministic_algorithms_enabled()
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
    assert not torch.are_deterministic_algorithms_enabled()
    with pytest.raises(RuntimeError, match="inside"):
        with chip_smoke.deterministic():
            raise RuntimeError("inside")
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_same_bits_tells_signed_zeros_apart(dtype):
    a = torch.tensor([0.0, 1.5, -2.0], dtype=dtype)
    assert chip_smoke.same_bits(a, a.clone())
    assert not chip_smoke.same_bits(a, torch.tensor([-0.0, 1.5, -2.0],
                                                    dtype=dtype))
    assert not chip_smoke.same_bits(a, a.to(torch.float64 if dtype ==
                                            torch.float32 else
                                            torch.float32))


SENT = 2**31 - 1


@pytest.mark.parametrize("split,extra", [(False, False), (True, False),
                                         (True, True)])
def test_gather_work_counts_each_distinct_cell_once(split, extra):
    """K5's bound reads the keys, each distinct in-range cell of a scan once
    (c_main values, one more where g_extra is given) and writes the rows;
    the earlier count read c_main values for every in-range row."""
    keys = torch.tensor([[0, 0, 1, SENT, SENT, SENT],
                         [-1, 3, 3, 3, 5, 7]], dtype=torch.int32)
    cells, c = 6, 65
    c_main = c - 1 if split else c
    g = torch.zeros((2, cells, c_main))
    g_extra = torch.zeros((2, cells, 1)) if extra else None
    nbytes, old, distinct = chip_smoke.gather_work(keys, g, g_extra, cells, c)
    assert distinct == 4                # {0, 1} and {3, 5}; -1, 7, SENT out
    assert nbytes == 4 * (12 + 4 * (c_main + int(extra)) + 12 * c)
    assert old == 4 * (12 + 7 * c_main + 12 * c)


def test_gather_work_counts_a_cell_in_two_scans_twice():
    keys = torch.tensor([[2, 2, 2], [2, 2, SENT]], dtype=torch.int32)
    g = torch.zeros((2, 4, 8))
    assert chip_smoke.gather_work(keys, g, None, 4, 8)[2] == 2


def test_iou_chain_pair_clips_one_pair():
    """K11's chain floor times one pair that passes the guard and has an
    area to clip: the work count sees one pair, clipped."""
    from paddle3d_tpu_torch.ops import iou_clip
    ca, cb = chip_smoke.iou_chain_pair("cpu")
    assert ca.shape == cb.shape == (1, 1, 4, 2)
    nbytes, ops, pairs, clipped = chip_smoke.iou_work(ca, cb)
    assert (pairs, clipped) == (1, 1)
    assert nbytes == 4 * (8 + 8 + 1)
    assert ops == (2 * chip_smoke.IOU_BOX_OPS + chip_smoke.IOU_EDGE_OPS +
                   chip_smoke.IOU_GUARD_OPS + chip_smoke.IOU_CLIP_OPS)
    area = iou_clip.pairwise_intersection_area_plain(ca, cb).item()
    assert 4.0 < area < 8.0             # two 4 x 2 m boxes, 0.3 rad apart


def test_gather_sectors_counts_the_sectors_the_values_lie_in():
    """Channel-major: each needed value of a lone cell lies in a sector of
    its own channel; eight neighbouring cells share one a channel.
    Row-major: a cell's 64 channels fill eight sectors."""
    keys = torch.tensor([[0, 1, 2, 3, 4, 5, 6, 7, 64, SENT]],
                        dtype=torch.int32)
    cm = torch.zeros((1, 64, 128)).transpose(1, 2)      # strides (.., 1, 128)
    rm = torch.zeros((1, 128, 64))
    first = cm.data_ptr() // 4 % 8
    # cells 0-7 span one or two sectors a channel, cell 64 one more
    assert chip_smoke.gather_sectors(keys, cm, 128) == 64 * (
        (1 if first == 0 else 2) + 1)
    if rm.data_ptr() % 32 == 0:
        assert chip_smoke.gather_sectors(keys, rm, 128) == 9 * 8


def test_smoke_serve_batch_follows_bench_camera():
    """NHWC images in [0, 255) and tools/bench_camera.py's target: f =
    721.5 with the principal point at the image centre, down_ratio 4."""
    batch = chip_smoke.smoke_serve_batch("cpu", 2, hw=(96, 128))
    data, target = batch["data"], batch["target"]
    assert tuple(data.shape) == (2, 96, 128, 3)
    assert data.dtype == torch.float32 and 0 <= data.min() and \
        data.max() < 255
    k = target["K"][1].numpy()
    np.testing.assert_array_equal(k, [[721.5, 0, 64], [0, 721.5, 48],
                                      [0, 0, 1]])
    np.testing.assert_allclose(target["K_inv"][1].numpy() @ k, np.eye(3),
                               atol=1e-6)
    assert (target["down_ratio"] == 4).all()
    assert target["image_size"][0].tolist() == [96, 128]


def test_smoke_train_batch_makes_targets_from_the_config():
    """The config's Gt2SmokeTarget (here the tiny config's: 96 x 128, one
    class, max_objs 8) over seeded synthetic objects: collated targets on
    the output map, objects kept in every image, the same batch for the
    same seed."""
    with open(chip_smoke.SMOKE_TINY) as f:
        dic = yaml.safe_load(f)
    one, two = (chip_smoke.smoke_train_batch("cpu", dic, b=2)
                for _ in range(2))
    assert tuple(one["data"].shape) == (2, 96, 128, 3)
    t = one["target"]
    assert tuple(t["hm"].shape) == (2, 24, 32, 1)
    assert tuple(t["proj_p"].shape) == (2, 8, 2)
    kept = t["reg_mask"].bool()
    assert kept.sum(dim=1).min() > 0
    assert (t["proj_p"][kept][:, 0] < 32).all() and \
        (t["proj_p"][kept][:, 1] < 24).all()
    assert (t["hm"].amax(dim=(1, 2, 3)) == 1).all()
    assert all(torch.equal(one["target"][k], two["target"][k]) for k in t)
    assert torch.equal(one["data"], two["data"])


def test_gather_bytes_counts_indices_and_rows():
    """K14 reads each index once and each gathered row once, and writes
    each row once."""
    assert chip_smoke.gather_bytes(8, 50, 10) == 4 * 400 + 2 * 4 * 4000
    assert chip_smoke.gather_bytes(4, 120000, 64) == 4 * 480000 * 129


def test_smoke_decode_inputs_match_the_decode():
    """The regression map as SMOKE's decode hands it to K14 (NCHW, read in
    place: channel stride H*W) and distinct in-range positions a frame."""
    src, idx = chip_smoke.smoke_decode_inputs("cpu", b=2, k=50)
    hw = (384 // 4) * (1280 // 4)
    assert tuple(src.shape) == (2, hw, 10)
    assert src.stride() == (10 * hw, 1, hw)
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (2, 50)
    assert ((idx >= 0) & (idx < hw)).all()
    assert all(row.unique().numel() == 50 for row in idx)


def test_range_batch_projects_and_normalises_the_scans(monkeypatch):
    """Phase 24's batch: range_scans (360-degree clustered sweeps over the
    KITTI range, x in [-69.12, 69.12]) through project_range and the
    configs' NormalizeRangeImage, labels from the 20 train ids, at a
    small image."""
    from paddle3d_tpu_torch.sample import Sample
    from paddle3d_tpu_torch.transforms import (NormalizeRangeImage,
                                               project_range)
    monkeypatch.setattr(chip_smoke, "SSG_POINTS", 3000)
    batch = chip_smoke.range_batch("cpu", 2, hw=(16, 256))
    assert tuple(batch["data"].shape) == (2, 16, 256, 5)
    assert batch["proj_mask"].dtype == torch.bool
    assert batch["proj_labels"].dtype == torch.int64
    mask = batch["proj_mask"]
    assert 0.1 < mask.float().mean() < 1
    assert (batch["data"][~mask] == 0).all()
    labels = batch["proj_labels"][mask]
    assert labels.min() >= 0 and labels.max() < 20
    assert (batch["proj_labels"][~mask] == 0).all()
    rng = np.random.default_rng(chip_smoke.SEED)
    scans = chip_smoke.range_scans(rng, 2)
    assert scans.shape == (2, 3000, 4)
    assert scans[..., 0].min() < -30 and scans[..., 0].max() > 30
    rng.integers(0, 20, 3000)                 # frame 0's labels
    proj = project_range(scans[0, :, :3], scans[0, :, 3], 16, 256)
    s = Sample(None, "lidar")
    s.data, s.proj_mask = proj["data"], proj["proj_mask"]
    np.testing.assert_array_equal(
        batch["data"][0].numpy(),
        NormalizeRangeImage(*chip_smoke.ssg_norm())(s).data)


def test_primitive_clouds_fill_the_unit_sphere():
    """Phase 25's clouds: 1,024 points a cloud, centred, the farthest at
    radius 1, 40 classes, a class's primitive and aspect its own."""
    pts, labels = chip_smoke.primitive_clouds(np.random.default_rng(0), 16)
    assert pts.shape == (16, 1024, 3) and pts.dtype == np.float32
    assert labels.dtype == np.int64 and labels.min() >= 0 and \
        labels.max() < 40
    np.testing.assert_allclose(np.linalg.norm(pts, axis=-1).max(axis=1), 1,
                               rtol=1e-6)
    np.testing.assert_allclose(pts.mean(axis=1), 0, atol=1e-6)
    again, _ = chip_smoke.primitive_clouds(np.random.default_rng(0), 16)
    np.testing.assert_array_equal(pts, again)


def test_lane_targets_rasterise_four_to_eight_lanes():
    """Phase 26's targets on the 100 x 25 grid: 4-8 lanes a frame with
    instance ids 1..8, conf exactly on the lane cells, offsets in [0, 1),
    each lane crossing most of the grid's rows; the identity grid's (u,
    v) = (column, 1 - row) corners."""
    conf, offset, height, inst = chip_smoke.lane_targets(
        np.random.default_rng(1), 6, 100, 25)
    assert conf.shape == inst.shape == (6, 100, 25)
    assert inst.dtype == np.int64 and inst.max() <= 8
    np.testing.assert_array_equal(conf > 0, inst > 0)
    assert ((offset >= 0) & (offset < 1)).all()
    for f in range(6):
        ids = np.unique(inst[f][inst[f] > 0])
        assert 4 <= len(ids) <= 8 and ids[0] == 1
        assert all(len(np.unique(np.nonzero(inst[f] == i)[0])) > 60
                   for i in ids)
    grid = chip_smoke.lane_grid(100, 25)
    assert grid.shape == (100, 25, 2)
    np.testing.assert_array_equal(grid[0, 0], [0, 1])
    np.testing.assert_array_equal(grid[-1, -1], [1, 0])


def test_kitti_tree_reads_back_through_the_port_dataset(tmp_path):
    """Phase 27's KITTI tree: the port's KittiPCDataset reads back every
    frame's boxes (the label_2 lines round-trip through the camera frame:
    1e-4 m and rad), points and splits; the val ground truths handed as
    outputs score 100 AP on Car 3-D and BEV through
    postprocess_to_samples and KittiMetric."""
    import types

    from paddle3d_tpu_torch.datasets import KittiPCDataset
    from paddle3d_tpu_torch.models.base import BaseLidarModel
    from paddle3d_tpu_torch.transforms import LoadPointCloud
    written = chip_smoke.kitti_tree(str(tmp_path), train=3, val=6,
                                    points=4000)
    assert len(written) == 9
    for mode, ids in (("train", range(3)), ("val", range(3, 9))):
        ds = KittiPCDataset(str(tmp_path), class_names=["Car"], mode=mode,
                            transforms=[LoadPointCloud(dim=4, use_dim=4)])
        assert ds.ids == ["{:06d}".format(i) for i in ids]
        for i in range(len(ds)):
            s = ds[i]
            want = written[ds.ids[i]]
            assert 6 <= len(want) <= 10 and s.meta.image_shape is None
            np.testing.assert_allclose(np.asarray(s.bboxes_3d), want,
                                       atol=1e-4)
            assert (s.labels == 0).all() and (s.difficulties == 0).all()
            assert s.data.shape == (4000, 4)
    model = types.SimpleNamespace(
        postprocess_to_samples=BaseLidarModel.postprocess_to_samples)
    ap = chip_smoke.gt_round_trip(model, ds)
    for m in ("3d", "bev"):
        for r in (11, 40):
            assert ap["Car {} easy AP_R{}".format(m, r)] == 100.0


def test_png_bytes_writes_every_filter_type_that_pillow_reads():
    """Phase 29's PNG writer (zlib alone): RGB rows under the five filter
    types in turn, in IDAT chunks of 1,000 bytes, read back by Pillow as
    the array written."""
    import io
    import zlib

    from PIL import Image
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (23, 37, 3), dtype=np.uint8)
    data = chip_smoke.png_bytes(img, chunk=1000)
    assert data.count(b"IDAT") > 1
    np.testing.assert_array_equal(
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), img)
    idat = zlib.decompress(b"".join(
        data[i + 8:i + 8 + int.from_bytes(data[i:i + 4], "big")]
        for i in range(8, len(data) - 12)
        if data[i + 4:i + 8] == b"IDAT"))
    types = np.frombuffer(idat, np.uint8)[::37 * 3 + 1]
    np.testing.assert_array_equal(types, np.arange(23) % 5)


def test_camera_tree_reads_back_through_the_port_datasets(tmp_path):
    """Phase 29's KITTI tree with images: every fourth frame at one of
    CAM_SIZES' other sizes, the rest at 1242 x 375; KittiMonoDataset reads
    each image equal to the array written (sha256) with its camera boxes,
    KittiDepthDataset resizes it to the CADDN config's 384 x 1248 with a
    depth map; the batch hashes cover SMOKE's nested targets; a camera
    model's launches follow its recorded pools."""
    import hashlib

    from paddle3d_tpu_torch.datasets import (KittiDepthDataset,
                                             KittiMonoDataset)
    from paddle3d_tpu_torch.transforms import Gt2SmokeTarget
    hashes = {}
    written = chip_smoke.kitti_tree(str(tmp_path), train=4, val=1,
                                    points=3000, images=True, hashes=hashes,
                                    classes=tuple(chip_smoke.KITTI_SIZES))
    assert sorted(hashes) == sorted(written)
    mono = KittiMonoDataset(str(tmp_path), mode="train")
    for i in range(4):
        s = mono[i]
        assert s.meta.image_shape == chip_smoke.CAM_SIZES[
            1 if i == 3 else 0]
        assert hashlib.sha256(s.data.tobytes()).hexdigest() == \
            hashes[mono.ids[i]]
        assert len(s.labels) == len(written[mono.ids[i]])
    depth = KittiDepthDataset(str(tmp_path), mode="train",
                              image_size=(384, 1248))
    s = depth[3]
    assert s.data.shape == (384, 1248, 3) and s.meta.depth_map.max() > 0
    mono.transforms = Gt2SmokeTarget(mode="train", num_classes=3)
    one, four = (chip_smoke.batch_hashes(mono, 2, w, n=1)
                 for w in (1, 4))
    assert one == four and "target/hm" in one[0]
    assert chip_smoke.camera_launches([(2396160, 105280)]) == (
        {"sorted_segment_sum_dense": 1, "sorted_table_gather": 1},
        {"sorted_segment_sum_dense": 1})
    assert chip_smoke.camera_launches([]) == ({}, {})


def test_pool_launches_and_linked_tree_files(tmp_path):
    """Phase 30's routes: each recorded pool by the density rule (BEVDet4D's
    249,216 rows on 16,384 cells dense, BEVFusion's 30,000 pillars on
    160,000 cells sparse) and a K5 for each pool with a gradient; a repeated
    camera file is a hard link to the first one written."""
    assert chip_smoke.pool_launches([(249216, 16384, True),
                                     (249216, 16384, False)]) == {
        "sorted_segment_sum_dense": 2, "sorted_table_gather": 1}
    assert chip_smoke.pool_launches([(30000, 160000, True),
                                     (344400, 40000, True)]) == {
        "sorted_segment_sum": 1, "sorted_segment_sum_dense": 1,
        "sorted_table_gather": 2}
    assert chip_smoke.pool_launches([]) == {}
    written = {}
    for name in ("a.jpg", "b.jpg"):
        chip_smoke.place_file(str(tmp_path / name), b"\xff\xd8\xff", written)
    chip_smoke.place_file(str(tmp_path / "c.jpg"), b"other", written)
    assert (tmp_path / "a.jpg").samefile(tmp_path / "b.jpg")
    assert (tmp_path / "c.jpg").read_bytes() == b"other"
