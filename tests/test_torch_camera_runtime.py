"""Port parity of the runtime's KITTI camera path against the JAX package
and Pillow, on the CPU: the PNG reader (utils/png.py) and its native
unfilter, the resize (utils/image.py), LoadImage, Gt2SmokeTarget under a
seed, KittiMonoDataset and KittiDepthDataset on a small tree of
Pillow-written PNGs, their metrics, the four camera postprocess_to_samples,
every SMOKE, CADDN and DD3D config's datasets through the port's Config,
and two reference faults (the JAX pad_batch leaves a nested target
unpadded; DD3D's configs collate no gt keys).

Every comparison is exact (array_equal, ==): the port runs the JAX
package's numpy code in its order, and the decoder and the resize are
byte-equal to Pillow 12's. A JAX transform draws from numpy's global state
after `np.random.seed(s)`; the port's from `np.random.RandomState(s)`.
"""
import io
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from paddle3d_tpu.apis.config import Config as JaxConfig
from paddle3d_tpu.apis.trainer import Trainer as JaxTrainer
from paddle3d_tpu.datasets.kitti import kitti_depth_det as jdepth
from paddle3d_tpu.datasets.kitti import kitti_mono_det as jmono
from paddle3d_tpu.models.detection.caddn.caddn import CADDN as JaxCADDN
from paddle3d_tpu.models.detection.dd3d.dd3d import DD3D as JaxDD3D
from paddle3d_tpu.models.detection.petr.petr3d import PETR as JaxPETR
from paddle3d_tpu.models.detection.smoke.smoke import SMOKE as JaxSMOKE
from paddle3d_tpu.transforms import normalize as jnorm
from paddle3d_tpu.transforms import reader as jreader
from paddle3d_tpu.transforms import target_generator as jtg
from paddle3d_tpu_torch.apis import Config, Trainer
from paddle3d_tpu_torch.datasets.kitti import (kitti_depth_det,
                                               kitti_mono_det, kitti_utils)
from paddle3d_tpu_torch.models.detection import CADDN, DD3D, PETR, SMOKE
from paddle3d_tpu_torch.transforms import normalize, reader, \
    target_generator
from paddle3d_tpu_torch.utils import image, png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
MEAN, STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
# the tree's image sizes (h, w), KITTI-like at a fifth of the size, and the
# camera datasets' output sizes here: SMOKE's input_size (w, h), CADDN's
# image_size (h, w)
SIZES = [(75, 248), (74, 245), (76, 249)]
SMOKE_IN = (256, 80)
CADDN_HW = (80, 250)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pillow_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def plain_decode(data: bytes) -> np.ndarray:
    """decode_png with the plain unfilter."""
    hdr, raw = png.inflate(data)
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[hdr["color_type"]]
    return png.to_rgb(png.unfilter_plain(raw, hdr["height"],
                                         hdr["width"] * bpp, bpp),
                      hdr["color_type"])


def textured(rng, shape):
    """A gradient with grain (every filter type has something to do)."""
    h, w = shape[:2]
    base = np.add.outer(np.arange(h) * 3, np.arange(w) * 2)
    base = base.reshape((h, w) + (1,) * (len(shape) - 2))
    return ((base + rng.integers(0, 40, shape)) % 256).astype(np.uint8)


# ---------------------------------------------------------------- PNG
@pytest.mark.parametrize("mode,shape", [("RGB", (37, 53, 3)),
                                        ("RGBA", (20, 31, 4)),
                                        ("L", (15, 17)),
                                        ("LA", (9, 13, 2)),
                                        ("RGB", (75, 248, 3))])
def test_png_matches_pillow_on_files_pillow_writes(mode, shape):
    """Files Pillow writes (its adaptive filter choice, odd widths) read
    byte-equal to `Image.open(p).convert("RGB")`, by the native and the
    plain unfilter."""
    a = textured(np.random.default_rng(len(shape)), shape)
    buf = io.BytesIO()
    Image.fromarray(a, mode).save(buf, "PNG")
    data = buf.getvalue()
    ref = pillow_rgb(data)
    got = png.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(plain_decode(data), ref)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_each_filter_type_and_colour_type(ftype, channels):
    """Hand-written PNGs (chip_smoke.png_bytes, zlib alone) with every row
    under one filter type, of each colour type, 11 pixels wide: read equal
    to Pillow's convert("RGB") and to the array written."""
    a = textured(np.random.default_rng(ftype), (7, 11, channels))
    data = chip_smoke.png_bytes(a, filters=(ftype,), chunk=40)
    ref = pillow_rgb(data)
    got = png.decode_png(data)
    np.testing.assert_array_equal(got, ref)
    want = {1: np.repeat(a, 3, 2), 2: np.repeat(a[..., :1], 3, 2),
            3: a, 4: a[..., :3]}[channels]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bpp,width", [(1, 1), (2, 7), (3, 13), (3, 414),
                                       (4, 5)])
def test_native_unfilter_equals_plain(bpp, width):
    """Random filtered bytes under random filter types: the native unfilter
    and the plain one reconstruct the same rows."""
    rng = np.random.default_rng(width)
    h, stride = 9, width * bpp
    raw = rng.integers(0, 256, (h, stride + 1), dtype=np.uint8)
    raw[:, 0] = rng.integers(0, 5, h)
    raw = raw.tobytes()
    np.testing.assert_array_equal(png.unfilter(raw, h, stride, bpp),
                                  png.unfilter_plain(raw, h, stride, bpp))


def _with_ihdr(data: bytes, **fields) -> bytes:
    """data with IHDR fields replaced (CRC made anew)."""
    hdr = png.png_header(data)
    hdr.update(fields)
    payload = struct.pack(">IIBBBBB", hdr["width"], hdr["height"],
                          hdr["bit_depth"], hdr["color_type"],
                          hdr["compression"], hdr["filter"],
                          hdr["interlace"])
    chunk = (struct.pack(">I", 13) + b"IHDR" + payload +
             struct.pack(">I", zlib.crc32(b"IHDR" + payload)))
    return data[:8] + chunk + data[33:]


def test_unsupported_pngs_raise():
    """16-bit, palette and 1-bit files, Adam7 interlace, a bad filter type,
    a broken CRC and a file that is not a PNG raise ValueError; png_size
    reads the header."""
    rng = np.random.default_rng(0)
    for mode, arr in (("I;16", rng.integers(0, 65535, (5, 6), np.uint16)),
                      ("P", rng.integers(0, 255, (5, 6), np.uint8)),
                      ("1", rng.integers(0, 2, (5, 6)).astype(bool))):
        buf = io.BytesIO()
        Image.fromarray(arr).convert(mode).save(buf, "PNG")
        with pytest.raises(ValueError, match="unsupported PNG"):
            png.decode_png(buf.getvalue())
    good = chip_smoke.png_bytes(textured(rng, (5, 6, 3)))
    with pytest.raises(ValueError, match="Adam7"):
        png.decode_png(_with_ihdr(good, interlace=1))
    raw = bytearray(png.inflate(good)[1])
    raw[19] = 7                             # row 1's filter type
    with pytest.raises(ValueError, match="filter type 7"):
        png.unfilter(bytes(raw), 5, 18, 3)
    with pytest.raises(ValueError, match="filter type 7"):
        png.unfilter_plain(bytes(raw), 5, 18, 3)
    broken = bytearray(good)
    broken[40] ^= 0xFF                      # inside the first IDAT
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(broken))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a" + bytes(40))


# ------------------------------------------------------------- resize
RESIZES = [((375, 1242), (1280, 384)), ((370, 1224), (1248, 384)),
           ((37, 53), (20, 11)), ((37, 53), (101, 70)), ((64, 96), (17, 5)),
           ((5, 7), (300, 2)), ((30, 30), (7, 30))]


@pytest.mark.parametrize("resample", [image.BILINEAR, image.BICUBIC])
@pytest.mark.parametrize("hw,size", RESIZES)
def test_resize_is_byte_equal_to_pillow(hw, size, resample):
    """RGB and grey images scaled up and down, one axis at a time and
    both, and KITTI's 1242 x 375 -> 1280 x 384: byte-equal to Pillow 12's
    Image.resize."""
    pil = {image.BILINEAR: Image.BILINEAR, image.BICUBIC: Image.BICUBIC}
    rng = np.random.default_rng(sum(hw))
    for shape in (hw + (3,), hw):
        a = textured(rng, shape)
        ref = np.asarray(Image.fromarray(a).resize(size, pil[resample]))
        np.testing.assert_array_equal(image.resize(a, size, resample), ref)


def test_resize_default_flip_and_refusals():
    """The default is BICUBIC (Pillow's for RGB); the same size is a copy;
    the flip is Image.FLIP_LEFT_RIGHT; other filters and dtypes raise."""
    a = textured(np.random.default_rng(1), (21, 33, 3))
    ref = np.asarray(Image.fromarray(a).resize((40, 17)))
    np.testing.assert_array_equal(image.resize(a, (40, 17)), ref)
    same = image.resize(a, (33, 21))
    np.testing.assert_array_equal(same, a)
    assert same is not a
    np.testing.assert_array_equal(
        image.flip_left_right(a),
        np.asarray(Image.fromarray(a).transpose(Image.FLIP_LEFT_RIGHT)))
    with pytest.raises(ValueError, match="resample"):
        image.resize(a, (4, 4), "lanczos")
    with pytest.raises(ValueError, match="uint8"):
        image.resize(a.astype(np.float32), (4, 4))


# ----------------------------------------------------------- the tree
@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """chip_smoke's KITTI tree (3 classes), 4 train and 2 val frames of
    2,000 points, its camera scaled to a fifth (P0-P3's first two rows)
    for images of SIZES, rendered by chip_smoke.kitti_image and written by
    Pillow (the label_2 lines keep KITTI's pixel boxes)."""
    root = str(tmp_path_factory.mktemp("kitti_cam"))
    chip_smoke.kitti_tree(root, train=4, val=2, points=2000,
                          classes=tuple(chip_smoke.KITTI_SIZES))
    os.makedirs(os.path.join(root, "training", "image_2"))
    for i in range(6):
        idx = "{:06d}".format(i)
        calib_path = os.path.join(root, "training", "calib", idx + ".txt")
        with open(calib_path) as f:
            lines = f.read().splitlines()
        for j, line in enumerate(lines):
            key, vals = line.split(":")
            if key in ("P0", "P1", "P2", "P3"):
                v = np.array(vals.split(), np.float64)
                v[:8] *= 0.2
                lines[j] = "{}: {}".format(key, " ".join(
                    "{:.6e}".format(x) for x in v))
        with open(calib_path, "w") as f:
            f.write("\n".join(lines) + "\n")
        calib = kitti_utils.Calibration.from_file(calib_path)
        anno = kitti_utils.parse_label_file(
            os.path.join(root, "training", "label_2", idx + ".txt"))
        boxes = kitti_utils.camera_anno_to_lidar_boxes(anno, calib)
        img = chip_smoke.kitti_image(
            np.random.default_rng(i), boxes,
            [chip_smoke.KITTI_CLASSES.index(n) for n in anno["name"]],
            calib, SIZES[i % 3])
        Image.fromarray(img).save(
            os.path.join(root, "training", "image_2", idx + ".png"))
    return root


def smoke_transforms(mod_reader, mod_tg, mod_norm, mode):
    return [mod_reader.LoadImage(reader="pillow", to_chw=False),
            mod_tg.Gt2SmokeTarget(mode=mode, num_classes=3,
                                  input_size=SMOKE_IN),
            mod_norm.Normalize(mean=MEAN, std=STD)]


def assert_mono_equal(js, ps):
    np.testing.assert_array_equal(ps.data, js.data)
    assert ps.data.dtype == js.data.dtype
    for k in ("bboxes_3d", "bboxes_2d", "labels", "difficulties"):
        np.testing.assert_array_equal(np.asarray(ps[k]), np.asarray(js[k]))
    np.testing.assert_array_equal(ps.meta.camera_intrinsic,
                                  js.meta.camera_intrinsic)
    assert ps.meta.image_shape == js.meta.image_shape
    assert ps.meta.id == js.meta.id
    for a, b in zip(ps.calibs, js.calibs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["train", "val"])
def test_kitti_mono_dataset_matches_jax(kitti_root, mode):
    """KittiMonoDataset with SMOKE's pipeline (LoadImage, Gt2SmokeTarget at
    256 x 80 with its flips, Normalize): images, K, boxes, 2-D boxes,
    labels, difficulties, targets and the collated batches equal the JAX
    dataset's under a seed; without transforms the decoded image equals
    Pillow's."""
    names = ["Car", "Cyclist", "Pedestrian"]
    jds = jmono.KittiMonoDataset(kitti_root, class_names=names, mode=mode,
                                 transforms=smoke_transforms(
                                     jreader, jtg, jnorm, mode))
    pds = kitti_mono_det.KittiMonoDataset(
        kitti_root, class_names=names, mode=mode,
        transforms=smoke_transforms(reader, target_generator, normalize,
                                    mode))
    js_all, ps_all = [], []
    for i in range(len(jds)):
        np.random.seed(10 + i)
        js = jds[i]
        ps = pds.get(i, np.random.RandomState(10 + i))
        assert_mono_equal(js, ps)
        assert set(ps.target) == set(js.target)
        for k, v in js.target.items():
            assert ps.target[k].dtype == v.dtype, k
            np.testing.assert_array_equal(ps.target[k], v, k)
        js_all.append(js)
        ps_all.append(ps)
    flips = [int(s.target.get("flip_mask", np.zeros(1)).max())
             for s in ps_all]
    if mode == "train":
        assert 0 < sum(flips) < len(flips)  # both ways under these seeds
    (jb, jm), (pb, pm) = jds.collate_fn(js_all), pds.collate_fn(ps_all)
    np.testing.assert_array_equal(pb["data"], jb["data"])
    for k in jb["target"]:
        np.testing.assert_array_equal(pb["target"][k], jb["target"][k])
    assert pm == jm
    plain = kitti_mono_det.KittiMonoDataset(kitti_root, mode=mode)[0]
    with Image.open(plain.path) as im:
        np.testing.assert_array_equal(plain.data,
                                      np.asarray(im.convert("RGB")))


def test_load_image_readers_match_jax(kitti_root):
    """LoadImage's reader aliases and meta keys: pillow / rgb RGB, cv2 /
    bgr BGR, as the JAX transform sets them."""
    path = os.path.join(kitti_root, "training", "image_2", "000001.png")
    for name in ("pillow", "cv2", "rgb", "bgr"):
        js, ps = (mod.Sample(path=path, modality="image")
                  for mod in (jreader, reader))
        js, ps = jreader.LoadImage(reader=name)(js), \
            reader.LoadImage(reader=name)(ps)
        np.testing.assert_array_equal(ps.data, js.data)
        assert dict(ps.meta) == dict(js.meta)
    with pytest.raises(ValueError, match="unsupported reader"):
        reader.LoadImage(reader="jpeg")


@pytest.mark.parametrize("flip_prob", [0.5, 1.0])
def test_gt2smoke_target_resizes_and_flips_as_jax_under_a_seed(flip_prob):
    """Images of three sizes, none at input_size: the port's flip drawn from
    the sample's generator, its BILINEAR resize and targets equal the JAX
    transform's after np.random.seed; in val mode nothing is drawn."""
    from paddle3d_tpu.sample import Sample as JaxSample
    from paddle3d_tpu_torch.sample import Sample
    boxes = np.array([[-1.0, 1.5, 15.0, 1.5, 1.6, 3.9, 0.3],
                      [2.0, 1.4, 20.0, 1.5, 1.6, 3.9, -0.5],
                      [1.0, 1.5, 30.0, 1.7, 0.6, 0.8, 2.0]], np.float32)
    k = np.array([[140., 0, 120.], [0, 140., 37.], [0, 0, 1]], np.float32)
    for mode in ("train", "val"):
        kw = dict(mode=mode, num_classes=3, flip_prob=flip_prob, max_objs=4,
                  input_size=SMOKE_IN)
        jg, pg = jtg.Gt2SmokeTarget(**kw), target_generator.Gt2SmokeTarget(
            **kw)
        for seed, hw in enumerate(SIZES):
            img = textured(np.random.default_rng(seed), hw + (3,))
            js, ps = JaxSample(None, "image"), Sample(None, "image")
            for s in (js, ps):
                s.data, s.bboxes_3d = img.copy(), boxes.copy()
                s.labels = np.array([0, 1, 2])
                s.meta.camera_intrinsic = k.copy()
            np.random.seed(seed)
            js = jg(js)
            ps.rng = np.random.RandomState(seed)
            ps = pg(ps)
            np.testing.assert_array_equal(ps.data, js.data)
            assert ps.data.shape == (SMOKE_IN[1], SMOKE_IN[0], 3)
            for key, v in js.target.items():
                np.testing.assert_array_equal(ps.target[key], v, key)
            drawn = ps.rng.random_sample() != \
                np.random.RandomState(seed).random_sample()
            assert drawn == (mode == "train")


# -------------------------------------------------------------- depth
def test_kitti_depth_dataset_matches_jax(kitti_root):
    """KittiDepthDataset at 80 x 250 (BICUBIC, Pillow's default): the
    resized image, lidar2img, img2lidar, the depth map, boxes, labels and
    the collated batch equal the JAX dataset's; the depth map keeps the
    closest point of a cell."""
    kw = dict(class_names=["Car", "Cyclist", "Pedestrian"], mode="train",
              image_size=CADDN_HW, depth_downsample_factor=4,
              point_cloud_range=[2.0, -30.08, -3.0, 46.8, 30.08, 1.0])
    jds = jdepth.KittiDepthDataset(kitti_root, **kw)
    pds = kitti_depth_det.KittiDepthDataset(kitti_root, **kw)
    js_all, ps_all = [jds[i] for i in range(4)], [pds[i] for i in range(4)]
    for js, ps in zip(js_all, ps_all):
        np.testing.assert_array_equal(ps.data, js.data)
        assert ps.data.dtype == np.float32
        for key in ("lidar2img", "img2lidar", "depth_map"):
            np.testing.assert_array_equal(ps.meta[key], js.meta[key], key)
        assert ps.meta.image_shape == js.meta.image_shape
        np.testing.assert_array_equal(np.asarray(ps.bboxes_3d),
                                      np.asarray(js.bboxes_3d))
        np.testing.assert_array_equal(ps.labels, js.labels)
        assert (ps.meta.depth_map > 0).sum() > 50
    (jb, jm), (pb, pm) = jds.collate_fn(js_all), pds.collate_fn(ps_all)
    assert set(pb) == set(jb)
    for k in jb:
        np.testing.assert_array_equal(pb[k], jb[k])
    assert pm == jm
    # two points on one ray, the far one first: the closer depth stays
    calib = pds.load_calib(pds.ids[0])
    rect = np.array([[0.5, 0.3, 10.0], [0.6, 0.36, 12.0]], np.float32)
    for order in ((1, 0), (0, 1)):
        pts = np.c_[calib.rect_to_lidar(rect[list(order)]),
                    np.zeros(2)].astype(np.float32)
        d = pds._depth_map(pts, calib, (1.0, 1.0))
        assert (d > 0).sum() == 1
        assert d.max() == calib.rect_to_img(
            calib.lidar_to_rect(pts[order.index(0):][:1, :3]))[1][0]


# ------------------------------------------------------------ metrics
def smoke_outputs(rng, samples, k=6):
    """SMOKE-shaped outputs: each frame's gt boxes (camera frame) jittered,
    then padding; scores and alphas seeded."""
    b = len(samples)
    out = {"box3d_cam": np.zeros((b, k, 7), np.float32),
           "scores": np.full((b, k), -1.0, np.float32),
           "label_preds": np.full((b, k), -1, np.int32),
           "bbox_2d": np.zeros((b, k, 4), np.float32),
           "alphas": np.zeros((b, k), np.float32)}
    for i, s in enumerate(samples):
        n = min(len(s.labels), k - 1)
        out["box3d_cam"][i, :n] = s.bboxes_3d[:n] + rng.normal(
            0, 0.1, (n, 7))
        out["scores"][i, :n] = rng.uniform(0.2, 1.0, n)
        out["label_preds"][i, :n] = s.labels[:n]
        out["bbox_2d"][i, :n] = s.bboxes_2d[:n] + rng.normal(0, 2, (n, 4))
        out["alphas"][i, :n] = rng.uniform(-np.pi, np.pi, n)
    return out


def same_samples(ps_list, js_list, keys):
    assert len(ps_list) == len(js_list)
    for p, j in zip(ps_list, js_list):
        for key in keys:
            np.testing.assert_array_equal(np.asarray(p[key]),
                                          np.asarray(j[key]), key)
        assert getattr(p, "frame", None) == getattr(j, "frame", None)
        assert dict(p.meta) == dict(j.meta)


def test_smoke_postprocess_and_kitti_mono_metric_match_jax(kitti_root):
    """SMOKE.postprocess_to_samples on the same outputs gives the JAX
    samples (camera frame, 2-D boxes, alphas), and KittiMonoDataset's
    metric (bbox, bev, 3d, aos) the JAX metric's AP dict."""
    names = ["Car", "Cyclist", "Pedestrian"]
    jds = jmono.KittiMonoDataset(kitti_root, class_names=names, mode="val")
    pds = kitti_mono_det.KittiMonoDataset(kitti_root, class_names=names,
                                          mode="val")
    samples = [pds[i] for i in range(len(pds))]
    out = smoke_outputs(np.random.default_rng(3), samples)
    metas = [{"path": s.path, "id": s.meta.id} for s in samples]
    ps, js = (SMOKE.postprocess_to_samples(out, metas),
              JaxSMOKE.postprocess_to_samples(out, metas))
    same_samples(ps, js, ("bboxes_3d", "bboxes_2d", "labels",
                          "confidences", "alpha"))
    pm, jm = pds.metric, jds.metric
    pm.update(ps)
    jm.update(js)
    got, ref = pm.compute(), jm.compute()
    assert got == ref
    assert got["Car 3d easy AP_R40"] > 0 and "Car aos easy AP_R40" in got


def test_caddn_postprocess_and_kitti_depth_metric_match_jax(kitti_root):
    """CADDN.postprocess_to_samples (the LiDAR detectors', CenterPoint's in
    the JAX package) on the same lidar-frame outputs gives the JAX samples,
    and KittiDepthMetric the JAX metric's AP dict."""
    kw = dict(class_names=["Car", "Cyclist", "Pedestrian"], mode="val",
              image_size=CADDN_HW)
    jds = jdepth.KittiDepthDataset(kitti_root, **kw)
    pds = kitti_depth_det.KittiDepthDataset(kitti_root, **kw)
    samples = [pds[i] for i in range(len(pds))]
    rng = np.random.default_rng(4)
    b, k = len(samples), 12
    out = {"box3d_lidar": np.zeros((b, k, 7), np.float32),
           "scores": np.full((b, k), -1.0, np.float32),
           "label_preds": np.full((b, k), -1, np.int32)}
    for i, s in enumerate(samples):
        n = min(len(s.labels), k - 1)
        out["box3d_lidar"][i, :n] = np.asarray(s.bboxes_3d)[:n] + \
            rng.normal(0, 0.1, (n, 7))
        out["scores"][i, :n] = rng.uniform(0.2, 1.0, n)
        out["label_preds"][i, :n] = s.labels[:n]
    _, metas = pds.collate_fn(samples)
    ps, js = (CADDN.postprocess_to_samples(out, metas),
              JaxCADDN.postprocess_to_samples(out, metas))
    same_samples(ps, js, ("bboxes_3d", "labels", "confidences", "alpha"))
    pm, jm = pds.metric, jds.metric
    pm.update(ps)
    jm.update(js)
    got = pm.compute()
    assert got == jm.compute() and got["Car bev easy AP_R40"] > 0


def test_dd3d_and_petr_postprocess_match_jax():
    """DD3D's (camera frame) and PETR's (nuScenes lidar boxes with
    velocities and the segmentation map) postprocess_to_samples equal the
    JAX ones on the same outputs, and give no sample for no meta."""
    rng = np.random.default_rng(5)
    metas = [{"path": "a", "id": 3}, {"path": "b", "id": 4}]
    scores = np.where(rng.random((2, 10)) < 0.5, -1.0,
                      rng.random((2, 10))).astype(np.float32)
    dd3d = {"box3d_cam": rng.normal(0, 5, (2, 10, 7)).astype(np.float32),
            "scores": scores,
            "label_preds": rng.integers(0, 3, (2, 10)).astype(np.int32)}
    same_samples(DD3D.postprocess_to_samples(dd3d, metas),
                 JaxDD3D.postprocess_to_samples(dd3d, metas),
                 ("bboxes_3d", "labels", "confidences"))
    assert DD3D.postprocess_to_samples(dd3d, []) == []
    petr = {"box3d_lidar": rng.normal(0, 5, (2, 10, 9)).astype(np.float32),
            "scores": scores,
            "label_preds": rng.integers(0, 10, (2, 10)).astype(np.int32),
            "seg_probs": rng.random((2, 4, 4, 2)).astype(np.float32)}
    ps, js = (PETR.postprocess_to_samples(petr, metas),
              JaxPETR.postprocess_to_samples(petr, metas))
    same_samples(ps, js, ("bboxes_3d", "labels", "confidences",
                          "pred_semantic_map"))
    for p, j in zip(ps, js):
        np.testing.assert_array_equal(p.bboxes_3d.velocities,
                                      j.bboxes_3d.velocities)
        assert p.bboxes_3d.coordmode.name == j.bboxes_3d.coordmode.name


# ------------------------------------------------- configs and faults
def rooted(path, root):
    """The config at path as a dic with both datasets at root."""
    dic = Config(path=path, device="cpu").dic
    for split in ("train_dataset", "val_dataset"):
        dic[split]["dataset_root"] = root
    return dic


@pytest.mark.parametrize("name", [
    "smoke/smoke_dla34_no_dcn_kitti", "smoke/smoke_hrnet18_no_dcn_kitti",
    "caddn/caddn_ocrnet_hrnetw18_kitti", "caddn/caddn_resnet101_kitti",
    "dd3d/dd3d_dla34_kitti", "dd3d/dd3d_v2_99_kitti"])
def test_camera_configs_build_their_datasets(kitti_root, name):
    """Every SMOKE, CADDN and DD3D config builds both datasets through the
    port's Config on the small tree, and its train split collates the JAX
    config's batch keys and shapes (frames 0 and 3, of one image size:
    DD3D's pipeline does not resize)."""
    path = os.path.join(CONFIGS, name + ".yml")
    dic = rooted(path, kitti_root)
    cfg = Config(dic=dic, device="cpu")
    jcfg = JaxConfig(path=path)
    jdic = jcfg.dic
    for split in ("train_dataset", "val_dataset"):
        jdic[split]["dataset_root"] = kitti_root
    jds = JaxConfig(dic={"train_dataset": jdic["train_dataset"]}
                    ).train_dataset
    ds, val = cfg.train_dataset, cfg.val_dataset
    assert type(ds).__name__ == type(jds).__name__ and len(val) == 2
    np.random.seed(0)
    jb, _ = jds.collate_fn([jds[i] for i in (0, 3)])
    pb, _ = ds.collate_fn([ds.get(i, np.random.RandomState(0))
                           for i in (0, 3)])

    def shapes(b):
        return {k: (shapes(v) if isinstance(v, dict) else v.shape)
                for k, v in b.items()}
    assert shapes(pb) == shapes(jb)


def test_dd3d_configs_collate_no_targets_in_either_package(kitti_root):
    """Recorded, not repaired (ROADMAP.md, section 3): DD3D's configs pair
    KittiMonoDataset with LoadImage and Normalize alone, so a batch holds
    `data` and no target; DD3D's train_forward reads gt_boxes_2d and its
    test_forward K_inv first, and both packages' raise KeyError on it."""
    path = os.path.join(CONFIGS, "dd3d", "dd3d_dla34_kitti.yml")
    jdic = JaxConfig(path=path).dic
    jdic["train_dataset"]["dataset_root"] = kitti_root
    jds = JaxConfig(dic={"train_dataset": jdic["train_dataset"]}
                    ).train_dataset
    ds = Config(dic=rooted(path, kitti_root), device="cpu").train_dataset
    jb, _ = jds.collate_fn([jds[0]])
    pb, _ = ds.collate_fn([ds[0]])
    assert set(jb) == set(pb) == {"data"}
    with pytest.raises(KeyError, match="gt_boxes_2d"):
        JaxDD3D.train_forward(None, jb)
    with pytest.raises(KeyError, match="K_inv"):
        JaxDD3D.test_forward(None, jb)
    with pytest.raises(KeyError, match="gt_boxes_2d"):
        DD3D.train_forward(None, {k: torch.from_numpy(v)
                                  for k, v in pb.items()})


def test_eval_pads_nested_targets_where_jax_does_not():
    """A partial SMOKE batch (3 of 4): the JAX pad_batch pads `data` and
    leaves the `target` dict at 3 rows, so its decode would meet a batch of
    4 images with 3 K_inv; the port's pads the dict too, with zeros, and
    to_device moves its arrays."""
    from paddle3d_tpu_torch.apis.trainer import to_device
    batch = {"data": np.ones((3, 2, 2, 3), np.float32),
             "target": {"K_inv": np.ones((3, 3, 3), np.float32),
                        "down_ratio": np.ones((3, 2), np.float32)}}
    jax_pad = JaxTrainer.pad_batch(batch, 4)
    assert jax_pad["data"].shape[0] == 4
    assert jax_pad["target"]["K_inv"].shape[0] == 3
    pad = Trainer.pad_batch(batch, 4)
    assert pad["data"].shape[0] == pad["target"]["K_inv"].shape[0] == 4
    np.testing.assert_array_equal(pad["target"]["down_ratio"][3], [0, 0])
    moved = to_device(pad, "cpu")
    assert isinstance(moved["target"]["K_inv"], torch.Tensor)
    assert Trainer.pad_batch(batch, 3) is batch
