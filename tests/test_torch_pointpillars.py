"""Port parity of the whole inference slice on
configs/pointpillars/pointpillars_synthetic_tiny.yml: the JAX model and the
port built from the same YAML, the JAX weights (randomised eval BN) carried
across, the same numpy points through both test_forward paths.

Tolerances: head outputs 1e-4 (a conv stack of f32 sums in another order);
post_process on identical preds 1e-5 (the same elementwise math); end to
end the same kept set and labels, scores 1e-4 and boxes 1e-3 (box decode
exponentiates the 1e-4 head difference, over box sizes of a few metres).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from paddle3d_tpu.apis.config import Config as JaxConfig
from paddle3d_tpu.ops import box_ops as jax_box_ops
from paddle3d_tpu_torch.apis import Config
from paddle3d_tpu_torch.models.detection.pointpillars import PointPillarsLoss
from paddle3d_tpu_torch.ops import box_ops
from paddle3d_tpu_torch.utils.convert import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "pointpillars",
                    "pointpillars_synthetic_tiny.yml")


def flat_state(module):
    """nnx parameters and running stats as {dotted path: numpy array}."""
    return {".".join(map(str, k)): np.asarray(getattr(v, "value", v))
            for kind in (nnx.Param, nnx.BatchStat)
            for k, v in nnx.state(module, kind).flat_state()}


def make_points(seed, b=2, n=1024):
    """Tiny-config scans: ground returns plus car-sized clusters (so the
    head's scores spread and NMS has work), a few NaN-padded rows."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([0, -16, -2, 0], [32, 16, 2, 1], (b, n, 4))
    k = n // 2
    centers = rng.uniform([2, -14], [30, 14], (b, 10, 2))
    pick = rng.integers(0, 10, (b, k))
    pts[:, :k, :2] = np.take_along_axis(centers, pick[..., None], 1) + \
        rng.normal(0, [1.0, 0.5], (b, k, 2))
    pts[:, -8:] = np.nan
    return pts.astype(np.float32)


@pytest.fixture(scope="module")
def models():
    jax_model = JaxConfig(path=TINY).model
    rng = np.random.default_rng(0)
    for _, bn in jax_model.iter_modules():
        if isinstance(bn, nnx.BatchNorm):
            c = bn.mean.value.shape
            bn.mean.value = jnp.asarray(rng.normal(0, .2, c), jnp.float32)
            bn.var.value = jnp.asarray(rng.uniform(.5, 2., c), jnp.float32)
    # spread the class logits, so that the score gaps between candidates
    # stay well above the ~1e-7 the two frameworks differ by
    head = jax_model.head.cls_head
    head.kernel.value = head.kernel.value * 20.
    jax_model.eval()
    model = Config(path=TINY, device="cpu").model
    load_jax_params(model, flat_state(jax_model))
    return jax_model, model.eval()


@pytest.fixture(scope="module")
def jax_run(models):
    """JAX test_forward, split to also return the head outputs and mask."""
    jax_model, _ = models
    graphdef, state = nnx.split(jax_model)

    @jax.jit
    def infer(state, points):
        m = nnx.merge(graphdef, state)
        feats, mask = m._extract_feats(points, training=False)
        preds = m.head(feats)
        return preds, mask, m.head.post_process(preds, m._anchors, mask)

    pts = make_points(0)
    preds, mask, out = jax.device_get(infer(state, jnp.asarray(pts)))
    return pts, preds, mask, out


def test_head_outputs_match(models, jax_run):
    _, model = models
    pts, preds, mask, _ = jax_run
    with torch.no_grad():
        feats, tmask = model._extract_feats(torch.from_numpy(pts), False)
        tpreds = model.head(feats)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
    assert mask.sum() > 0
    for key in ("cls_preds", "box_preds", "dir_preds"):
        np.testing.assert_allclose(tpreds[key].numpy(),
                                   np.asarray(preds[key]), rtol=1e-4,
                                   atol=1e-4)


def test_post_process_on_identical_preds(models, jax_run):
    _, model = models
    _, preds, mask, out = jax_run
    got = model.head.post_process(
        {k: torch.from_numpy(np.array(v)) for k, v in preds.items()},
        model.anchors, torch.from_numpy(np.array(mask)))
    np.testing.assert_array_equal(got["label_preds"].numpy(),
                                  out["label_preds"])
    np.testing.assert_allclose(got["scores"].numpy(), out["scores"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["box3d_lidar"].numpy(),
                               out["box3d_lidar"], rtol=1e-5, atol=1e-5)
    assert (out["scores"] >= 0).sum() > 0


def test_end_to_end_matches_jax(models, jax_run):
    _, model = models
    pts, _, _, out = jax_run
    got = model.test_forward({"data": torch.from_numpy(pts)})
    assert got["box3d_lidar"].shape == (2, 50, 7)
    np.testing.assert_array_equal(got["label_preds"].numpy(),
                                  out["label_preds"])
    np.testing.assert_allclose(got["scores"].numpy(), out["scores"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["box3d_lidar"].numpy(),
                               out["box3d_lidar"], rtol=1e-3, atol=1e-3)


def test_entry_points(models):
    _, model = models
    pts = torch.from_numpy(make_points(1))
    out = model.export_forward({"data": pts})
    scores = out["scores"].numpy()
    assert np.all((scores >= 0) | (scores == -1))
    boxes = np.zeros((2, 3, 7), np.float32)
    boxes[..., :3] = [10., 0., -1.]
    boxes[..., 3:6] = [1.6, 3.9, 1.56]
    losses = model.train_forward({
        "data": pts, "gt_boxes": torch.from_numpy(boxes),
        "gt_labels": torch.tensor([[0, 0, -1], [0, -1, -1]])})
    assert set(losses) == {"loss", "loss_cls", "loss_reg", "loss_dir"}
    assert all(np.isfinite(v.item()) for v in losses.values())


def test_port_imports_no_jax(tmp_path):
    """The port imports torch and never jax, flax, PIL or paddle3d_tpu:
    import it, its sparse-voxel modules, the weight converter and the
    camera host layer (Sample, Gt2SmokeTarget), the BEVFusion and DD3D
    modules, the runtime (Trainer, DataLoader, Checkpoint, Scheduler, the
    EMA, logger, timer, summary, env, the KITTI, nuScenes, Waymo and
    synthetic datasets and metrics, the point transforms, the GT-paste
    transform and its database tool, transform3d, the geometry, the CLI),
    the camera runtime (the PNG reader and its native unfilter, the resize,
    the KITTI mono and depth datasets, the camera postprocess), the
    multi-view runtime (the JPEG reader and its native decoder, the shared
    host build, the multi-view transforms, the nuScenes multi-view,
    segmentation and multi-modality datasets, the Apollo lane dataset, the
    BEVDet, BEVFormer and RTEBev modules), and build the tiny model, its
    datasets, the CenterPoint-voxels model, the tiny SMOKE, a sample of
    each synthetic camera dataset (SMOKE's through Gt2SmokeTarget) and a
    multi-view sample of a small nuScenes tree of JPEGs in a fresh
    interpreter; cv2 is refused too."""
    voxels = os.path.join(REPO, "configs", "centerpoint",
                          "centerpoint_voxels_0075voxel_nuscenes_10sweep.yml")
    smoke = os.path.join(REPO, "configs", "smoke", "smoke_synthetic_tiny.yml")
    caddn = os.path.join(REPO, "configs", "caddn", "caddn_synthetic_tiny.yml")
    petr = os.path.join(REPO, "configs", "petr", "petr_synthetic_tiny.yml")
    code = (
        "import sys\n"
        "from paddle3d_tpu_torch.apis import Config\n"
        "import paddle3d_tpu_torch.ops.sparse_conv\n"
        "import paddle3d_tpu_torch.ops.sparse\n"
        "import paddle3d_tpu_torch.ops.segmented\n"
        "import paddle3d_tpu_torch.utils.convert\n"
        "import paddle3d_tpu_torch.sample\n"
        "import paddle3d_tpu_torch.transforms.target_generator\n"
        "import paddle3d_tpu_torch.models.detection.bevfusion\n"
        "import paddle3d_tpu_torch.models.detection.dd3d\n"
        "import paddle3d_tpu_torch.apis.trainer\n"
        "import paddle3d_tpu_torch.apis.dataloader\n"
        "import paddle3d_tpu_torch.apis.checkpoint\n"
        "import paddle3d_tpu_torch.apis.scheduler\n"
        "import paddle3d_tpu_torch.utils.ema\n"
        "import paddle3d_tpu_torch.utils.logger\n"
        "import paddle3d_tpu_torch.utils.timer\n"
        "import paddle3d_tpu_torch.utils.summary\n"
        "import paddle3d_tpu_torch.env\n"
        "import paddle3d_tpu_torch.geometries.bbox\n"
        "import paddle3d_tpu_torch.transforms.reader\n"
        "import paddle3d_tpu_torch.transforms.transform\n"
        "import paddle3d_tpu_torch.datasets.kitti.kitti_det\n"
        "import paddle3d_tpu_torch.datasets.kitti.eval\n"
        "import paddle3d_tpu_torch.datasets.synthetic\n"
        "import paddle3d_tpu_torch.tools.train\n"
        "import paddle3d_tpu_torch.tools.evaluate\n"
        "import paddle3d_tpu_torch.tools.create_det_gt_database\n"
        "import paddle3d_tpu_torch.transforms.sampling\n"
        "import paddle3d_tpu_torch.utils.transform3d\n"
        "import paddle3d_tpu_torch.datasets.nuscenes.nuscenes_det\n"
        "import paddle3d_tpu_torch.datasets.nuscenes.nuscenes_metric\n"
        "import paddle3d_tpu_torch.datasets.waymo.waymo_det\n"
        "import paddle3d_tpu_torch.utils.png\n"
        "import paddle3d_tpu_torch.utils.image\n"
        "import paddle3d_tpu_torch.datasets.kitti.kitti_mono_det\n"
        "import paddle3d_tpu_torch.datasets.kitti.kitti_depth_det\n"
        "import paddle3d_tpu_torch.models.detection.smoke.smoke\n"
        "import paddle3d_tpu_torch.models.detection.caddn.caddn\n"
        "import paddle3d_tpu_torch.models.detection.petr.petr3d\n"
        "import paddle3d_tpu_torch.utils.jpeg\n"
        "import paddle3d_tpu_torch.utils.native\n"
        "import paddle3d_tpu_torch.transforms.multiview\n"
        "import paddle3d_tpu_torch.datasets.nuscenes.nuscenes_multiview_det\n"
        "import paddle3d_tpu_torch.datasets.nuscenes.nuscenes_multi_modality\n"
        "import paddle3d_tpu_torch.datasets.apollo.apollo_lane\n"
        "import paddle3d_tpu_torch.models.detection.bevdet.bevdet\n"
        "import paddle3d_tpu_torch.models.detection.bevformer.bevformer\n"
        "import paddle3d_tpu_torch.models.detection.rtebev.rtebev\n"
        "c = Config(path=sys.argv[1], device='cpu')\n"
        "m, d = c.model, (c.train_dataset, c.val_dataset)\n"
        "v = Config(path=sys.argv[2], device='cpu').model\n"
        "sc = Config(path=sys.argv[3], device='cpu')\n"
        "s = sc.model\n"
        "cam = [sc.train_dataset.get(0).target['hm'].shape,\n"
        "       Config(path=sys.argv[4], device='cpu').train_dataset[0],\n"
        "       Config(path=sys.argv[5], device='cpu').train_dataset[0]]\n"
        "import numpy as np\n"
        "from paddle3d_tpu_torch.utils import image, png\n"
        "png.unfilter(bytes(4), 2, 1, 1)\n"
        "image.resize(np.zeros((4, 4, 3), np.uint8), (5, 3))\n"
        "import chip_smoke\n"
        "from paddle3d_tpu_torch.datasets import NuscenesMVDataset\n"
        "chip_smoke.nuscenes_tree(sys.argv[6], train=2, val=1, points=500,\n"
        "                         cameras=(18, 32))\n"
        "mv = NuscenesMVDataset(sys.argv[6], 'v1.0-trainval',\n"
        "                       image_size=(16, 24))[0]\n"
        "assert mv.img.shape == (6, 16, 24, 3)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'flax', 'PIL', 'cv2',\n"
        "                                    'paddle3d_tpu'))\n"
        "assert type(m).__name__ == 'PointPillars'\n"
        "assert type(v.middle_encoder).__name__ == 'SparseResNet3D'\n"
        "assert type(s.backbone).__name__ == 'DLA'\n"
        "print(bad)\n")
    res = subprocess.run([sys.executable, "-c", code, TINY, voxels, smoke,
                          caddn, petr, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_config_base_merge_and_dropped_keys(tmp_path, caplog):
    """`_base_` merges a child YAML over its base; a key the component does
    not take is dropped with a warning; the training `loss` is built."""
    child = tmp_path / "child.yml"
    child.write_text(
        "_base_: {}\n"
        "model:\n"
        "  head:\n"
        "    nms_post_max_size: 20\n"
        "    lr_mult_list: [1.0]\n".format(TINY))
    with caplog.at_level("WARNING"):
        model = Config(path=str(child), device="cpu").model
    assert model.head.nms_post_max_size == 20
    assert model.head.nms_pre_max_size == 512        # from the base
    assert "lr_mult_list" in caplog.text
    assert isinstance(model.loss, PointPillarsLoss)


def test_box_ops_match_jax():
    rng = np.random.default_rng(4)
    enc = rng.normal(0, .3, (64, 7)).astype(np.float32)
    anchors = np.concatenate([rng.uniform(-40, 40, (64, 3)),
                              rng.uniform(1, 4, (64, 3)),
                              rng.uniform(-3, 3, (64, 1))], -1).astype(
                                  np.float32)
    np.testing.assert_allclose(
        box_ops.second_box_decode(torch.from_numpy(enc),
                                  torch.from_numpy(anchors)).numpy(),
        np.asarray(jax_box_ops.second_box_decode(enc, anchors)),
        rtol=1e-6, atol=1e-5)
    ang = rng.uniform(-10, 10, 64).astype(np.float32)
    np.testing.assert_allclose(
        box_ops.limit_period(torch.from_numpy(ang), 0.5, 2 * np.pi).numpy(),
        np.asarray(jax_box_ops.limit_period(ang, 0.5, 2 * np.pi)),
        rtol=1e-6, atol=1e-5)
