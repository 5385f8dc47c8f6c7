"""Port parity of the runtime against the JAX package: Config, DataLoader,
Scheduler, Checkpoint, the EMA, the Trainer, postprocess_to_samples and the
CLI. The JAX side is numpy-only modules (no jit); the port runs on the CPU.

Tolerances: the loader's index order, the Scheduler's flags, the EMA
decays and postprocess_to_samples are compared exactly (both sides are
numpy or Python floats); the EMA update, the checkpoints and a resumed
Trainer's state bit for bit.
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import chip_smoke
from paddle3d_tpu.apis import config as jconfig
from paddle3d_tpu.apis import dataloader as jloader
from paddle3d_tpu.apis import scheduler as jscheduler
from paddle3d_tpu.apis.trainer import Trainer as JaxTrainer
from paddle3d_tpu.models.detection.centerpoint.centerpoint import \
    CenterPoint as JaxCenterPoint
from paddle3d_tpu.models.detection.iassd.iassd import IASSD as JaxIASSD
from paddle3d_tpu.models.detection.pointpillars.pointpillars import \
    PointPillars as JaxPointPillars
from paddle3d_tpu.models.detection.pv_rcnn.pv_rcnn import PVRCNN as JaxPVRCNN
from paddle3d_tpu.models.detection.pv_rcnn.pv_rcnn import \
    VoxelRCNN as JaxVoxelRCNN
from paddle3d_tpu_torch import models as pmodels
from paddle3d_tpu_torch.apis import (Checkpoint, Config, DataLoader,
                                     Scheduler, Trainer, make_train_step)
from paddle3d_tpu_torch.datasets import KittiPCDataset
from paddle3d_tpu_torch.utils import ema as pema

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "pointpillars",
                    "pointpillars_synthetic_tiny.yml")
KITTI = os.path.join(REPO, "configs", "pointpillars",
                     "pointpillars_xyres16_kitti_car.yml")
PORTED = ["pointpillars/pointpillars_synthetic_tiny.yml",
          "centerpoint/centerpoint_synthetic_tiny.yml",
          "iassd/iassd_synthetic_tiny.yml",
          "paconv/paconv_synthetic_tiny.yml",
          "squeezesegv3/squeezesegv3_synthetic_tiny.yml"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny model's steps and NMS are many small ops: intra-op threads
    add only fork-and-join time to each, which a parallel test run beside
    the loader's threads turned into a minute for the Trainer test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """chip_smoke's KITTI tree, small: 6 train and 2 val frames of 2,000
    points."""
    root = str(tmp_path_factory.mktemp("kitti"))
    chip_smoke.kitti_tree(root, train=6, val=2, points=2000)
    return root


# -------------------------------------------------------------------- Config
@pytest.mark.parametrize("path", PORTED)
def test_config_builds_the_ported_datasets(path):
    """Every tiny config whose dataset is ported: the dic (overrides
    included) equals the JAX Config's, and both datasets build, of the JAX
    types and lengths."""
    path = os.path.join(REPO, "configs", path)
    kw = dict(iters=3, batch_size=4, learning_rate=0.5)
    cfg = Config(path=path, device="cpu", **kw)
    jcfg = jconfig.Config(path=path, **kw)
    assert cfg.dic == jcfg.dic
    for split in ("train_dataset", "val_dataset"):
        ds = getattr(cfg, split)
        assert type(ds).__name__ == jcfg.dic[split]["type"]
        assert len(ds) == jcfg.dic[split]["num_samples"]
    assert (cfg.batch_size, cfg.iters, cfg.epochs, cfg.train_by_epoch) == \
        (4, 3, None, False)


def test_config_surface_matches_jax(kitti_root, tmp_path):
    """dic=, the epochs override (drops iters), the dict properties, str,
    the $paddleseg. prefix, sync_bn's refusal and the KITTI car config's
    datasets on a tree pointed at through dic; to_dict on the tiny config
    (it builds the model)."""
    dic = Config(path=KITTI, device="cpu").dic
    for split in ("train_dataset", "val_dataset"):
        dic[split]["dataset_root"] = kitti_root
    dic["ema_cfg"] = {"decay": 0.99}
    cfg = Config(dic=dic, epochs=2, device="cpu")
    jcfg = jconfig.Config(dic=dic, epochs=2)
    assert cfg.dic == jcfg.dic and "iters" not in cfg.dic
    for k in ("batch_size", "iters", "epochs", "train_by_epoch", "amp_cfg",
              "ema_cfg", "export_cfg", "train_dataset_config",
              "val_dataset_config"):
        assert getattr(cfg, k) == getattr(jcfg, k), k
    assert str(cfg) == str(jcfg)
    train, val = cfg.train_dataset, cfg.val_dataset
    assert isinstance(train, KittiPCDataset) and (len(train), len(val)) == \
        (6, 2)
    assert [type(t).__name__ for t in train.transforms.transforms] == [
        t["type"] for t in dic["train_dataset"]["transforms"]]
    tiny = Config(path=TINY, device="cpu")
    d = tiny.to_dict()                  # builds the model: the tiny one
    assert set(d) == set(tiny.dic) - {"lr_scheduler"}
    assert isinstance(d["optimizer"], torch.optim.Optimizer)
    assert type(d["train_dataset"]).__name__ == "SyntheticDataset"
    assert cfg._load_component("$paddleseg.StepDecay") is \
        cfg._load_component("StepDecay")
    with pytest.raises(NotImplementedError, match="parallel/mesh.py"):
        Config(dic=dict(dic, sync_bn=True), device="cpu").sync_bn
    with pytest.raises(ValueError, match="path or dic"):
        Config(device="cpu")


# ---------------------------------------------------------------- DataLoader
@pytest.mark.parametrize("n,bs,shuffle,shards,drop", [
    (16, 2, True, 1, True), (17, 3, True, 2, False), (10, 4, False, 1, False),
    (9, 2, True, 3, True)])
def test_loader_index_order_matches_jax(n, bs, shuffle, shards, drop):
    """The indices of three epochs of every shard, and the length, equal
    the JAX DataLoader's."""
    ds = type("DS", (), {"__len__": lambda self: n})()
    for s in range(shards):
        kw = dict(batch_size=bs, shuffle=shuffle, drop_last=drop, seed=3,
                  num_shards=shards, shard_index=s)
        a, b = DataLoader(ds, **kw), jloader.DataLoader(ds, **kw)
        assert len(a) == len(b)
        for epoch in range(3):
            a.epoch = b.epoch = epoch
            np.testing.assert_array_equal(a._indices(), b._indices())


def test_loader_batches_do_not_depend_on_workers(kitti_root):
    """Two epochs of the KITTI car config's train pipeline (random flips,
    rotation, scale, translation, shuffle): the batches with 1 and 4
    worker threads are equal, the second epoch draws anew, and each sample
    is dataset.get(index, sample_rng(seed, epoch, index))."""
    dic = Config(path=KITTI, device="cpu").dic["train_dataset"]
    dic["dataset_root"] = kitti_root
    ds = Config(dic={"train_dataset": dic}, device="cpu").train_dataset
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
    order = np.arange(6)
    np.random.default_rng(5 + 1).shuffle(order)
    from paddle3d_tpu_torch.transforms import sample_rng
    want = ds.get(int(order[0]), sample_rng(5, 1, int(order[0])))
    got = runs[0][3][0]["data"][0]
    np.testing.assert_array_equal(got[:len(want.data)], np.asarray(want.data))
    assert np.isnan(got[len(want.data):]).all()
    assert not np.array_equal(runs[0][0][0]["data"][0], got)


@pytest.mark.parametrize("workers", [1, 4])
def test_loader_closed_early_builds_no_queued_batch(workers):
    """A consumer that stops after the first batch (a Trainer ending
    mid-epoch): closing the generator waits only for the batches being
    built, cancels the queued ones and leaves no worker thread behind."""
    import threading
    import time
    built = []

    class Slow:
        def __len__(self):
            return 40

        def __getitem__(self, i):
            time.sleep(0.05)
            built.append(i)
            return i

        @staticmethod
        def collate_fn(samples):
            return samples

    threads = threading.active_count()
    loader = iter(DataLoader(Slow(), batch_size=1, num_workers=workers,
                             prefetch=16))
    assert next(loader) == [0]
    loader.close()
    # what the workers had started by then (a batch each, or two where a
    # worker finished one beside the first); not the 16 in the window
    assert 1 <= len(built) <= 2 * workers
    assert threading.active_count() == threads


# ----------------------------------------------------- Scheduler, Checkpoint
@pytest.mark.parametrize("kw", [
    dict(save_interval=3, log_interval=2, do_eval=True),
    dict(save_interval=2, log_interval=0, do_eval=True, train_by_epoch=True,
         iters_per_epoch=4),
    dict(save_interval=0, log_interval=5),
    dict(save_interval=1, log_interval=1, train_by_epoch=True,
         iters_per_epoch=3)])
def test_scheduler_matches_jax(kw):
    a, b = Scheduler(**kw), jscheduler.Scheduler(**kw)
    for count in [1] * 20 + [2, 3]:
        assert tuple(a.step(count)) == tuple(b.step(count))


def test_checkpoint_queue_eviction_and_records(tmp_path):
    """Pushes past keep_checkpoint_max evict the oldest; best_model links
    the newest; records persist in meta.yaml across a reload; get hands
    back the four state dicts of a tag; pop drops the oldest."""
    ck = Checkpoint(str(tmp_path), keep_checkpoint_max=2)
    lin = torch.nn.Linear(3, 2)
    for i in range(1, 4):
        with torch.no_grad():
            lin.weight.fill_(i)
        ck.push("iter_{}".format(i), lin.state_dict(), opt_state={"s": i},
                sched_state={"last_epoch": i},
                ema_state={"weight": lin.weight.detach() * 2})
        ck.record("iters", i)
    assert ck.queue == ["iter_2", "iter_3"]
    assert not os.path.exists(tmp_path / "iter_1")
    assert os.readlink(tmp_path / "best_model") == "iter_3"
    again = Checkpoint(str(tmp_path), keep_checkpoint_max=2)
    assert again.queue == ck.queue and again.get_record("iters") == 3
    model, opt, sched, ema = again.get()
    assert model["weight"].eq(3).all() and opt == {"s": 3}
    assert sched == {"last_epoch": 3} and ema["weight"].eq(6).all()
    assert again.get("iter_2")[0]["weight"].eq(2).all()
    assert again.pop() == "iter_2" and again.queue == ["iter_3"]
    ck2 = Checkpoint(str(tmp_path / "b"))
    ck2.push("t", lin.state_dict())
    assert ck2.get()[1:] == (None, None, None)


# ----------------------------------------------------------------------- EMA
@pytest.mark.parametrize("kind", ["threshold", "exponential", "constant"])
def test_ema_decay_schedule_matches_jax(kind):
    """_ema_decay_now over two cycles (3 iterations an epoch, a 2-epoch
    cycle): the same decays as the JAX Trainer's, the cycle reset restarts
    the average from the live parameters and the step at 1."""
    model = torch.nn.Linear(2, 2)

    def stub(cls):
        t = cls.__new__(cls)
        t.ema_decay, t.ema_decay_type = 0.999, kind
        t.ema_cycle_epoch, t.ema_step = 2, 0
        t.scheduler = types.SimpleNamespace(iters_per_epoch=3)
        t.model = model
        t.ema_params = {"weight": torch.zeros(2, 2)}
        return t
    port, jax_t = stub(Trainer), stub(JaxTrainer)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("paddle3d_tpu.apis.trainer.nnx.state",
                   lambda m, kind: "reset")
        for _ in range(14):
            assert port._ema_decay_now() == jax_t._ema_decay_now()
            assert port.ema_step == jax_t.ema_step
    assert jax_t.ema_params == "reset"
    torch.testing.assert_close(port.ema_params["weight"], model.weight,
                               rtol=0, atol=0)


def test_ema_train_step_is_the_hand_update():
    """make_train_step(ema_decay=...) -> step(model, optimizer, ema, batch,
    decay): after the optimizer step every parameter's shadow is
    d * e + (1 - d) * p, bit for bit; decay=None takes ema_decay; the
    buffers are not averaged."""
    torch.manual_seed(0)

    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(4, 3)
            self.bn = torch.nn.BatchNorm1d(3)

        def train_forward(self, batch):
            return {"loss": self.bn(self.lin(batch["x"])).pow(2).mean()}
    model = M()
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    ema = pema.init_ema(model)
    assert set(ema) == {k for k, _ in model.named_parameters()}
    step = make_train_step(ema_decay=0.9)
    batch = {"x": torch.randn(8, 4)}
    for decay in (0.5, None):
        before = {k: v.clone() for k, v in ema.items()}
        losses, out = step(model, opt, ema, batch, decay)
        assert out is ema and set(losses) == {"loss"}
        d = 0.9 if decay is None else decay
        for k, p in model.named_parameters():
            want = d * before[k] + (1.0 - d) * p.detach()
            assert chip_smoke.same_bits(ema[k], want), k
    backup = pema.swap_in(model, ema)
    assert all(chip_smoke.same_bits(p.detach(), ema[k])
               for k, p in model.named_parameters())
    pema.swap_in(model, backup)


# ------------------------------------------------------------------- Trainer
def _tiny_trainer(save_dir, seed, resume=False, **kw):
    torch.manual_seed(seed)
    dic = Config(path=TINY, device="cpu").dic
    dic["lr_scheduler"]["step_size"] = 3      # the rate moves at step 3
    cfg = Config(dic=dic, device="cpu")
    return Trainer(model=cfg.model, optimizer=cfg.optimizer,
                   lr_scheduler=cfg.lr_scheduler, iters=4,
                   train_dataset=cfg.train_dataset,
                   val_dataset=cfg.val_dataset, batch_size=2,
                   save_dir=save_dir, save_interval=2, log_interval=2,
                   keep_checkpoint_max=1, ema_decay=0.9, resume=resume,
                   dataloader_fn={"num_workers": 2}, **kw)


def test_trainer_trains_resumes_bit_equal_and_evaluates(tmp_path):
    """The tiny config: 4 iterations with an EMA and a checkpoint every 2
    (keep 1); a second Trainer(resume=True) on other weights restores the
    model, the optimizer, the schedule and the EMA bit for bit, and one
    more step on the same batch gives both the same bits at the same rate;
    evaluate(use_ema) through SyntheticMetric leaves the live weights and
    train mode; a resume in epoch mode from an iteration run raises."""
    out = str(tmp_path / "out")
    t1 = _tiny_trainer(out, 0)
    t1.train()
    assert t1.cur_iter == 4 and t1.checkpoint.queue == ["iter_4"]
    assert t1.checkpoint.get_record("ema_step") == 4
    t2 = _tiny_trainer(out, 1, resume=True)
    assert (t2.cur_iter, t2.ema_step, t2.scheduler.cur_iter) == (4, 4, 4)
    for a, b in ((t1.model.state_dict(), t2.model.state_dict()),
                 (t1.ema_params, t2.ema_params)):
        assert all(chip_smoke.same_bits(a[k], b[k]) for k in a)
    assert chip_smoke.same_state(t1.optimizer.state_dict(),
                                 t2.optimizer.state_dict()) == []
    assert t2.lr_scheduler.state_dict() == t1.lr_scheduler.state_dict()
    assert t2.optimizer.param_groups[0]["lr"] == pytest.approx(0.002 * 0.8,
                                                                rel=1e-12)
    batch, _ = next(iter(t1.train_dataloader))
    from paddle3d_tpu_torch.apis.trainer import to_device
    for t in (t1, t2):
        t._train_step(t.model, t.optimizer, t.ema_params,
                      to_device(batch, "cpu"), 0.5)
    assert all(chip_smoke.same_bits(p, q) for p, q in zip(
        t1.model.parameters(), t2.model.parameters()))
    live = [p.detach().clone() for p in t1.model.parameters()]
    metrics = t1.evaluate(use_ema=True)
    assert set(metrics) == {"recall@2m", "precision@2m"}
    assert t1.model.training
    assert all(chip_smoke.same_bits(p.detach(), q)
               for p, q in zip(t1.model.parameters(), live))
    torch.manual_seed(2)
    cfg = Config(path=TINY, device="cpu")
    with pytest.raises(RuntimeError, match="Unable to resume"):
        Trainer(model=cfg.model, optimizer=cfg.optimizer, epochs=1,
                train_dataset=cfg.train_dataset, batch_size=2, save_dir=out,
                resume=True)


class _OneFrame:
    """A train split of one frame."""
    class_names = ["Car"]

    def __len__(self):
        return 1

    def __getitem__(self, i):
        raise AssertionError("no sample is built")


def test_trainer_over_a_split_shorter_than_a_batch_raises(tmp_path):
    """A one-frame split at batch 2 (drop_last): the port's Trainer raises
    ValueError naming the split's size and the batch, in a thread joined
    with a timeout, so that a loop would fail the test instead of hanging
    it. The JAX Trainer takes max(1, 0) steps an epoch over the empty
    loader (its train() would rebuild that loader forever); train() is not
    run."""
    import threading

    import optax
    from flax import nnx
    cfg = Config(path=TINY, device="cpu")
    out = {}

    def build():
        try:
            Trainer(model=cfg.model, optimizer=cfg.optimizer,
                    lr_scheduler=cfg.lr_scheduler, iters=4,
                    train_dataset=_OneFrame(), batch_size=2,
                    save_dir=str(tmp_path / "port"))
        except Exception as e:                # noqa: BLE001
            out["error"] = e
    thread = threading.Thread(target=build, daemon=True)
    thread.start()
    thread.join(timeout=60)
    assert not thread.is_alive(), "the Trainer did not return"
    err = out.get("error")
    assert isinstance(err, ValueError), err
    assert "1 frames" in str(err) and "batch of 2" in str(err)
    assert "drop_last" in str(err)
    jt = JaxTrainer(model=nnx.Linear(1, 1, rngs=nnx.Rngs(0)),
                    optimizer=optax.sgd(0.1), iters=4,
                    train_dataset=_OneFrame(), batch_size=2,
                    save_dir=str(tmp_path / "jax"))
    assert len(jt.train_dataloader) == 0
    assert jt.scheduler.iters_per_epoch == 1


def test_trainer_refusals_and_pad_batch(tmp_path):
    """profiler_options and AMP raise naming their items; pad_batch
    zero-pads every leading-batch array as the JAX one does."""
    cfg = Config(path=TINY, device="cpu")
    kw = dict(model=cfg.model, optimizer=cfg.optimizer,
              save_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="utils/profiler.py"):
        Trainer(profiler_options="batch_range=[1,2]", **kw)
    with pytest.raises(NotImplementedError, match="item 15"):
        Trainer(amp_cfg={"use_amp": True, "level": "O2"}, **kw)
    batch = {"data": np.ones((1, 3, 4), np.float32),
             "ids": np.arange(1), "k": np.ones((2, 2))}
    got, want = Trainer.pad_batch(batch, 3), JaxTrainer.pad_batch(batch, 3)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------- postprocess_to_samples
@pytest.mark.parametrize("port,jax_cls,width", [
    (pmodels.detection.pointpillars.PointPillars, JaxPointPillars, 7),
    (pmodels.detection.centerpoint.CenterPoint, JaxCenterPoint, 7),
    (pmodels.detection.centerpoint.CenterPoint, JaxCenterPoint, 9),
    (pmodels.detection.pv_rcnn.pv_rcnn.PVRCNN, JaxPVRCNN, 7),
    (pmodels.detection.pv_rcnn.pv_rcnn.VoxelRCNN, JaxVoxelRCNN, 7),
    (pmodels.detection.iassd.iassd.IASSD, JaxIASSD, 7)])
def test_postprocess_to_samples_matches_jax(port, jax_cls, width):
    """The same -1-padded output arrays (a scan with no box among them):
    boxes, velocities, labels, confidences, alpha, calibs and meta equal
    the JAX static method's."""
    rng = np.random.default_rng(width)
    scores = rng.uniform(0, 1, (3, 6)).astype(np.float32)
    scores[0, 4:] = -1
    scores[2] = -1
    outputs = {"box3d_lidar": rng.normal(0, 5, (3, 6, width)).astype(
        np.float32), "scores": scores,
        "label_preds": np.where(scores >= 0, rng.integers(0, 3, (3, 6)),
                                -1).astype(np.int32)}
    metas = [{"path": "p{}".format(i), "id": "00000{}".format(i),
              "calibs": [np.eye(3) * i]} for i in range(3)]
    metas[1].pop("calibs")
    got = port.postprocess_to_samples(outputs, metas)
    want = jax_cls.postprocess_to_samples(outputs, metas)
    assert len(got) == len(want) == 3 and len(got[2].bboxes_3d) == 0
    for g, w in zip(got, want):
        for k in ("bboxes_3d", "labels", "confidences", "alpha"):
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))
        assert g.bboxes_3d.origin == w.bboxes_3d.origin
        np.testing.assert_array_equal(
            np.asarray(g.bboxes_3d.velocities, dtype=float),
            np.asarray(w.bboxes_3d.velocities, dtype=float))
        assert dict(g.meta) == dict(w.meta) and g.path == w.path
        assert (g.calibs is None) == (w.calibs is None)


# ----------------------------------------------------------------------- CLI
def test_cli_trains_and_evaluates_on_the_cpu(tmp_path):
    """python -m paddle3d_tpu_torch.tools.train on the tiny config with
    --device cpu in a subprocess (one intra-op thread: the suite runs
    workers beside it): exit 0, checkpoints at iterations 2 and 3; then
    tools.evaluate's main on its checkpoint gives the metric."""
    out = str(tmp_path / "cli")
    res = subprocess.run(
        [sys.executable, "-m", "paddle3d_tpu_torch.tools.train", "--config",
         TINY, "--iters", "3", "--save_interval", "2", "--log_interval",
         "1", "--num_workers", "2", "--save_dir", out, "--device", "cpu",
         "--seed", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "[TRAIN] iter=3/3" in res.stdout
    ck = Checkpoint(os.path.join(out, "checkpoints"))
    assert ck.queue == ["iter_2", "iter_3"]
    from paddle3d_tpu_torch.tools import evaluate
    metrics = evaluate.main(evaluate.parse_args(
        ["--config", TINY, "--device", "cpu", "--model",
         os.path.join(out, "checkpoints", "iter_3")]))
    assert set(metrics) == {"recall@2m", "precision@2m"}
