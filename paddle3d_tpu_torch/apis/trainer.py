"""Training runtime, torch port of paddle3d_tpu/apis/trainer.py (reference:
paddle3d/apis/trainer.py:110).

The same surface: Trainer(model, optimizer, ...).train() / evaluate(), the
rolling checkpoints, the interval scheduler, the EMA with its decay
schedules and cycle reset, and resume with the epoch / iter-mode check.
Differences:

  * the optimizer is a torch optimizer and the LR schedule a LambdaLR
    beside it (`Config.optimizer`, `Config.lr_scheduler`); the JAX step
    keeps the schedule's count inside the optax state. A checkpoint holds
    both, so a resumed run continues the schedule where it stopped;
  * the loader's numpy batches go to the model's device here, one copy a
    tensor, nested dicts (SMOKE's `target`) included; the Timer's reader
    cost is the wait for the next batch;
  * evaluate() pads a partial batch's nested dicts too: the JAX pad_batch
    pads the top level only, so SMOKE's targets there keep the partial
    batch's rows beside a padded image batch (ROADMAP.md, section 3);
  * one process: multi-process data parallel waits for parallel/mesh.py
    (ROADMAP.md, queue 1, item 5), and the profiler for utils/profiler.py.
"""
import copy
import math
import os
from typing import Optional

import numpy as np
import torch

from ..utils.ema import init_ema, swap_in
from ..utils.logger import logger, process_index
from ..utils.summary import ScalarWriter
from ..utils.timer import Timer
from .checkpoint import Checkpoint
from .dataloader import DataLoader
from .pipeline import make_eval_step, make_train_step
from .scheduler import Scheduler

__all__ = ["Trainer", "to_device"]


def to_device(batch: dict, device) -> dict:
    """The numpy arrays of a collated batch, and of the dicts in it, as
    tensors on `device` (one copy each); other values pass through."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        elif isinstance(v, dict):
            v = to_device(v, device)
        out[k] = v
    return out


class Trainer:
    def __init__(self,
                 model,
                 optimizer,
                 iters: Optional[int] = None,
                 epochs: Optional[int] = None,
                 train_dataset=None,
                 val_dataset=None,
                 batch_size: int = 1,
                 save_dir: str = "output",
                 keep_checkpoint_max: int = 5,
                 save_interval: int = 1000,
                 log_interval: int = 10,
                 do_eval: bool = False,
                 resume: bool = False,
                 ema_decay: Optional[float] = None,
                 ema_cfg: Optional[dict] = None,
                 grad_clip_norm: Optional[float] = None,
                 amp_cfg: Optional[dict] = None,
                 dataloader_fn: Optional[dict] = None,
                 seed: int = 0,
                 profiler_options: Optional[str] = None,
                 lr_scheduler=None):
        """model: a port model on its device; optimizer: a torch optimizer
        over its parameters; lr_scheduler: the LambdaLR over that optimizer
        (stepped once an iteration, saved and restored with it)."""
        if profiler_options is not None:
            raise NotImplementedError(
                "profiler_options needs utils/profiler.py, not ported yet "
                "(ROADMAP.md, queue 1, item 5)")
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized() and \
                dist.get_world_size() > 1:
            raise NotImplementedError(
                "multi-process data parallel needs parallel/mesh.py, not "
                "ported yet (ROADMAP.md, queue 1, item 5)")
        self.model = model
        self.optimizer = optimizer
        self.lr_scheduler = lr_scheduler
        self.device = next(model.parameters()).device
        self.batch_size = batch_size
        self.save_dir = save_dir
        # reference ModelEMA surface (utils/ema.py:45): decay schedule
        # type, cycle reset, start step; ema_cfg takes precedence
        ema_cfg = dict(ema_cfg or {})
        if ema_cfg and ema_decay is None:
            ema_decay = float(ema_cfg.get("decay", 0.9998))
        self.ema_decay = ema_decay
        self.ema_decay_type = ema_cfg.get("ema_decay_type", "threshold")
        self.ema_cycle_epoch = int(ema_cfg.get("cycle_epoch", -1))
        self.ema_step = int(ema_cfg.get("step", 0))

        dl_kwargs = dict(dataloader_fn or {})
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        if train_dataset is not None:
            self.train_dataloader = DataLoader(
                train_dataset, batch_size=batch_size, shuffle=True,
                drop_last=True, seed=seed, **dl_kwargs)
            iters_per_epoch = len(self.train_dataloader)
            if iters_per_epoch == 0:
                # the JAX Trainer takes max(1, 0) and its train() then
                # rebuilds the empty loader forever
                raise ValueError(
                    "the train split holds {} frames, fewer than a batch of "
                    "{} (drop_last=True): an epoch has no step".format(
                        len(train_dataset), batch_size))
        else:
            self.train_dataloader = None
            iters_per_epoch = 1

        self.train_by_epoch = epochs is not None
        if epochs is not None:
            self.iters = epochs * iters_per_epoch
        else:
            self.iters = iters or 0
        self.cur_iter = 0

        self.scheduler = Scheduler(
            save_interval=save_interval, log_interval=log_interval,
            do_eval=do_eval, train_by_epoch=self.train_by_epoch,
            iters_per_epoch=iters_per_epoch)
        self.checkpoint = Checkpoint(
            save_dir=os.path.join(save_dir, "checkpoints"),
            keep_checkpoint_max=keep_checkpoint_max)
        self.summary = (ScalarWriter(os.path.join(save_dir, "logs"))
                        if process_index() == 0 else None)

        self.ema_params = init_ema(model) if ema_decay is not None else None

        amp_cfg = dict(amp_cfg or {})
        amp_level = amp_cfg.get("level") if amp_cfg.get("use_amp") else None
        self._train_step = make_train_step(
            grad_clip_norm=grad_clip_norm, ema_decay=ema_decay,
            amp_level=amp_level, lr_scheduler=lr_scheduler)
        self._eval_step = make_eval_step()
        self.timer = None

        if resume and not self.checkpoint.empty:
            self._resume()

    # ---------------------------------------------------------------- resume
    def _resume(self):
        model, opt, sched, ema = self.checkpoint.get()
        # load copies: an optimizer keeps the state tensors it is given
        if model is not None:
            self.model.load_state_dict(model)
        if opt is not None:
            self.optimizer.load_state_dict(copy.deepcopy(opt))
        if sched is not None and self.lr_scheduler is not None:
            self.lr_scheduler.load_state_dict(sched)
        if ema is not None and self.ema_params is not None:
            with torch.no_grad():
                for k, v in ema.items():
                    self.ema_params[k].copy_(v)
        # reference contract (apis/trainer.py:217-221): refuse to resume a
        # run whose epoch/iter training mode differs from the checkpoint's
        saved_mode = self.checkpoint.get_record("train_by_epoch", None)
        if saved_mode is not None and bool(saved_mode) != self.train_by_epoch:
            raise RuntimeError(
                "Unable to resume: checkpoint was trained by {} but this "
                "run trains by {} (reference trainer.py:217-221)".format(
                    "epoch" if saved_mode else "iter",
                    "epoch" if self.train_by_epoch else "iter"))
        self.cur_iter = int(self.checkpoint.get_record("iters", 0))
        self.scheduler.cur_iter = self.cur_iter
        self.ema_step = int(self.checkpoint.get_record("ema_step",
                                                       self.cur_iter))
        # summary continuity: the log dir persists in the checkpoint meta
        # so that scalars append across a resume
        if self.summary is not None:
            logdir = self.checkpoint.get_record("summary_dir", None)
            if logdir and os.path.isdir(logdir):
                self.summary = ScalarWriter(logdir)
        logger.info("Resumed from iteration {}".format(self.cur_iter))

    # ----------------------------------------------------------------- train
    def train(self):
        if self.train_dataloader is None:
            raise RuntimeError("No train_dataset provided")
        self.model.train()
        timer = self.timer = Timer(iters=self.iters)
        while self.cur_iter < self.iters:
            batches = iter(self.train_dataloader)
            while self.cur_iter < self.iters:
                timer.before_reader()
                item = next(batches, None)
                timer.after_reader()
                if item is None:
                    break
                batch, _ = item
                dev_batch = to_device(batch, self.device)

                if self.ema_decay is not None:
                    losses, self.ema_params = self._train_step(
                        self.model, self.optimizer, self.ema_params,
                        dev_batch, self._ema_decay_now())
                else:
                    losses = self._train_step(self.model, self.optimizer,
                                              dev_batch)
                self.cur_iter += 1
                timer.step(self.batch_size)
                status = self.scheduler.step()

                if status.do_log:
                    self._log(losses, timer)
                if status.save_checkpoint:
                    self._save_checkpoint()
                    if status.do_eval and self.val_dataset is not None:
                        metrics = self.evaluate(use_ema=True)
                        logger.info("[EVAL] iter={} {}".format(
                            self.cur_iter, metrics))
                        if self.summary is not None:
                            for k, v in metrics.items():
                                if isinstance(v, (int, float)):
                                    self.summary.add_scalar(
                                        "eval/{}".format(k), v,
                                        self.cur_iter)
            batches.close()
        # final checkpoint
        self._save_checkpoint()

    def _log(self, losses: dict, timer: Timer):
        host_losses = {k: float(v) for k, v in losses.items()}
        if self.summary is not None:
            for k, v in host_losses.items():
                self.summary.add_scalar("train/{}".format(k), v,
                                        self.cur_iter)
            self.summary.add_scalar("train/ips", timer.ips, self.cur_iter)
        # device memory telemetry (reference logs max_memory_reserved /
        # allocated, trainer.py:384-388)
        if self.device.type == "cuda":
            logger.info("[MEM] device allocated={:.1f}MB peak={:.1f}MB".format(
                torch.cuda.memory_allocated(self.device) / 2 ** 20,
                torch.cuda.max_memory_allocated(self.device) / 2 ** 20))
        msg = " ".join("{}={:.4f}".format(k, v)
                       for k, v in sorted(host_losses.items()))
        logger.info("[TRAIN] iter={}/{} {} ips={:.2f} reader={:.4f}s "
                    "eta={}".format(self.cur_iter, self.iters, msg,
                                    timer.ips, timer.reader_cost, timer.eta))

    def _save_checkpoint(self):
        tag = "iter_{}".format(self.cur_iter)
        self.checkpoint.record("iters", self.cur_iter)
        self.checkpoint.record("train_by_epoch", self.train_by_epoch)
        self.checkpoint.record("ema_step", self.ema_step)
        if self.summary is not None:
            self.checkpoint.record("summary_dir",
                                   os.path.join(self.save_dir, "logs"))
        self.checkpoint.push(
            tag, self.model.state_dict(),
            opt_state=self.optimizer.state_dict(),
            sched_state=(self.lr_scheduler.state_dict()
                         if self.lr_scheduler is not None else None),
            ema_state=self.ema_params)
        logger.info("Saved checkpoint {}".format(tag))

    # ------------------------------------------------------------------ eval
    @staticmethod
    def pad_batch(batch: dict, batch_size: int) -> dict:
        """Zero-pad every leading-batch-dim array, in the batch and in the
        dicts in it, to the fixed batch size (model-agnostic, as the
        reference's eval). Zeros, not NaN; eval runs BatchNorm on its
        running averages anyway."""
        n = None
        for v in batch.values():
            if isinstance(v, np.ndarray) and v.ndim >= 1:
                n = v.shape[0]
                break
        if n is None or n >= batch_size:
            return batch

        def _pad(x):
            if isinstance(x, dict):
                return {k: _pad(v) for k, v in x.items()}
            if not isinstance(x, np.ndarray) or x.ndim == 0 \
                    or x.shape[0] != n:
                return x
            width = [(0, batch_size - n)] + [(0, 0)] * (x.ndim - 1)
            return np.pad(x, width)

        return _pad(batch)

    def _ema_decay_now(self) -> float:
        """This iteration's decay by the reference schedule
        (utils/ema.py:118-121), with the cycle reset: at every
        `cycle_epoch` epochs the average restarts from the live
        parameters."""
        step = self.ema_step
        self.ema_step += 1
        if self.ema_cycle_epoch > 0:
            iters_per_cycle = (self.scheduler.iters_per_epoch *
                               self.ema_cycle_epoch)
            if step and step % iters_per_cycle == 0:
                self.ema_params = init_ema(self.model)
                self.ema_step = 1
                step = 0
        if self.ema_decay_type == "threshold":
            return min(self.ema_decay, (1 + step) / (10 + step))
        if self.ema_decay_type == "exponential":
            return self.ema_decay * (1 - math.exp(-(step + 1) / 2000))
        return self.ema_decay

    def evaluate(self, use_ema: bool = False) -> dict:
        """Serve the val dataset through the eval step and its metric:
        model.eval() (BatchNorm on its running averages) for the run, the
        EMA weights in place of the live ones with use_ema, both put back
        after. -> the metric's dict."""
        if self.val_dataset is None:
            raise RuntimeError("No val_dataset provided")
        loader = DataLoader(
            self.val_dataset, batch_size=self.batch_size, shuffle=False,
            drop_last=False)
        metric_obj = self.val_dataset.metric

        backup = None
        if use_ema and self.ema_params is not None:
            backup = swap_in(self.model, self.ema_params)
        self.model.eval()
        try:
            for batch, metas in loader:
                # pad partial batches to the fixed batch size, so that the
                # device program sees one shape
                n = len(metas)
                batch = self.pad_batch(batch, self.batch_size)
                outputs = self._eval_step(self.model,
                                          to_device(batch, self.device))
                # back to the host, the padded samples dropped
                outputs = {k: v.cpu().numpy()[:n] if v.ndim else
                           v.cpu().numpy() for k, v in outputs.items()}
                samples = self.model.postprocess_to_samples(outputs, metas)
                metric_obj.update(samples)
        finally:
            self.model.train()
            if backup is not None:
                swap_in(self.model, backup)
        return metric_obj.compute(verbose=True)
