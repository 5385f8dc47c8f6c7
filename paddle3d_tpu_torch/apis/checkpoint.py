"""Rolling-queue checkpoint store, torch port of paddle3d_tpu/apis/checkpoint.py
(reference: paddle3d/apis/checkpoint.py:83).

The same contract: a directory a tag in a bounded queue (eviction past
`keep_checkpoint_max`), `meta.yaml` for the queue and the records, written
under a lock file, `push / pop / get / record`, `best_model` a link to the
newest tag, and writes on rank 0 only (torch.distributed's rank when a
process group is initialised).

The payloads are torch state dicts, one file each: the model (parameters
and buffers, the BatchNorm running statistics among them), the optimizer
(its moments and param groups), the LR schedule and the EMA shadow. They
are not interchangeable with the JAX package's msgpack files, which hold
flax states (and, from its Trainer, the parameters only).
"""
import contextlib
import os
import shutil
import time
from typing import Optional

import torch
import yaml

from ..utils.logger import process_index

__all__ = ["Checkpoint"]


@contextlib.contextmanager
def _file_lock(path: str, timeout: float = 60.0, stale_age: float = 300.0):
    """Tiny cross-process lock via atomic O_EXCL create
    (replaces the reference's `filelock` dependency).

    A lock is only stolen when its file is older than `stale_age` (a live
    writer refreshes nothing, but 5 min far exceeds any meta write); stealing
    removes the stale file and re-creates the lock atomically, and the
    finally-clause removes the lock only if this process created it."""
    lock = path + ".lock"
    deadline = time.time() + timeout
    acquired = False
    while not acquired:
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
            acquired = True
        except FileExistsError:
            try:
                age = time.time() - os.path.getmtime(lock)
            except OSError:
                continue  # holder released between open and stat — retry
            if age > stale_age:
                # stale: remove and retry the atomic create (another waiter
                # may win the race; that's fine)
                try:
                    os.remove(lock)
                except FileNotFoundError:
                    pass
                continue
            if time.time() > deadline:
                raise TimeoutError(
                    "could not acquire checkpoint lock {} within {}s "
                    "(held by a live process)".format(lock, timeout))
            time.sleep(0.05)
    try:
        yield
    finally:
        try:
            os.remove(lock)
        except FileNotFoundError:
            pass


class Checkpoint:
    PARAMS_FILE = "model.pt"
    OPT_FILE = "optimizer.pt"
    SCHED_FILE = "lr_scheduler.pt"
    EMA_FILE = "model_ema.pt"
    META_FILE = "meta.yaml"

    def __init__(self, save_dir: str, keep_checkpoint_max: int = 5):
        self.save_dir = save_dir
        self.keep_checkpoint_max = max(1, int(keep_checkpoint_max))
        self._meta_path = os.path.join(save_dir, self.META_FILE)
        if self._rank0:
            os.makedirs(save_dir, exist_ok=True)
        self._meta = self._load_meta()
        self._meta.setdefault("queue", [])
        self._meta.setdefault("records", {})

    @property
    def _rank0(self) -> bool:
        return process_index() == 0

    def _load_meta(self) -> dict:
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                return yaml.safe_load(f) or {}
        return {}

    def _save_meta(self):
        with _file_lock(self._meta_path):
            with open(self._meta_path, "w") as f:
                yaml.safe_dump(self._meta, f)

    @property
    def empty(self) -> bool:
        return len(self._meta["queue"]) == 0

    @property
    def queue(self):
        return list(self._meta["queue"])

    def have(self, tag: str) -> bool:
        return tag in self._meta["queue"]

    def record(self, key: str, value):
        """Arbitrary KV persisted in meta (reference: checkpoint.py:238)."""
        self._meta["records"][key] = value
        if self._rank0:
            self._save_meta()

    def get_record(self, key: str, default=None):
        return self._meta["records"].get(key, default)

    def push(self, tag: str, model_state: dict, opt_state: dict = None,
             sched_state: dict = None, ema_state: dict = None):
        """Save a checkpoint's state dicts and evict past
        keep_checkpoint_max (reference: checkpoint.py:148)."""
        if not self._rank0:
            return
        tag = str(tag)
        tag_dir = os.path.join(self.save_dir, tag)
        os.makedirs(tag_dir, exist_ok=True)
        for fname, state in ((self.PARAMS_FILE, model_state),
                             (self.OPT_FILE, opt_state),
                             (self.SCHED_FILE, sched_state),
                             (self.EMA_FILE, ema_state)):
            if state is not None:
                torch.save(state, os.path.join(tag_dir, fname))

        if tag in self._meta["queue"]:
            self._meta["queue"].remove(tag)
        self._meta["queue"].append(tag)
        while len(self._meta["queue"]) > self.keep_checkpoint_max:
            evict = self._meta["queue"].pop(0)
            shutil.rmtree(os.path.join(self.save_dir, evict),
                          ignore_errors=True)
        # "best_model" mirrors the latest, matching the reference's admitted
        # latest-as-best behavior (checkpoint.py:179-195).
        best = os.path.join(self.save_dir, "best_model")
        if os.path.islink(best) or os.path.exists(best):
            try:
                os.remove(best)
            except IsADirectoryError:
                shutil.rmtree(best)
        os.symlink(tag, best)
        self._save_meta()

    def pop(self) -> Optional[str]:
        """Drop the oldest checkpoint (reference: checkpoint.py:214)."""
        if self.empty:
            return None
        evict = self._meta["queue"].pop(0)
        if self._rank0:
            shutil.rmtree(os.path.join(self.save_dir, evict),
                          ignore_errors=True)
            self._save_meta()
        return evict

    def get(self, tag: str = None):
        """-> (model, optimizer, LR schedule, EMA) state dicts of a tag, the
        newest by default, on the CPU; None for a file the tag lacks."""
        if tag is None:
            if self.empty:
                raise RuntimeError("Checkpoint queue is empty")
            tag = self._meta["queue"][-1]
        tag_dir = os.path.join(self.save_dir, str(tag))

        def _load(fname):
            path = os.path.join(tag_dir, fname)
            if not os.path.exists(path):
                return None
            return torch.load(path, map_location="cpu", weights_only=True)

        return tuple(_load(f) for f in (self.PARAMS_FILE, self.OPT_FILE,
                                        self.SCHED_FILE, self.EMA_FILE))
