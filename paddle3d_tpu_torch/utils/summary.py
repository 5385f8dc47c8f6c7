"""Training scalar logging, torch port of paddle3d_tpu/utils/summary.py
(the reference logs through VisualDL).

Writes JSONL scalars. The JAX writer also writes TensorBoard events when
torch.utils.tensorboard or tensorboardX imports; the port does not: that
import pulls in TensorFlow where it is installed, seconds a process.
"""
import json
import os
import time

__all__ = ["ScalarWriter"]


class ScalarWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int):
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "ts": time.time()}) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()
