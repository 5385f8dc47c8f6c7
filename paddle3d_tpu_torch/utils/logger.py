"""Logging, a copy of paddle3d_tpu/utils/logger.py: a plain-Python logger
with levels, optional file output and progress helpers, gated so that only
rank 0 prints: torch.distributed's rank when a process group is
initialised, else 0.
"""
import contextlib
import logging
import os
import sys
import time

__all__ = ["Logger", "logger", "process_index"]


def process_index() -> int:
    """torch.distributed's rank when a process group is initialised, else
    0."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class Logger:
    def __init__(self, name: str = "paddle3d_tpu_torch.runtime",
                 output: str = None):
        self._logger = logging.getLogger(name)
        self._logger.setLevel(logging.INFO)
        self._logger.propagate = False
        if not self._logger.handlers:
            handler = logging.StreamHandler(sys.stdout)
            handler.setFormatter(
                logging.Formatter("%(asctime)s [%(levelname)s]\t%(message)s",
                                  "%m/%d %H:%M:%S"))
            self._logger.addHandler(handler)
        if output is not None:
            self.add_file_handler(output)

    def add_file_handler(self, output: str):
        os.makedirs(os.path.dirname(os.path.abspath(output)), exist_ok=True)
        handler = logging.FileHandler(output)
        handler.setFormatter(
            logging.Formatter("%(asctime)s [%(levelname)s]\t%(message)s",
                              "%m/%d %H:%M:%S"))
        self._logger.addHandler(handler)

    def _log(self, level, msg):
        if process_index() != 0:
            return
        self._logger.log(level, msg)

    def debug(self, msg):
        self._log(logging.DEBUG, msg)

    def info(self, msg):
        self._log(logging.INFO, msg)

    def warning(self, msg):
        self._log(logging.WARNING, msg)

    def error(self, msg):
        self._log(logging.ERROR, msg)

    @contextlib.contextmanager
    def processing(self, msg: str, interval: float = 0.1):
        """Log msg before a long host-side task."""
        self.info(msg + "...")
        yield

    @contextlib.contextmanager
    def progressbar(self, msg: str, total: int = None):
        self.info(msg)
        state = {"n": 0, "total": total, "t0": time.time()}

        def update(n=1):
            state["n"] += n

        yield update
        dt = time.time() - state["t0"]
        self.info("{} done ({} items, {:.1f}s)".format(msg, state["n"], dt))

    def enumerate(self, iterable, msg: str = ""):
        try:
            total = len(iterable)
        except TypeError:
            total = None
        t0 = time.time()
        for i, item in enumerate(iterable):
            yield i, item
            if total and (i + 1) % max(1, total // 10) == 0:
                self.info("{} [{}/{}] {:.1f}s".format(msg, i + 1, total,
                                                      time.time() - t0))


logger = Logger()
