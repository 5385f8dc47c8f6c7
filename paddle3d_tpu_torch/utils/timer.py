"""Training timer with ips and ETA, a copy of paddle3d_tpu/utils/timer.py.

`before_reader` / `after_reader` bracket the wait for the next batch;
`reader_cost` is its mean a step (the JAX timer sums it and shows no mean).
"""
import time

__all__ = ["Timer"]


class Timer:
    def __init__(self, iters: int = 0):
        self.iters = iters
        self.cur_iter = 0
        self._start = time.time()
        self._last = self._start
        self._reader_cost = 0.
        self._batch_cost_sum = 0.
        self._reader_cost_sum = 0.
        self._count = 0

    def step(self, num_samples: int = 1):
        now = time.time()
        self._batch_cost_sum += now - self._last
        self._last = now
        self.cur_iter += 1
        self._count += num_samples

    def before_reader(self):
        self._reader_t0 = time.time()

    def after_reader(self):
        self._reader_cost_sum += time.time() - getattr(
            self, "_reader_t0", time.time())

    @property
    def ips(self) -> float:
        if self._batch_cost_sum == 0:
            return 0.
        return self._count / self._batch_cost_sum

    @property
    def reader_cost(self) -> float:
        """Mean seconds a step spent waiting for its batch."""
        if self.cur_iter == 0:
            return 0.
        return self._reader_cost_sum / self.cur_iter

    @property
    def eta(self) -> str:
        if self.cur_iter == 0 or self.iters == 0:
            return "--:--:--"
        remaining = (self.iters - self.cur_iter) * (
            self._batch_cost_sum / self.cur_iter)
        h, rem = divmod(int(remaining), 3600)
        m, s = divmod(rem, 60)
        return "{:02d}:{:02d}:{:02d}".format(h, m, s)

    @property
    def speed(self) -> float:
        """Average seconds per iteration."""
        if self.cur_iter == 0:
            return 0.
        return self._batch_cost_sum / self.cur_iter

    def reset(self):
        self._batch_cost_sum = 0.
        self._reader_cost_sum = 0.
        self._count = 0
        self._last = time.time()
