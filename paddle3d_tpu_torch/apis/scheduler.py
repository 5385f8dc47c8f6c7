"""Interval scheduler, a copy of paddle3d_tpu/apis/scheduler.py
(reference: paddle3d/apis/scheduler.py:19-78).

Same contract: `step()` returns (do_eval, do_log, save_checkpoint) flags on
the reference cadence, by iteration or by epoch.
"""
from collections import namedtuple

SchedulerStatus = namedtuple("SchedulerStatus",
                             ["do_eval", "do_log", "save_checkpoint"])


class Scheduler:
    def __init__(self,
                 save_interval: int = 1000,
                 log_interval: int = 10,
                 do_eval: bool = False,
                 train_by_epoch: bool = False,
                 iters_per_epoch: int = 1):
        if save_interval < 0:
            raise ValueError("save_interval must be >= 0")
        if log_interval < 0:
            raise ValueError("log_interval must be >= 0")
        self.save_interval = save_interval
        self.log_interval = log_interval
        self.eval_enabled = do_eval
        self.train_by_epoch = train_by_epoch
        self.iters_per_epoch = iters_per_epoch
        self.cur_iter = 0

    def step(self, count: int = 1) -> SchedulerStatus:
        self.cur_iter += count
        if self.train_by_epoch:
            end_of_epoch = self.cur_iter % self.iters_per_epoch == 0
            epoch = self.cur_iter // self.iters_per_epoch
            save = (self.save_interval > 0 and end_of_epoch
                    and epoch % self.save_interval == 0)
            log = (self.log_interval > 0
                   and self.cur_iter % self.log_interval == 0)
        else:
            save = (self.save_interval > 0
                    and self.cur_iter % self.save_interval == 0)
            log = (self.log_interval > 0
                   and self.cur_iter % self.log_interval == 0)
        do_eval = save and self.eval_enabled
        return SchedulerStatus(do_eval, log, save)
