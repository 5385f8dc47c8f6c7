"""Optimizer, gradient-clip and LR-schedule components, torch port of
paddle3d_tpu/models/optimizers/optimizers.py (ClipGradByGlobalNorm, Adam,
AdamW, SGD, OneCycleAdam with OneCycleDecayWarmupMomentum, AdamWOnecycle,
StepDecay, PiecewiseDecay, OneCycleWarmupDecayLr, OneCycle, CosineDecay,
LinearWarmup).

The JAX package builds optax transformations; torch builds an optimizer
over parameters, which a YAML config does not have. So `Adam` returns a
builder that Config.optimizer applies to the model's parameters, and a
schedule is a plain object (lr = learning_rate * factor(step)) that
Config.lr_scheduler turns into a torch LambdaLR over that optimizer. Clip,
Adam and schedule leave the parameters where optax's chain
(clip_by_global_norm -> adam(w) with the schedule read at the update count)
leaves them. OneCycleAdam's cycled beta1 is read at the update count too:
a step pre-hook sets it in the param groups before each update.
"""
import math

import torch

from ...apis import manager

__all__ = ["ClipGradByGlobalNorm", "Adam", "AdamW", "SGD", "OneCycleAdam",
           "AdamWOnecycle", "OneCycleDecayWarmupMomentum", "StepDecay",
           "PiecewiseDecay", "OneCycleWarmupDecayLr", "OneCycle",
           "CosineDecay", "LinearWarmup"]


@manager.OPTIMIZERS.add_component
class ClipGradByGlobalNorm:
    """optax.clip_by_global_norm: when the global norm of the gradients
    reaches clip_norm, scale every one by clip_norm / norm (in place)."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def __call__(self, grads):
        grads = list(grads)
        if not grads:
            return
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.clip_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.clip_norm))


def _clip(grad_clip_norm, grad_clip):
    """The JAX package's _clip_tx: grad_clip_norm (a float) wins; else
    grad_clip, a dict {"clip_norm": N} or a built ClipGradByGlobalNorm."""
    if grad_clip_norm is not None:
        return ClipGradByGlobalNorm(grad_clip_norm)
    if isinstance(grad_clip, dict):
        return ClipGradByGlobalNorm(grad_clip["clip_norm"])
    return grad_clip


def _clipped(opt, clip):
    """Run the clip as a step pre-hook: first in the chain, as in optax."""
    if clip is not None:
        opt.register_step_pre_hook(lambda o, args, kwargs: clip(
            p.grad for group in o.param_groups for p in group["params"]
            if p.grad is not None))
    return opt


def _base_rate(learning_rate) -> float:
    """A float, or a schedule's base rate (the rate it starts at)."""
    return float(getattr(learning_rate, "learning_rate", learning_rate))


@manager.LR_SCHEDULERS.add_component
class StepDecay:
    """lr = learning_rate * gamma ** (step // step_size) (paddle
    StepDecay); step counts optimizer updates from 0."""

    def __init__(self, learning_rate: float, step_size: int,
                 gamma: float = 0.1):
        self.learning_rate = float(learning_rate)
        self.step_size = int(step_size)
        self.gamma = float(gamma)

    def factor(self, step: int) -> float:
        """lr(step) / learning_rate."""
        return self.gamma ** (step // self.step_size)


@manager.LR_SCHEDULERS.add_component
class PiecewiseDecay:
    """lr = values[0] times the ratio values[i + 1] / values[i] of every
    boundary i the step has reached (from the boundary step on), as the JAX
    package builds optax.piecewise_constant_schedule from paddle's
    PiecewiseDecay; step counts optimizer updates from 0."""

    def __init__(self, boundaries, values):
        if len(values) != len(boundaries) + 1:
            raise ValueError("PiecewiseDecay takes one value more than "
                             "boundaries, got {} and {}".format(
                                 len(values), len(boundaries)))
        self.boundaries = [int(b) for b in boundaries]
        self.ratios = [values[i + 1] / values[i]
                       for i in range(len(boundaries))]
        self.learning_rate = float(values[0])

    def factor(self, step: int) -> float:
        """lr(step) / learning_rate."""
        f = 1.0
        for b, ratio in sorted(zip(self.boundaries, self.ratios)):
            if step >= b:
                f *= ratio
        return f


@manager.LR_SCHEDULERS.add_component
class CosineDecay:
    """optax.cosine_decay_schedule(learning_rate, total_step, alpha =
    eta_min / learning_rate): lr = learning_rate · ((1 - alpha) · (1 +
    cos(pi · min(step, total_step) / total_step)) / 2 + alpha), eta_min
    from total_step on; step counts optimizer updates from 0."""

    def __init__(self, learning_rate: float, total_step: int,
                 eta_min: float = 0.0):
        if total_step <= 0:
            raise ValueError("CosineDecay needs total_step > 0")
        self.learning_rate = float(learning_rate)
        self.total_step = int(total_step)
        self.alpha = eta_min / max(self.learning_rate, 1e-12)

    def factor(self, step: int) -> float:
        """lr(step) / learning_rate."""
        count = min(step, self.total_step)
        cosine = 0.5 * (1 + math.cos(math.pi * count / self.total_step))
        return (1 - self.alpha) * cosine + self.alpha


def _rate_at(schedule, step: int) -> float:
    """The rate of a float or of a schedule object at update `step`."""
    if isinstance(schedule, (int, float)):
        return float(schedule)
    return schedule.learning_rate * schedule.factor(step)


@manager.LR_SCHEDULERS.add_component
class LinearWarmup:
    """A linear warm-up from start_lr to the wrapped schedule's rate at
    update 0 (or to end_lr, which then replaces the schedule by that
    constant) over the first warmup_steps updates, then the wrapped
    schedule, read at the update count itself (not shifted by the
    warm-up), as the JAX package's LinearWarmup; `learning_rate` is a
    float or a built schedule (a YAML's nested `{type: StepDecay, ...}`).
    Its base rate is the wrapped schedule's."""

    def __init__(self, learning_rate, warmup_steps: int = 1000,
                 start_lr: float = 0., end_lr: float = None):
        self.base = learning_rate if end_lr is None else float(end_lr)
        self.peak = _rate_at(self.base, 0)
        self.warmup_steps = int(warmup_steps)
        self.start_lr = float(start_lr)
        self.learning_rate = _base_rate(self.base)
        if self.learning_rate == 0:
            raise ValueError("LinearWarmup needs a nonzero base rate")

    def __call__(self, step: int) -> float:
        """The rate at update `step`."""
        if step < self.warmup_steps:
            frac = min(step / max(self.warmup_steps, 1), 1.0)
            return self.start_lr + (self.peak - self.start_lr) * frac
        return _rate_at(self.base, step)

    def factor(self, step: int) -> float:
        """lr(step) / learning_rate."""
        return self(step) / self.learning_rate


class _CosineOneCycle:
    """optax.cosine_onecycle_schedule(total_step, peak, pct_start,
    div_factor, final_div_factor): a cosine from peak / div_factor up to
    peak over the first pct_start of total_step, then a cosine down to
    peak / (div_factor * final_div_factor) at total_step, flat after (optax's
    piecewise_interpolate_schedule over the cumulative scales)."""

    def __init__(self, total_step: int, peak: float, pct_start: float,
                 div_factor: float, final_div_factor: float):
        if total_step <= 0:
            raise ValueError("{} needs total_step > 0".format(
                type(self).__name__))
        init = peak / div_factor
        self.bounds = (0, int(pct_start * total_step), int(total_step))
        self.values = (init, init * div_factor,
                       init * div_factor / (div_factor * final_div_factor))
        self.learning_rate = init

    def __call__(self, step: int) -> float:
        for i in range(2):
            lo, hi = self.bounds[i], self.bounds[i + 1]
            if lo <= step < hi:
                start, end = self.values[i], self.values[i + 1]
                pct = (step - lo) / (hi - lo)
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct)
                                                    + 1)
        return self.values[-1]

    def factor(self, step: int) -> float:
        """lr(step) / learning_rate."""
        return self(step) / self.learning_rate


@manager.LR_SCHEDULERS.add_component
class OneCycleWarmupDecayLr(_CosineOneCycle):
    """The one-cycle cosine as the JAX package configures it from paddle's
    names: from base_learning_rate up to base · lr_ratio_peak over the first
    step_ratio_peak of total_step, then down to base · lr_ratio_trough."""

    def __init__(self, base_learning_rate: float, lr_ratio_peak: float = 10,
                 lr_ratio_trough: float = 0.0001,
                 step_ratio_peak: float = 0.4, total_step: int = 100000):
        super().__init__(total_step, base_learning_rate * lr_ratio_peak,
                         step_ratio_peak, lr_ratio_peak,
                         1.0 / lr_ratio_trough)


@manager.LR_SCHEDULERS.add_component
class OneCycle(_CosineOneCycle):
    """The one-cycle cosine on optax's names: peak `lr_max` (or
    `learning_rate`, the reference YAML's other name for it), warm-up over
    pct_start of total_step from peak / div_factor, down to peak /
    (div_factor · final_div_factor). `moms` (the cycled betas) belongs to
    the optimizer and is accepted for the YAML's sake."""

    def __init__(self, learning_rate: float = None, total_step: int = None,
                 pct_start: float = 0.4, div_factor: float = 10.0,
                 final_div_factor: float = 1e4, lr_max: float = None,
                 moms=None):
        del moms
        peak = float(lr_max if lr_max is not None else learning_rate)
        super().__init__(total_step, peak, pct_start, div_factor,
                         final_div_factor)


@manager.OPTIMIZERS.add_component
class OneCycleDecayWarmupMomentum:
    """Cycled beta1 for OneCycleAdam: from momentum_peak down to
    momentum_trough over the first step_ratio_peak of the cycle (the LR's
    warm-up), then back up to the peak."""

    def __init__(self, momentum_peak: float = 0.95,
                 momentum_trough: float = 0.85,
                 step_ratio_peak: float = 0.4):
        self.momentum_peak = float(momentum_peak)
        self.momentum_trough = float(momentum_trough)
        self.step_ratio_peak = float(step_ratio_peak)

    def schedule(self, total_step):
        """-> beta1(step); the constant peak when total_step is None."""
        peak, trough = self.momentum_peak, self.momentum_trough
        ratio = self.step_ratio_peak

        def b1(step):
            if total_step is None:
                return peak
            split = ratio * total_step
            if step < split:
                return peak - (peak - trough) * min(max(step / split, 0.), 1.)
            return trough + (peak - trough) * min(max(
                (step - split) / max(total_step - split, 1), 0.), 1.)
        return b1


def _update_count(opt) -> int:
    """Updates the optimizer has made (its state, so a restored state
    restores the count)."""
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state.get(p)
            if st and "step" in st:
                return int(st["step"])
    return 0


@manager.OPTIMIZERS.add_component
def Adam(learning_rate=1e-3, beta1: float = 0.9, beta2: float = 0.999,
         epsilon: float = 1e-8, weight_decay: float = 0.0,
         grad_clip_norm: float = None, grad_clip=None):
    """-> build(params) -> torch optimizer. A nonzero weight_decay is
    decoupled decay over every parameter (paddle's Adam with weight decay,
    optax.adamw without a mask), so torch's AdamW, not Adam's L2 term.
    `learning_rate` is a float or a schedule, whose base rate it starts
    at. The clip: grad_clip_norm, else grad_clip (a dict or a built
    ClipGradByGlobalNorm), as the JAX package's _clip_tx takes them."""
    lr = _base_rate(learning_rate)
    clip = _clip(grad_clip_norm, grad_clip)

    def build(params):
        kw = dict(lr=lr, betas=(beta1, beta2), eps=epsilon)
        if weight_decay:
            opt = torch.optim.AdamW(params, weight_decay=weight_decay, **kw)
        else:
            opt = torch.optim.Adam(params, **kw)
        return _clipped(opt, clip)

    return build


@manager.OPTIMIZERS.add_component
def AdamW(learning_rate=1e-3, weight_decay: float = 0.01, beta1: float = 0.9,
          beta2: float = 0.999, epsilon: float = 1e-8,
          grad_clip_norm: float = None, grad_clip=None):
    """-> build(params) -> torch.optim.AdamW: optax.adamw's decoupled decay
    over every parameter, the clip (grad_clip_norm, else grad_clip) first,
    as the JAX package chains them; `learning_rate` a float or a schedule,
    whose base rate it starts at."""
    lr = _base_rate(learning_rate)
    clip = _clip(grad_clip_norm, grad_clip)

    def build(params):
        return _clipped(torch.optim.AdamW(
            params, lr=lr, betas=(beta1, beta2), eps=epsilon,
            weight_decay=weight_decay), clip)

    return build


@manager.OPTIMIZERS.add_component
def SGD(learning_rate=1e-3, grad_clip_norm: float = None):
    """-> build(params) -> torch.optim.SGD: optax.sgd (no momentum), the
    clip first, as the JAX package chains them; `learning_rate` a float or
    a schedule, whose base rate it starts at."""
    lr = _base_rate(learning_rate)
    clip = _clip(grad_clip_norm, None)

    def build(params):
        return _clipped(torch.optim.SGD(params, lr=lr), clip)

    return build


@manager.OPTIMIZERS.add_component
def OneCycleAdam(learning_rate, total_step: int = None,
                 beta1_peak: float = 0.95, beta1_trough: float = 0.85,
                 beta2: float = 0.99, weight_decay: float = 0.01,
                 grad_clip_norm: float = 10.0, beta1=None, grad_clip=None):
    """One-cycle Adam: decoupled decay over every parameter (AdamW) with
    beta1 read at the update count from `beta1` (a
    OneCycleDecayWarmupMomentum or a float) or, by default, a triangle from
    beta1_peak down to beta1_trough at mid-cycle and back (the constant
    beta1_peak without total_step). An explicit grad_clip wins over
    grad_clip_norm."""
    lr = _base_rate(learning_rate)
    if isinstance(beta1, OneCycleDecayWarmupMomentum):
        b1_sched = beta1.schedule(total_step)
    elif isinstance(beta1, (int, float)):
        def b1_sched(step, b1=float(beta1)):
            return b1
    else:
        def b1_sched(step):
            if total_step is None:
                return beta1_peak
            frac = min(max(step / total_step, 0.), 1.)
            return beta1_peak - (beta1_peak - beta1_trough) * (
                1.0 - abs(2 * frac - 1.0))
    clip = _clip(None if grad_clip is not None else grad_clip_norm,
                 grad_clip)

    def build(params):
        opt = torch.optim.AdamW(params, lr=lr, betas=(b1_sched(0), beta2),
                                eps=1e-8, weight_decay=weight_decay)
        _clipped(opt, clip)

        def set_beta1(o, args, kwargs):
            b1 = b1_sched(_update_count(o))
            for group in o.param_groups:
                group["betas"] = (b1, group["betas"][1])
        opt.register_step_pre_hook(set_beta1)
        return opt

    return build


@manager.OPTIMIZERS.add_component
def AdamWOnecycle(learning_rate, total_step: int = None,
                  weight_decay: float = 0.01, grad_clip_norm: float = 10.0,
                  **kwargs):
    """OneCycleAdam under the reference configs' name (the PV-RCNN and
    Voxel-RCNN KITTI configs pair it with the OneCycle schedule)."""
    return OneCycleAdam(learning_rate, total_step=total_step,
                        weight_decay=weight_decay,
                        grad_clip_norm=grad_clip_norm, **kwargs)
