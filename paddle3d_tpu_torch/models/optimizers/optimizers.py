"""Optimizer, gradient-clip and LR-schedule components, torch port of
paddle3d_tpu/models/optimizers/optimizers.py (ClipGradByGlobalNorm, Adam,
StepDecay).

The JAX package builds optax transformations; torch builds an optimizer
over parameters, which a YAML config does not have. So `Adam` returns a
builder that Config.optimizer applies to the model's parameters, and a
schedule is a plain object (lr = learning_rate * factor(step)) that
Config.lr_scheduler turns into a torch LambdaLR over that optimizer. Clip,
Adam and schedule leave the parameters where optax's chain
(clip_by_global_norm -> adam(w) with the schedule read at the update count)
leaves them.
"""
import torch

from ...apis import manager

__all__ = ["ClipGradByGlobalNorm", "Adam", "StepDecay"]


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


@manager.OPTIMIZERS.add_component
def Adam(learning_rate=1e-3, beta1: float = 0.9, beta2: float = 0.999,
         epsilon: float = 1e-8, weight_decay: float = 0.0,
         grad_clip: ClipGradByGlobalNorm = None):
    """-> build(params) -> torch optimizer. A nonzero weight_decay is
    decoupled decay over every parameter (paddle's Adam with weight decay,
    optax.adamw without a mask), so torch's AdamW, not Adam's L2 term.
    `learning_rate` is a float or a schedule, whose base rate it starts
    at. The clip runs as a step pre-hook, first in the chain as in
    optax."""
    lr = float(getattr(learning_rate, "learning_rate", learning_rate))

    def build(params):
        kw = dict(lr=lr, betas=(beta1, beta2), eps=epsilon)
        if weight_decay:
            opt = torch.optim.AdamW(params, weight_decay=weight_decay, **kw)
        else:
            opt = torch.optim.Adam(params, **kw)
        if grad_clip is not None:
            opt.register_step_pre_hook(lambda o, args, kwargs: grad_clip(
                p.grad for group in o.param_groups for p in group["params"]
                if p.grad is not None))
        return opt

    return build
