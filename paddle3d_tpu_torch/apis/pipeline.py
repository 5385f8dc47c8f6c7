"""Train and eval steps, torch port of paddle3d_tpu/apis/pipeline.py
(parse_losses, make_train_step with its EMA, make_eval_step).

PyTorch runs eagerly, so the step is a plain function: zero the grads,
train_forward, backward (a parameter the loss does not reach gets a zero
gradient), the optional extra global-norm clip, the optimizer step (its
config clip runs first, as a pre-hook), the scheduler step and, with an
EMA, the shadow's update. f32 only for now.
"""
from typing import Callable, Optional

import torch

from ..utils.ema import update_ema

__all__ = ["parse_losses", "make_train_step", "make_eval_step"]


def parse_losses(losses) -> torch.Tensor:
    """dict | tensor -> the total scalar (key 'loss' if present)."""
    if isinstance(losses, dict):
        if "loss" in losses:
            return losses["loss"]
        return sum(losses.values())
    return losses


def make_train_step(grad_clip_norm: Optional[float] = None,
                    ema_decay: Optional[float] = None,
                    amp_level: Optional[str] = None,
                    lr_scheduler=None) -> Callable:
    """Build the train step `step(model, optimizer, batch) -> loss dict`
    (detached; a train_forward that returns a bare tensor gives
    {"loss": it}); the model and optimizer update in place, and
    `lr_scheduler`, if given, steps once after the optimizer.

    With `ema_decay` the step is `step(model, optimizer, ema, batch,
    decay=None) -> (loss dict, ema)`, as the JAX package's: after the
    optimizer step, every parameter's shadow in the dict `ema`
    (`utils.ema.init_ema`) becomes decay * ema + (1 - decay) * param, in
    place, with `decay` the step's rate (the Trainer's schedule) or
    `ema_decay`. The shadow covers parameters only, as the JAX one covers
    nnx.Param: running statistics are not averaged.

    grad_clip_norm clips the global grad norm on top of the optimizer's own
    clip, as the JAX step does: g * min(1, clip / (norm + 1e-6))."""
    if amp_level in ("O1", "O2"):
        raise NotImplementedError(
            "bf16 AMP is not ported: the port trains in f32 (bf16 and AMP "
            "O1 / O2 arrive with ROADMAP.md, queue 1, item 15)")
    def train_step(model, optimizer, batch) -> dict:
        optimizer.zero_grad(set_to_none=True)
        losses = model.train_forward(batch)
        if not isinstance(losses, dict):
            losses = {"loss": losses}
        parse_losses(losses).backward()
        # every parameter gets a gradient, zero where the loss does not
        # reach it (the two-stage RPN's direction head), as nnx.grad gives
        # one: decoupled weight decay then moves it as optax.adamw does
        for p in model.parameters():
            if p.grad is None and p.requires_grad:
                p.grad = torch.zeros_like(p)
        if grad_clip_norm is not None:
            grads = [p.grad for p in model.parameters()
                     if p.grad is not None]
            with torch.no_grad():
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
                scale = torch.clamp(grad_clip_norm / (norm + 1e-6), max=1.0)
                for g in grads:
                    g.mul_(scale)
        optimizer.step()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return {k: v.detach() for k, v in losses.items()}

    if ema_decay is None:
        return train_step

    def train_step_ema(model, optimizer, ema, batch, decay=None):
        losses = train_step(model, optimizer, batch)
        update_ema(ema, model, ema_decay if decay is None else decay)
        return losses, ema

    return train_step_ema


def make_eval_step() -> Callable:
    """step(model, batch) -> the model's fixed-shape predictions
    (`test_forward`, without autograd; reference: pipeline.py:119
    validation_step). The model must be in eval mode."""

    @torch.no_grad()
    def eval_step(model, batch):
        return model.test_forward(batch)

    return eval_step
