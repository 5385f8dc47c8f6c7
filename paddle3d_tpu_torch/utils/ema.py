"""Model EMA, torch port of paddle3d_tpu/utils/ema.py.

The shadow covers the parameters only, as the JAX package's covers
`nnx.Param` (BatchNorm running statistics are not averaged): a dict
{parameter name: tensor}. The train step updates it after each optimizer
step (apis/pipeline.make_train_step(ema_decay=...)), with the decay that
`apis.Trainer._ema_decay_now` gives by the reference's schedules; the JAX
module's SimpleModelEMA / ModelEMA objects have no counterpart here.
"""
import torch

__all__ = ["init_ema", "update_ema", "swap_in"]


def init_ema(model) -> dict:
    """A detached copy of every parameter, by name."""
    return {k: p.detach().clone() for k, p in model.named_parameters()}


@torch.no_grad()
def update_ema(ema: dict, model, decay: float) -> dict:
    """ema <- decay * ema + (1 - decay) * param, in place, as the JAX step's
    `d * e + (1.0 - d) * p`."""
    for k, p in model.named_parameters():
        ema[k].copy_(decay * ema[k] + (1.0 - decay) * p)
    return ema


@torch.no_grad()
def swap_in(model, params: dict) -> dict:
    """Copy params into the model's parameters; -> a copy of the ones they
    replaced (for the swap back)."""
    backup = init_ema(model)
    for k, p in model.named_parameters():
        p.copy_(params[k])
    return backup
