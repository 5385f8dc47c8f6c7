"""Weighted classification / regression losses, torch port of
paddle3d_tpu/models/losses/weighted_loss.py.

Stateless callables, registered in LOSSES so that YAML configs build them.
"""
import torch
import torch.nn.functional as F

from ...apis import manager

__all__ = [
    "SigmoidFocalClassificationLoss", "WeightedSmoothL1RegressionLoss",
    "WeightedSoftmaxClassificationLoss", "sigmoid_focal_loss",
    "smooth_l1_loss",
]


def sigmoid_focal_loss(logits, targets, gamma: float = 2.0,
                       alpha: float = 0.25):
    """Elementwise sigmoid focal CE; targets are {0,1} of logits' shape."""
    targets = targets.to(logits.dtype)
    ce = torch.clamp(logits, min=0) - logits * targets + torch.log1p(
        torch.exp(-torch.abs(logits)))
    prob = torch.sigmoid(logits)
    p_t = targets * prob + (1 - targets) * (1 - prob)
    mod = torch.pow(1.0 - p_t, gamma) if gamma else 1.0
    alpha_w = (targets * alpha + (1 - targets) *
               (1 - alpha)) if alpha is not None else 1.0
    return mod * alpha_w * ce


def smooth_l1_loss(pred, target, sigma: float = 3.0):
    """Elementwise smooth L1 with its transition at 1/sigma^2."""
    abs_diff = torch.abs(pred - target)
    lt = (abs_diff <= 1.0 / sigma**2).to(pred.dtype)
    return lt * 0.5 * (abs_diff * sigma)**2 + (1 - lt) * (
        abs_diff - 0.5 / sigma**2)


@manager.LOSSES.add_component
class SigmoidFocalClassificationLoss:
    def __init__(self, gamma: float = 2.0, alpha: float = 0.25):
        self.gamma = gamma
        self.alpha = alpha

    def __call__(self, prediction, target, weights):
        """prediction/target [B, A, C], weights [B, A] -> [B, A, C]."""
        loss = sigmoid_focal_loss(prediction, target, self.gamma, self.alpha)
        return loss * weights[..., None]


@manager.LOSSES.add_component
class WeightedSmoothL1RegressionLoss:
    def __init__(self, sigma: float = 3.0, code_weights=None,
                 codewise: bool = True):
        self.sigma = sigma
        self.code_weights = code_weights
        self.codewise = codewise

    def __call__(self, prediction, target, weights=None):
        pred, tgt = prediction, target
        if self.code_weights is not None:
            scale = torch.tensor(self.code_weights, dtype=prediction.dtype,
                                 device=prediction.device)
            pred, tgt = pred * scale, tgt * scale
        loss = smooth_l1_loss(pred, tgt, self.sigma)
        if self.codewise:
            return loss if weights is None else loss * weights[..., None]
        loss = torch.sum(loss, dim=-1)
        return loss if weights is None else loss * weights


@manager.LOSSES.add_component
class WeightedSoftmaxClassificationLoss:
    def __init__(self, logit_scale: float = 1.0):
        self.logit_scale = logit_scale

    def __call__(self, prediction, target, weights=None):
        """prediction [B, A, C] logits, target [B, A] int labels, weights
        [B, A] -> [B, A]. A gather where the JAX package takes a one-hot
        sum (a TPU workaround); both select the same log-probability."""
        logp = F.log_softmax(prediction / self.logit_scale, dim=-1)
        nll = -torch.gather(logp, -1, target.long()[..., None])[..., 0]
        return nll if weights is None else nll * weights
