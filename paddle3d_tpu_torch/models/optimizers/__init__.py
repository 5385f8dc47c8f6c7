from .optimizers import Adam, ClipGradByGlobalNorm, StepDecay
