from .optimizers import (Adam, AdamW, ClipGradByGlobalNorm, CosineDecay,
                         OneCycleAdam,
                         OneCycleDecayWarmupMomentum, OneCycleWarmupDecayLr,
                         PiecewiseDecay, StepDecay)
