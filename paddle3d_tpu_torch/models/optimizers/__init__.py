from .optimizers import (Adam, ClipGradByGlobalNorm, OneCycleAdam,
                         OneCycleDecayWarmupMomentum, OneCycleWarmupDecayLr,
                         PiecewiseDecay, StepDecay)
