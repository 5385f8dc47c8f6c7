from .optimizers import (Adam, ClipGradByGlobalNorm, OneCycleAdam,
                         OneCycleDecayWarmupMomentum, OneCycleWarmupDecayLr,
                         StepDecay)
