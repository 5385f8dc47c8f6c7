from .optimizers import (SGD, Adam, AdamW, AdamWOnecycle, ClipGradByGlobalNorm,
                         CosineDecay, OneCycle, OneCycleAdam,
                         OneCycleDecayWarmupMomentum, OneCycleWarmupDecayLr,
                         PiecewiseDecay, StepDecay)
