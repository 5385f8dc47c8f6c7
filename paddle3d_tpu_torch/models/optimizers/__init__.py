from .optimizers import (SGD, Adam, AdamW, AdamWOnecycle, ClipGradByGlobalNorm,
                         CosineDecay, LinearWarmup, OneCycle, OneCycleAdam,
                         OneCycleDecayWarmupMomentum, OneCycleWarmupDecayLr,
                         PiecewiseDecay, StepDecay)
