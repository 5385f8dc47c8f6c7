from .weighted_loss import (SigmoidFocalClassificationLoss,
                            WeightedSmoothL1RegressionLoss,
                            WeightedSoftmaxClassificationLoss)
