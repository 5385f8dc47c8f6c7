from .weighted_loss import (SigmoidFocalClassificationLoss,
                            WeightedSmoothL1RegressionLoss,
                            WeightedSoftmaxClassificationLoss)
from .centernet_loss import FastFocalLoss, L1Loss, RegLoss, gather_feat
