from .smoke import SMOKE
from .smoke_coder import SMOKECoder
from .smoke_loss import SMOKELossComputation
from .smoke_predictor import SMOKEPredictor
