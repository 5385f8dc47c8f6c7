from . import manager
from .config import Config
from .pipeline import make_train_step, parse_losses
