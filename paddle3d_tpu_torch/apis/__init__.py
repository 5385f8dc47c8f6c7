from . import manager
from .checkpoint import Checkpoint
from .config import Config
from .dataloader import DataLoader
from .pipeline import make_eval_step, make_train_step, parse_losses
from .scheduler import Scheduler
from .trainer import Trainer
