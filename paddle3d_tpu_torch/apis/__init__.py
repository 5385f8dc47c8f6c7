from . import manager
from .config import Config
