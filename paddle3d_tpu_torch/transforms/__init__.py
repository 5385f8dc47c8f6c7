from .base import Compose, TransformABC
from .target_generator import Gt2SmokeTarget
