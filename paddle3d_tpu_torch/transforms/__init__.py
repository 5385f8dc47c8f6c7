from .base import Compose, TransformABC
from .normalize import Normalize, NormalizeRangeImage
from .range_image import LoadSemanticKITTIRange, project_range
from .target_generator import Gt2SmokeTarget
