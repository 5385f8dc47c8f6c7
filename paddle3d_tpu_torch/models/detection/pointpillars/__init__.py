from .pointpillars import PointPillars
from .pointpillars_head import SSDHead
