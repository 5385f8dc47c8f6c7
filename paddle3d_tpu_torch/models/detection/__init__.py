from .centerpoint import CenterHead, CenterPoint
from .pointpillars import PointPillars, SSDHead
