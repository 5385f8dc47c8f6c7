from .pointpillars import PointPillars, SSDHead
