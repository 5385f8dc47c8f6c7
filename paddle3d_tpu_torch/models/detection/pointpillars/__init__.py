from .pointpillars import PointPillars
from .pointpillars_head import SSDHead
from .pointpillars_loss import PointPillarsLoss
