from .caddn import CADDN
from .centerpoint import CenterHead, CenterPoint
from .iassd import IASSD
from .pointpillars import PointPillars, SSDHead
from .pv_rcnn import PVRCNN, VoxelRCNN
from .smoke import SMOKE, SMOKELossComputation, SMOKEPredictor
