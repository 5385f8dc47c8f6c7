from .bev_lanedet import BEVLaneDet
from .bevdet import BEVDet
from .bevfusion import BEVFusion
from .bevformer import BEVFormer, BEVFormerEncoderLayer
from .caddn import CADDN
from .centerpoint import CenterHead, CenterPoint
from .dd3d import DD3D
from .iassd import IASSD
from .petr import PETR
from .pointpillars import PointPillars, SSDHead
from .pv_rcnn import PVRCNN, VoxelRCNN
from .rtebev import RTEBev
from .smoke import SMOKE, SMOKELossComputation, SMOKEPredictor
