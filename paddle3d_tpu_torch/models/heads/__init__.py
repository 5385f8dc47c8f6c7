from .anchor3d_head import Anchor3DHead
from .roi_head import RoIGridHead
