from .center_head import CenterHead, SeparateHead
from .centerpoint import CenterPoint
