from .center_head import CenterHead, SeparateHead
from .centerpoint import CenterPoint
from .centerpoint_target import CenterPointTargetGenerator, gaussian_radius
