from .anchor3d_head import Anchor3DHead
from .class_heads import DeepLabV3Head, OCRNetHead
from .roi_head import RoIGridHead
