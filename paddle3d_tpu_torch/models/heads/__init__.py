from .anchor3d_head import Anchor3DHead
from .bevformer_head import BEVFormerHead
from .cape_head import CAPEHead
from .class_heads import DeepLabV3Head, OCRNetHead
from .roi_head import RoIGridHead
from .rtebev_head import RTEBevHead
from .denoising import DenoisingConfig
from .petr_head import PETRHead
from .petr_seg_head import PETRSegHead
from .target_assigners import (BBox3DL1Cost, FocalLossCost,
                               HungarianAssigner3D)
