from .bevfusion import BEVFusion, SE_Block, resize_bilinear
