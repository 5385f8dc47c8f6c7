from .bev_lanedet import BEVLaneDet, bilinear_warp
