from .bbox import limit_period, rbbox2d_to_near_bbox
