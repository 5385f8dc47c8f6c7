from .bbox import (BBoxes2D, BBoxes3D, CoordMode, box_collision_test,
                   boxes3d_kitti_camera_to_lidar, boxes3d_lidar_to_kitti_camera,
                   circle_nms, limit_period, points_in_convex_polygon_2d,
                   points_in_convex_polygon_3d, points_in_rbbox_bev,
                   rbbox2d_to_near_bbox, rotated_iou_2d, rotation_3d_in_axis,
                   second_box_decode, second_box_encode)
from .pointcloud import PointCloud
from .structure import _Structure
