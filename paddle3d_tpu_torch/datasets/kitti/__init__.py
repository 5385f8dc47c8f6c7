from . import kitti_utils
from .kitti_det import KittiDetDataset, KittiPCDataset, png_size
from .kitti_depth_det import KittiDepthDataset, KittiDepthMetric
from .kitti_metric import KittiMetric
from .kitti_mono_det import KittiMonoDataset
