from . import kitti_utils
from .kitti_det import KittiDetDataset, KittiPCDataset, png_size
from .kitti_metric import KittiMetric
