"""Datasets of the PyTorch port: numpy-only copies of the JAX package's
(paddle3d_tpu/datasets/), which the port cannot import. The nuScenes
multi-view, multi-modality and segmentation sets, Apollo, the other camera
datasets and the synthetic camera sets wait for ROADMAP.md, queue 1,
item 5."""
from .base import BaseDataset, MetricABC, collate_lidar
from .kitti import KittiDetDataset, KittiMetric, KittiPCDataset
from .nuscenes import NuscenesPCDataset, NuScenesMetric
from .modelnet40 import AccuracyMetric, ModelNet40
from .semantic_kitti import SemanticKITTIDataset, SemanticKittiMetric
from .synthetic import (SyntheticClsDataset, SyntheticClsMetric,
                        SyntheticDataset, SyntheticMetric,
                        SyntheticRangeDataset, SyntheticRangeMetric)
from .waymo import WaymoMetric, WaymoPCDataset
