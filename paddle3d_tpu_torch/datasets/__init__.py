"""Datasets of the PyTorch port: numpy-only copies of the JAX package's
(paddle3d_tpu/datasets/), which the port cannot import. The nuScenes
multi-view, multi-modality and segmentation sets and Apollo (JPEG images)
wait for ROADMAP.md, queue 1, item 5."""
from .base import BaseDataset, MetricABC, collate_lidar
from .kitti import (KittiDepthDataset, KittiDepthMetric, KittiDetDataset,
                    KittiMetric, KittiMonoDataset, KittiPCDataset)
from .nuscenes import NuscenesPCDataset, NuScenesMetric
from .modelnet40 import AccuracyMetric, ModelNet40
from .semantic_kitti import SemanticKITTIDataset, SemanticKittiMetric
from .synthetic import (SyntheticClsDataset, SyntheticClsMetric,
                        SyntheticDataset, SyntheticDepthDataset,
                        SyntheticDepthMetric, SyntheticMetric,
                        SyntheticMonoDataset, SyntheticMonoMetric,
                        SyntheticMVDataset, SyntheticMVMetric,
                        SyntheticRangeDataset, SyntheticRangeMetric)
from .waymo import WaymoMetric, WaymoPCDataset
