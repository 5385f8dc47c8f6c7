"""Datasets of the PyTorch port: numpy-only copies of the JAX package's
(paddle3d_tpu/datasets/), which the port cannot import. Images are read
by the port's own PNG and JPEG decoders (utils/png.py, utils/jpeg.py)."""
from .apollo import ApolloLaneDataset, ApolloLaneMetric
from .base import BaseDataset, MetricABC, collate_lidar
from .kitti import (KittiDepthDataset, KittiDepthMetric, KittiDetDataset,
                    KittiMetric, KittiMonoDataset, KittiPCDataset)
from .nuscenes import (NuscenesMMDataset, NuscenesMVDataset,
                       NuscenesMVSegDataset, NuscenesPCDataset,
                       NuScenesMetric, NuScenesSegMetric)
from .modelnet40 import AccuracyMetric, ModelNet40
from .semantic_kitti import SemanticKITTIDataset, SemanticKittiMetric
from .synthetic import (SyntheticClsDataset, SyntheticClsMetric,
                        SyntheticDataset, SyntheticDepthDataset,
                        SyntheticDepthMetric, SyntheticMetric,
                        SyntheticMonoDataset, SyntheticMonoMetric,
                        SyntheticMVDataset, SyntheticMVMetric,
                        SyntheticRangeDataset, SyntheticRangeMetric)
from .waymo import WaymoMetric, WaymoPCDataset
