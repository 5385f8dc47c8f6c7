"""Datasets of the PyTorch port: numpy-only copies of the JAX package's
(paddle3d_tpu/datasets/), which the port cannot import. The rest of that
package (KITTI, nuScenes, Waymo, Apollo, the synthetic sets) arrives with
the runtime slice (ROADMAP.md, queue 1, item 5)."""
from .base import BaseDataset, MetricABC, collate_lidar
from .modelnet40 import AccuracyMetric, ModelNet40
from .semantic_kitti import SemanticKITTIDataset, SemanticKittiMetric
