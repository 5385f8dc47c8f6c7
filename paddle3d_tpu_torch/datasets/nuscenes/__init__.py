from .nuscenes_det import NuscenesDetDataset, NuscenesPCDataset
from .nuscenes_metric import NuScenesMetric
