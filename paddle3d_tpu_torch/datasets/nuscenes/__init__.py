from .nuscenes_det import NuscenesDetDataset, NuscenesPCDataset
from .nuscenes_metric import NuScenesMetric
from .nuscenes_multi_modality import NuscenesMMDataset
from .nuscenes_multiview_det import (NuscenesMVDataset,
                                     NuscenesMVSegDataset,
                                     NuScenesSegMetric)
