from .semantic_kitti import (CONTENT, LEARNING_MAP, SemanticKITTIDataset,
                             SemanticKittiMetric)
