"""Base model classes, torch port of paddle3d_tpu/models/base/base_model.py.

The three entry points are plain methods on an nn.Module, with the JAX
package's contract (batch dicts in, fixed-shape output dicts out):
  train_forward(batch) -> dict of scalar losses (key 'loss' = total)
  test_forward(batch)  -> 'box3d_lidar' [B,K,7], 'scores' [B,K] and
                          'label_preds' [B,K], -1 padded
  export_forward(batch)-> the deploy variant of test_forward.
"""
import abc

import numpy as np
from torch import nn

from ...geometries import BBoxes3D, CoordMode
from ...sample import Sample


class Base3DModel(nn.Module, abc.ABC):

    @abc.abstractmethod
    def train_forward(self, batch) -> dict:
        ...

    @abc.abstractmethod
    def test_forward(self, batch) -> dict:
        ...

    def export_forward(self, batch) -> dict:
        return self.test_forward(batch)

    def forward(self, batch):
        return self.train_forward(batch)


class BaseLidarModel(Base3DModel):
    """LiDAR family marker, with the detectors' shared host post-processing
    (PointPillars, CenterPoint, PV-RCNN / Voxel-RCNN, IA-SSD)."""
    modality = "lidar"

    @staticmethod
    def postprocess_to_samples(outputs: dict, metas: list) -> list:
        """Fixed-shape outputs (numpy: box3d_lidar [B, K, 7 | 9] bottom-z,
        scores [B, K], label_preds [B, K], -1 padded) -> one Sample a meta:
        the rows with a score >= 0 as BBoxes3D (KittiLidar, origin (.5, .5,
        0)), labels, confidences and the observation angle alpha; a
        9-column box (x, y, z, w, l, h, vx, vy, yaw) keeps its velocities
        apart. The JAX package's PointPillars /
        CenterPoint.postprocess_to_samples (pointpillars.py:141-164,
        centerpoint.py:148-181)."""
        boxes = np.asarray(outputs["box3d_lidar"])
        scores = np.asarray(outputs["scores"])
        labels = np.asarray(outputs["label_preds"])
        results = []
        for i, meta in enumerate(metas):
            valid = scores[i] >= 0
            sample = Sample(path=meta.get("path"), modality="lidar")
            b = boxes[i][valid]
            box7 = b[:, [0, 1, 2, 3, 4, 5, b.shape[-1] - 1]] if len(b) else \
                b.reshape(0, 7)
            sample.bboxes_3d = BBoxes3D(
                box7, origin=[.5, .5, 0.], coordmode=CoordMode.KittiLidar,
                rot_axis=2)
            if b.shape[-1] == 9 and len(b):
                sample.bboxes_3d.velocities = b[:, 6:8]
            sample.labels = labels[i][valid]
            sample.confidences = scores[i][valid]
            sample.alpha = (-np.arctan2(-box7[:, 1], box7[:, 0]) +
                            box7[:, 6]) if len(b) else np.zeros((0,))
            if meta.get("calibs") is not None:
                sample.calibs = meta["calibs"]
            sample.meta.update({k: v for k, v in meta.items()
                                if k not in ("path", "calibs")})
            results.append(sample)
        return results


class BaseMonoModel(Base3DModel):
    """Monocular-camera family marker."""
    modality = "image"


class BaseMultiViewModel(Base3DModel):
    """Multi-view camera family marker."""
    modality = "multiview"


def raise_if_training(model: nn.Module):
    """test_forward serves with running-stat BN and the test voxel cap; a
    model in train mode would fold train-mode BN modules wrongly and move
    their running stats, so it is refused."""
    if model.training:
        raise RuntimeError(
            "{}.test_forward needs the model in eval mode: call .eval() "
            "first (train mode uses batch-statistics BatchNorm)".format(
                type(model).__name__))
