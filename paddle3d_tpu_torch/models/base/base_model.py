"""Base model classes, torch port of paddle3d_tpu/models/base/base_model.py.

The three entry points are plain methods on an nn.Module, with the JAX
package's contract (batch dicts in, fixed-shape output dicts out):
  train_forward(batch) -> dict of scalar losses (key 'loss' = total)
  test_forward(batch)  -> 'box3d_lidar' [B,K,7], 'scores' [B,K] and
                          'label_preds' [B,K], -1 padded
  export_forward(batch)-> the deploy variant of test_forward.
"""
import abc

from torch import nn


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
    """LiDAR family marker."""
    modality = "lidar"


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
