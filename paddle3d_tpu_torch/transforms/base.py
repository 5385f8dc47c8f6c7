"""Transform framework, a copy of paddle3d_tpu/transforms/base.py
(TransformABC, Compose). Images stay HWC, as in the JAX package."""
import abc

from ..apis import manager
from ..sample import Sample

__all__ = ["TransformABC", "Compose"]


class TransformABC(abc.ABC):
    @abc.abstractmethod
    def __call__(self, sample: Sample) -> Sample:
        ...


@manager.TRANSFORMS.add_component
class Compose(TransformABC):
    def __init__(self, transforms):
        if not isinstance(transforms, list):
            raise TypeError("The transforms must be a list!")
        self.transforms = transforms

    def __call__(self, sample: Sample) -> Sample:
        for t in self.transforms:
            sample = t(sample)
        return sample
