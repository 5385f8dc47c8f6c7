"""Transform framework, a copy of paddle3d_tpu/transforms/base.py
(TransformABC, Compose). Images stay HWC, as in the JAX package.

A random transform draws from the sample's own generator, `sample.rng` (a
numpy RandomState that the dataset sets from the loader's seed, epoch and
index: `sample_rng`), never from numpy's global state. It makes the calls
the JAX transform makes on `np.random`, in the same order, so that the JAX
transform after `np.random.seed(s)` and the port's with `sample.rng =
np.random.RandomState(s)` give equal arrays; unlike the global state, the
draws do not depend on which loader thread builds the sample.
"""
import abc

import numpy as np

from ..apis import manager
from ..sample import Sample

__all__ = ["TransformABC", "Compose", "sample_rng", "rng_of"]


def sample_rng(seed: int, epoch: int, index: int) -> np.random.RandomState:
    """The generator of one sample: seeded by (seed, epoch, index)."""
    return np.random.RandomState([int(seed), int(epoch), int(index)])


def rng_of(sample: Sample) -> np.random.RandomState:
    """The sample's generator; a random transform raises without one."""
    rng = sample.get("rng")
    if rng is None:
        raise ValueError(
            "a random transform draws from the sample's generator: set "
            "sample.rng (datasets set it from the loader's seed, epoch and "
            "index, transforms.sample_rng)")
    return rng


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
