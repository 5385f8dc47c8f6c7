"""paddle3d_tpu_torch — the PyTorch / CUDA port of paddle3d_tpu.

The JAX package beside it is the reference. This package imports torch and
never jax, flax or paddle3d_tpu. Importing it fills the registries, so that
`apis.Config(path=...).model` builds a config's model.
"""
from . import apis, datasets, models, ops, transforms
from .apis import Config
