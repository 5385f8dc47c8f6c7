"""Carry the JAX package's weights into a port model.

The caller flattens the nnx state (nnx.Param and nnx.BatchStat) to dotted
paths and numpy arrays; this module imports no JAX, so it also runs where
only torch is installed. The port mirrors the JAX module tree, so a path
names the same submodule on both sides. The rules below are by module
type, so a new module whose layers are of these types needs none of its
own: BEVFusion's PFN, SE gate and fusion conv, DD3D's BatchNorm DLA
(scale, bias and running stats), GroupNorm towers, heads, top-block convs
and its bare `depth_scales` parameter all go through them, and so do
SqueezeSegV3's nnx.Sequential paths (`position_mlp.layers.<i>`,
`head.layers.<i>`: layer_libs.Sequential keeps them) and PAConv's bare
weight banks in an nnx.List (`weight_banks.<i>`, the parameters of an
nn.ParameterList).
"""
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..models.layers.sparse_layers import MaskedBatchNorm, SparseConv3D
from ..models.transformers.transformer_layers import HeadsLinear

__all__ = ["load_jax_params", "to_torch_names"]

_BN_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
             "var": "running_var"}


def _convert(module: nn.Module, leaf: str, arr: np.ndarray):
    """-> (torch attribute name, array in torch layout)."""
    if isinstance(module, (nn.modules.batchnorm._BatchNorm,
                           MaskedBatchNorm, nn.GroupNorm, nn.LayerNorm)):
        return _BN_NAMES[leaf], arr         # Group/LayerNorm: scale, bias
    if isinstance(module, SparseConv3D) and leaf == "weight":
        return "weight", arr                # [K^3 * Cin, Cout] as it is
    if isinstance(module, HeadsLinear):
        # nnx.MultiHeadAttention's projections: q / k / v kernel [in,
        # heads, head_dim] and bias [heads, head_dim]; out kernel [heads,
        # head_dim, out] -> nn.Linear over the flattened heads
        if leaf == "bias":
            return "bias", arr.reshape(-1)
        return "weight", arr.reshape(module.in_features, -1).T
    if isinstance(module, nn.Embedding) and leaf == "embedding":
        return "weight", arr                 # nnx.Embed [num, features]
    if leaf == "bias":
        return "bias", arr
    if leaf in module._parameters:
        # a bare nnx.Param (PETR's reference_points, time_embed): its path
        # ends at the parameter, which the torch module holds by that name
        return leaf, arr
    if leaf != "kernel":
        raise KeyError("no torch counterpart for leaf {!r} of {}".format(
            leaf, type(module).__name__))
    if isinstance(module, nn.Linear):
        return "weight", arr.T                       # [in, out] -> [out, in]
    if isinstance(module, nn.ConvTranspose2d):
        # flax ConvTranspose (transpose_kernel=False) correlates the dilated
        # input, so out[i*s + m] = x[i] * k[s-1-m]; torch scatters
        # x[i] * w[m]: flip both spatial axes. HWIO -> (in, out, H, W).
        return "weight", arr[::-1, ::-1].transpose(2, 3, 0, 1)
    if isinstance(module, nn.Conv2d):
        return "weight", arr.transpose(3, 2, 0, 1)   # HWIO -> OIHW
    raise KeyError("no kernel conversion for {}".format(
        type(module).__name__))


def to_torch_names(model: nn.Module,
                   flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """{dotted nnx path: array} -> {torch state name: tensor in torch
    layout}, without loading it: e.g. the JAX package's gradients, to hold
    against the port's `.grad`s. Raises on an unknown path or a shape that
    does not fit `model`."""
    out = {}
    for path, value in flat.items():
        prefix, _, leaf = path.rpartition(".")
        module = model.get_submodule(prefix)
        name, arr = _convert(module, leaf, np.asarray(value))
        target = getattr(module, name)
        if tuple(target.shape) != arr.shape:
            raise ValueError("{}: torch {} vs converted {}".format(
                path, tuple(target.shape), arr.shape))
        out[".".join(filter(None, (prefix, name)))] = torch.from_numpy(
            arr.copy())  # own strides
    return out


def load_jax_params(model: nn.Module, flat: Dict[str, np.ndarray]) -> None:
    """Fill `model` from {dotted nnx path: array}, e.g.
    "backbone.blocks.0.0.conv.kernel" or, through an nn.ModuleDict,
    "bbox_head.task_heads.0.towers.hm.0.bn.scale". Raises on an unknown
    path, a shape mismatch, or a torch parameter or running stat left
    unfilled."""
    converted = to_torch_names(model, flat)
    with torch.no_grad():
        for name, value in converted.items():
            prefix, _, leaf = name.rpartition(".")
            getattr(model.get_submodule(prefix), leaf).copy_(value)
    filled = set(converted)
    expected = {k for k in model.state_dict()
                if not k.endswith("num_batches_tracked")}
    missing = sorted(expected - filled)
    if missing:
        raise KeyError("torch state left unfilled: {}".format(missing))
