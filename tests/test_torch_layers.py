"""Port parity of the layer building blocks and the weight converter.

Pins the traps between flax and torch: SAME padding on strided convs,
ConvTranspose kernel orientation, BatchNorm conventions and the BN fold.
Tolerance 1e-5: f32 convolutions of a few hundred terms summed in another
order."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from paddle3d_tpu.apis.config import Config as JaxConfig
from paddle3d_tpu.models.layers.layer_libs import ConvBNReLU as JaxConv
from paddle3d_tpu.models.layers.layer_libs import DeconvBNReLU as JaxDeconv
from paddle3d_tpu.models.voxel_encoders.pillar_encoder import \
    PillarFeatureNet as JaxPFN
from paddle3d_tpu.ops.pillar_ops import \
    pfn_folded_weights as jax_pfn_folded_weights
from paddle3d_tpu_torch.apis import Config
from paddle3d_tpu_torch.models.layers.layer_libs import (ConvBNReLU,
                                                         DeconvBNReLU,
                                                         same_pads)
from paddle3d_tpu_torch.models.voxel_encoders import PillarFeatureNet
from paddle3d_tpu_torch.ops.pillar_ops import pfn_folded_weights
from paddle3d_tpu_torch.utils.convert import load_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flat_state(module):
    """nnx parameters and running stats as {dotted path: numpy array}."""
    return {".".join(map(str, k)): np.asarray(getattr(v, "value", v))
            for kind in (nnx.Param, nnx.BatchStat)
            for k, v in nnx.state(module, kind).flat_state()}


def randomise_bn(module, seed):
    """Non-trivial running stats and affine, eval mode."""
    rng = np.random.default_rng(seed)
    for _, bn in module.iter_modules():
        if isinstance(bn, nnx.BatchNorm):
            c = bn.mean.value.shape
            bn.mean.value = jnp.asarray(rng.normal(0, .2, c), jnp.float32)
            bn.var.value = jnp.asarray(rng.uniform(.5, 2., c), jnp.float32)
            bn.scale.value = jnp.asarray(rng.uniform(.5, 1.5, c), jnp.float32)
            bn.bias.value = jnp.asarray(rng.normal(0, .2, c), jnp.float32)
    module.eval()


def run_both(jax_mod, torch_mod, x_nhwc):
    load_jax_params(torch_mod, flat_state(jax_mod))
    torch_mod.eval()
    ref = np.asarray(jax_mod(jnp.asarray(x_nhwc)))
    out = torch_mod(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    return ref, out.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("size,stride", [
    ((8, 10), 2),       # even: flax SAME pads (0, 1), torch's own (1, 1)
    ((7, 9), 2),        # odd: (1, 1)
    ((8, 10), 1),
])
def test_conv_same_padding(size, stride):
    jax_mod = JaxConv(3, 5, 3, stride=stride, rngs=nnx.Rngs(0))
    randomise_bn(jax_mod, 1)
    x = np.random.default_rng(0).normal(0, 1, (2, *size, 3)).astype(
        np.float32)
    ref, out = run_both(jax_mod, ConvBNReLU(3, 5, 3, stride=stride), x)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_same_pads_match_xla_rule():
    assert same_pads(496, 3, 2) == (0, 1)
    assert same_pads(248, 3, 1) == (1, 1)
    assert same_pads(7, 3, 2) == (1, 1)


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_conv_transpose_orientation(stride):
    """kernel = stride, VALID: each input pixel writes one s×s patch; a
    missing spatial flip would mirror every patch."""
    jax_mod = JaxDeconv(3, 4, kernel_size=stride, stride=stride,
                        rngs=nnx.Rngs(0))
    randomise_bn(jax_mod, 2)
    x = np.random.default_rng(1).normal(0, 1, (2, 5, 6, 3)).astype(
        np.float32)
    ref, out = run_both(jax_mod, DeconvBNReLU(3, 4, stride, stride), x)
    assert out.shape == (2, 5 * stride, 6 * stride, 4)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_bn_conventions():
    m = ConvBNReLU(3, 5, 3)
    assert m.bn.eps == 1e-3 and m.bn.momentum == pytest.approx(0.01)


def test_pfn_bn_fold_matches_jax():
    jax_pfn = JaxPFN(in_channels=4, feat_channels=(16, 16),
                     max_num_points_in_voxel=8, rngs=nnx.Rngs(0))
    randomise_bn(jax_pfn, 3)
    pfn = PillarFeatureNet(in_channels=4, feat_channels=(16, 16),
                           max_num_points_in_voxel=8)
    load_jax_params(pfn, flat_state(jax_pfn))
    pfn.eval()
    for got, ref in zip(pfn_folded_weights(pfn),
                        jax_pfn_folded_weights(jax_pfn)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=1e-6, atol=1e-6)


def test_converter_rejects_unknown_and_missing():
    jax_mod = JaxConv(3, 5, 3, rngs=nnx.Rngs(0))
    flat = flat_state(jax_mod)
    with pytest.raises(AttributeError):
        load_jax_params(ConvBNReLU(3, 5, 3), {**flat, "nope.kernel": 0})
    flat.pop("bn.var")
    with pytest.raises(KeyError, match="running_var"):
        load_jax_params(ConvBNReLU(3, 5, 3), flat)
    flat = flat_state(jax_mod)
    flat["conv.kernel"] = flat["conv.kernel"][:, :, :2]
    with pytest.raises(ValueError, match="conv.kernel"):
        load_jax_params(ConvBNReLU(3, 5, 3), flat)


def test_kitti_config_full_width_shapes():
    """The KITTI config builds in the port with every parameter and running
    stat of the JAX model, at full width (the converter checks shapes and
    that nothing is left unfilled)."""
    path = os.path.join(REPO, "configs", "pointpillars",
                        "pointpillars_xyres16_kitti_car.yml")
    model = Config(path=path, device="cpu").model
    load_jax_params(model, flat_state(JaxConfig(path=path).model))
    assert model.middle_encoder.ny == 496 and model.middle_encoder.nx == 432
    assert model.anchors.shape == (248 * 216 * 2, 7)
    assert model.backbone.blocks[0][0].conv.weight.shape == (64, 64, 3, 3)
