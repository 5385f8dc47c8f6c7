"""Port parity: the port's eval pillar canvas and occupancy (sort → fused
PFN rows → sorted segment sum, plain versions on the CPU) against the JAX
package's Pallas path in interpret mode and its XLA path.

Tolerance: canvas 1e-4 (the per-pillar means and the 9-term products are
summed in another order, see test_torch_fused_pfn.py); occupancy exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from paddle3d_tpu.models.middle_encoders.pillar_scatter import \
    PointPillarsScatter as JaxScatter
from paddle3d_tpu.models.voxel_encoders.pillar_encoder import \
    PillarFeatureNet as JaxPFN
from paddle3d_tpu.models.voxelizers.voxelize import HardVoxelizer as JaxVox
from paddle3d_tpu.ops.pillar_ops import (_fused_pillar_canvas_pallas,
                                         fused_pillar_canvas as jax_canvas)
from paddle3d_tpu_torch.models.middle_encoders import PointPillarsScatter
from paddle3d_tpu_torch.models.voxel_encoders import PillarFeatureNet
from paddle3d_tpu_torch.models.voxelizers import HardVoxelizer
from paddle3d_tpu_torch.ops.pillar_ops import fused_pillar_canvas
from paddle3d_tpu_torch.utils.convert import load_jax_params

PC_RANGE = (0., -4., -2., 12.8, 4., 2.)   # grid 32 x 20 @ 0.4
VOXEL = (0.4, 0.4, 4.0)


def flat_state(module):
    """nnx parameters and running stats as {dotted path: numpy array}."""
    return {".".join(map(str, k)): np.asarray(getattr(v, "value", v))
            for kind in (nnx.Param, nnx.BatchStat)
            for k, v in nnx.state(module, kind).flat_state()}


def build_pair(feat_channels, max_points, max_voxels):
    """The JAX modules (eval BN, randomised running stats) and the port's,
    with the JAX weights carried across."""
    vox = JaxVox(VOXEL, PC_RANGE, max_points, [max_voxels, max_voxels])
    pfn = JaxPFN(in_channels=4, feat_channels=feat_channels,
                 max_num_points_in_voxel=max_points, voxel_size=VOXEL,
                 point_cloud_range=PC_RANGE, legacy=False, rngs=nnx.Rngs(0))
    mid = JaxScatter(feat_channels[-1], VOXEL, PC_RANGE)
    rng = np.random.default_rng(3)
    for layer in pfn.pfn_layers:
        bn = layer.mlp.bn
        bn.mean.value = jnp.asarray(rng.normal(0, .2, bn.mean.value.shape),
                                    jnp.float32)
        bn.var.value = jnp.asarray(rng.uniform(.5, 2., bn.var.value.shape),
                                   jnp.float32)
        bn.use_running_average = True
    t_pfn = PillarFeatureNet(in_channels=4, feat_channels=feat_channels,
                             max_num_points_in_voxel=max_points,
                             voxel_size=VOXEL, point_cloud_range=PC_RANGE,
                             legacy=False)
    load_jax_params(t_pfn, flat_state(pfn))
    t_pfn.eval()
    return ((vox, pfn, mid),
            (HardVoxelizer(VOXEL, PC_RANGE, max_points,
                           [max_voxels, max_voxels]), t_pfn,
             PointPillarsScatter(feat_channels[-1], VOXEL, PC_RANGE)))


def make_points(seed, b=2, n=1000):
    rng = np.random.default_rng(seed)
    lo, hi = np.array([0., -4., -2., 0.]), np.array([12.8, 4., 2., 1.])
    pts = rng.uniform(lo, hi, (b, n, 4)).astype(np.float32)
    k = n // 2
    centers = rng.uniform(lo[:2] + 0.5, hi[:2] - 0.5, (4, 2))
    asn = rng.integers(0, 4, k)
    pts[:, :k, 0] = centers[asn, 0] + rng.normal(0, .05, (b, k))
    pts[:, :k, 1] = centers[asn, 1] + rng.normal(0, .05, (b, k))
    pts[:, -n // 10:, 0] = 100.0              # out of range: sentinel keys
    pts[1, -5:] = np.nan                      # NaN padding
    return pts


@pytest.mark.parametrize("feat_channels,max_voxels", [
    ((16,), 512),
    ((16,), 40),        # max_voxels cap fires
    ((16, 16), 512),    # two PFN layers (plain version only on CUDA)
])
def test_canvas_matches_jax(feat_channels, max_voxels):
    jax_mods, torch_mods = build_pair(feat_channels, 8, max_voxels)
    pts = make_points(len(feat_channels) + max_voxels)
    canvas, occ = fused_pillar_canvas(*torch_mods, torch.from_numpy(pts),
                                      False, with_occupancy=True)
    assert canvas.shape == (2, 20, 32, 16) and occ.shape == (2, 20, 32)
    refs = [
        _fused_pillar_canvas_pallas(*jax_mods, jnp.asarray(pts),
                                    with_occupancy=True, interpret=True),
        jax_canvas(*jax_mods, jnp.asarray(pts), training=False,
                   with_occupancy=True),
    ]
    for ref_canvas, ref_occ in refs:
        np.testing.assert_allclose(canvas.numpy(), np.asarray(ref_canvas),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(occ.numpy(), np.asarray(ref_occ))
    assert 0 < occ.sum(dim=(1, 2)).max() <= max_voxels


def test_canvas_without_occupancy_and_train_mode():
    _, (vox, pfn, mid) = build_pair((16,), 8, 512)
    pts = torch.from_numpy(make_points(0))
    canvas = fused_pillar_canvas(vox, pfn, mid, pts, False)
    with_occ, _ = fused_pillar_canvas(vox, pfn, mid, pts, False,
                                      with_occupancy=True)
    torch.testing.assert_close(canvas, with_occ, rtol=0, atol=0)
    assert not canvas.requires_grad
    # train mode: batch-stat BN, a differentiable canvas, running stats
    # updated (tests/test_torch_fused_pfn_train.py holds it against JAX)
    pfn.train()
    before = pfn.pfn_layers[0].mlp.bn.running_mean.clone()
    canvas = fused_pillar_canvas(vox, pfn, mid, pts, True)
    assert canvas.shape == (2, 20, 32, 16) and canvas.requires_grad
    assert not torch.equal(pfn.pfn_layers[0].mlp.bn.running_mean, before)
