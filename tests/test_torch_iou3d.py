"""Port parity of the rotated-box intersection (K11's plain version) and the
IoUs built on it against the JAX package.

The port's plain clip (ops/iou_clip.pairwise_intersection_area_plain, which
the CUDA kernel equals bit for bit on the card) follows the XLA slot-list
form, paddle3d_tpu/ops/iou3d_nms.py:_pairwise_intersection_area, op for op:
on the same corners, run op by op, it is held to 1e-5 of each pair's area
(it comes out bit-equal on this CPU). Against the Pallas kernel in
interpret mode, which reassociates (an inverse-d2 multiply, hoisted side
terms), the JAX package's own 1e-3 (tests/ops/test_iou_clip_pallas.py).
boxes_iou_bev and boxes_iou3d build their corners with torch's cos / sin,
an ulp from JAX's: IoUs within 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle3d_tpu.ops import iou3d_nms as jax_iou
from paddle3d_tpu.ops.box_ops import boxes_to_corners_bev as jax_corners
from paddle3d_tpu.ops.pallas.iou_clip import \
    pairwise_intersection_area_pallas
from paddle3d_tpu_torch.ops import _build, iou3d_nms, iou_clip
from paddle3d_tpu_torch.ops.box_ops import boxes_to_corners_bev


def random_boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-20, 20, (n, 2))
    b[:, 2] = rng.uniform(-2, 0, n)
    b[:, 3:5] = rng.uniform(0.5, 4.0, (n, 2))
    b[:, 5] = rng.uniform(0.5, 3.0, n)
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def clustered(seed, n=48):
    """Boxes and jittered copies of them, so that many pairs overlap."""
    rng = np.random.default_rng(seed)
    a = random_boxes(rng, n)
    b = a.copy()
    b[:, :2] += rng.uniform(-1.5, 1.5, (n, 2))
    b[:, 6] += rng.uniform(-0.5, 0.5, n)
    b[:, 2] += rng.uniform(-0.5, 0.5, n)
    return a, b


def corners(boxes):
    return np.array(jax_corners(jnp.asarray(boxes)), np.float32)


def xla_clip(ca, cb):
    """The XLA slot-list clip run op by op, [24, 4, 2] x [24, 4, 2] at
    every call here (its primitives compile once). Under jit, XLA on this
    CPU contracts its multiply-adds: ~1e-4 of an area from the op-by-op
    values at 20 m, ~1e-3 at 1 km (the shoelace of absolute coordinates)."""
    return np.asarray(jax_iou._pairwise_intersection_area(jnp.asarray(ca),
                                                          jnp.asarray(cb)))


def area_close(got, ref, tol):
    """|got - ref| <= tol * max(area, 1) pair by pair."""
    err = np.abs(got - ref)
    assert (err <= tol * np.maximum(ref, 1.0)).all(), err.max()


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_clip_matches_jax(seed):
    """The same CCW corners into the port's plain clip, the XLA slot-list
    clip and the Pallas kernel in interpret mode, batched [2, N, M]."""
    a, b = clustered(seed)
    ca, cb = corners(a).reshape(2, 24, 4, 2), corners(b).reshape(2, 24, 4, 2)
    got = iou_clip.pairwise_intersection_area(torch.from_numpy(ca),
                                              torch.from_numpy(cb)).numpy()
    assert got.shape == (2, 24, 24)
    ref = np.stack([xla_clip(x, y) for x, y in zip(ca, cb)])
    assert (ref > 0.1).sum() > 24, "the fixture should overlap"
    area_close(got, ref, 1e-5)
    pal = np.asarray(pairwise_intersection_area_pallas(
        jnp.asarray(ca), jnp.asarray(cb), interpret=True))
    np.testing.assert_allclose(got, pal, rtol=1e-3, atol=1e-3)


def test_corners_match_jax():
    """CCW corners in the JAX corner order, 7-dof and 5-dof boxes."""
    a = random_boxes(np.random.default_rng(2), 32)
    got = boxes_to_corners_bev(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(got, corners(a), rtol=0, atol=2e-6)
    b5 = a[:, [0, 1, 3, 4, 6]]
    np.testing.assert_array_equal(
        boxes_to_corners_bev(torch.from_numpy(b5)).numpy(), got)
    # counter-clockwise: positive shoelace area
    x, y = got[..., 0], got[..., 1]
    signed = 0.5 * (x * np.roll(y, -1, 1) - np.roll(x, -1, 1) * y).sum(1)
    np.testing.assert_allclose(signed, a[:, 3] * a[:, 4], rtol=1e-5)


def test_iou_bev_and_3d_match_jax():
    """boxes_iou_bev and boxes_iou3d against the JAX functions, one sample
    and a batch of two; 5-dof boxes as 7-dof ones."""
    a, b = clustered(3, 40)
    for fn, jfn in ((iou3d_nms.boxes_iou_bev, jax_iou.boxes_iou_bev),
                    (iou3d_nms.boxes_iou3d, jax_iou.boxes_iou3d)):
        ref = np.asarray(jfn(jnp.asarray(a), jnp.asarray(b)))
        got = fn(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
        assert (ref > 0.1).sum() >= 20
        batched = fn(torch.from_numpy(a).reshape(2, 20, 7),
                     torch.from_numpy(b).reshape(2, 20, 7)).numpy()
        np.testing.assert_array_equal(batched[0], got[:20, :20])
        np.testing.assert_array_equal(batched[1], got[20:, 20:])
    # 5-dof boxes (cx, cy, dx, dy, yaw) give the same corners and areas
    b5a, b5b = a[:, [0, 1, 3, 4, 6]], b[:, [0, 1, 3, 4, 6]]
    np.testing.assert_array_equal(
        iou3d_nms.boxes_iou_bev(torch.from_numpy(b5a),
                                torch.from_numpy(b5b)).numpy(),
        iou3d_nms.boxes_iou_bev(torch.from_numpy(a),
                                torch.from_numpy(b)).numpy())


def test_degenerate_pairs():
    """Identity (each box's IoU with itself is 1), far-apart pairs (exactly
    0 through the guard), coincident edges (boxes abutting on a shared
    edge: 0; a box split in half: half its area; rotations by multiples of
    pi/2 of a square: its area), and the d2 < eps clamp (a clip box of zero
    size clips nothing, so the square keeps its area; a box of zero size
    has none), each against the XLA form."""
    rng = np.random.default_rng(4)
    a = random_boxes(rng, 16)
    iou = iou3d_nms.boxes_iou3d(torch.from_numpy(a), torch.from_numpy(a))
    np.testing.assert_allclose(np.diag(iou.numpy()), 1.0, atol=1e-5)
    far = a.copy()
    far[:, 0] += 1000.0
    assert (iou3d_nms.boxes_overlap_bev(torch.from_numpy(a),
                                        torch.from_numpy(far)) == 0).all()

    sq = np.array([[0, 0, 0, 2, 2, 1, 0]], np.float32)
    cases = np.concatenate([
        sq,
        [[2, 0, 0, 2, 2, 1, 0]],                 # abuts on x = 1
        [[0.5, 0, 0, 1, 2, 1, 0]],               # the right half
        [[0, 0, 0, 2, 2, 1, np.pi / 2]],         # the same square turned
        [[0, 0, 0, 2, 2, 1, np.pi]],
        [[0, 2, 0, 2, 2, 1, -np.pi / 2]],        # abuts on y = 1, turned
        [[0, 0, 0, 0, 0, 1, 0]],                 # zero size: d2 clamped
        [[0.3, 0.2, 0, 1e-4, 1e-4, 1, 0.7]],     # tiny, inside
        far[:16],                                # the rest of 24 rows
    ]).astype(np.float32)
    cc = corners(cases)
    ref = xla_clip(cc, cc)
    got = iou_clip.pairwise_intersection_area(torch.from_numpy(cc),
                                              torch.from_numpy(cc)).numpy()
    area_close(got, ref, 1e-5)
    np.testing.assert_allclose(got[0, :8], [4, 0, 2, 4, 4, 0, 4, 1e-8],
                               atol=1e-5)
    assert np.isfinite(got).all() and got[6].max() == 0


def test_cpu_takes_no_kernel(monkeypatch):
    """A CPU tensor never reaches the kernel library or its counter."""
    def no_build():
        raise AssertionError("kernel library requested for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_build)
    before = dict(_build.LAUNCHES)
    a, b = clustered(5, 8)
    iou3d_nms.boxes_iou3d(torch.from_numpy(a), torch.from_numpy(b))
    assert _build.LAUNCHES == before
