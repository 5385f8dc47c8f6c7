"""Port parity of the greedy rotated-BEV NMS (`suppress`), both branches,
on identical numpy boxes: the one-shot K² program (the KITTI config's
k=1000, post=300 takes it) and the kept-buffer blocked program (the tiny
config's k=512, post=50). Kept indices must be exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle3d_tpu.ops.iou3d_nms import suppress as jax_suppress
from paddle3d_tpu_torch.ops.iou3d_nms import suppress


def make_boxes(seed, k, b=2):
    """Score-ordered [b, k, 7] boxes in a few dense clusters (heavy
    overlap, long suppression chains) plus invalid rows."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, 40, (b, 12, 2))
    pick = rng.integers(0, 12, (b, k))
    boxes = np.zeros((b, k, 7), np.float32)
    boxes[..., :2] = np.take_along_axis(centers, pick[..., None], 1) + \
        rng.normal(0, 0.8, (b, k, 2))
    boxes[..., 2] = rng.uniform(-1, 1, (b, k))
    boxes[..., 3:6] = rng.uniform([1.4, 3.2, 1.3], [2.0, 4.4, 1.8], (b, k, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, k))
    boxes[:, ::7, 6] = np.pi / 2                 # axis-aligned edges
    valid = rng.uniform(size=(b, k)) > 0.1
    return boxes, valid


@pytest.mark.parametrize("k,post", [(300, 100), (640, 50)],
                         ids=["one_shot", "blocked"])
def test_suppress_matches_jax(k, post):
    boxes, valid = make_boxes(k, k)
    mask, keep = suppress(torch.from_numpy(boxes), torch.from_numpy(valid),
                          0.5, post)
    assert keep.shape == (2, post) and keep.dtype == torch.int32
    for i in range(2):
        ref_mask, ref_keep = jax_suppress(jnp.asarray(boxes[i]),
                                          jnp.asarray(valid[i]), 0.5, post)
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(ref_keep))
        n_kept = int((np.asarray(ref_keep) >= 0).sum())
        assert 0 < n_kept
        # keep_mask is exact up to the post_max_size'th kept box
        last = int(np.asarray(ref_keep)[n_kept - 1])
        np.testing.assert_array_equal(mask[i, :last + 1].numpy(),
                                      np.asarray(ref_mask)[:last + 1])


def test_suppress_takes_batch_dims_and_5dof():
    boxes, valid = make_boxes(1, 64, b=3)
    b5 = torch.from_numpy(boxes[..., [0, 1, 3, 4, 6]])
    _, keep = suppress(b5, torch.from_numpy(valid), 0.5, 20)
    for i in range(3):
        _, one = suppress(b5[i], torch.from_numpy(valid[i]), 0.5, 20)
        torch.testing.assert_close(keep[i], one, rtol=0, atol=0)
