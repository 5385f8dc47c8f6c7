"""Port parity of the row gather (K14): the port's gather_rows on the CPU
(its plain version) against the JAX gather_rows on the CPU
(jnp.take_along_axis) and against the Pallas kernel itself, run as
_pallas_gather under force_tpu_interpret_mode. A gather copies rows, so
every comparison is exact.

Out-of-range indices: the port follows the JAX CPU form, an index in
[-A, 0) wrapping once to idx + A and any other index outside [0, A) giving
a row of NaN (the Pallas kernel has no defined answer for them)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from paddle3d_tpu.ops.pallas.gather import _pallas_gather
from paddle3d_tpu.ops.pallas.gather import gather_rows as jax_gather_rows
from paddle3d_tpu_torch.ops import _build, gather


def make_inputs(seed, b, a, c, k):
    rng = np.random.default_rng(seed)
    src = rng.normal(size=(b, a, c)).astype(np.float32)
    idx = rng.integers(0, a, (b, k)).astype(np.int32)
    idx[0, :3] = [0, a - 1, 0]                   # the ends and a repeat
    return src, idx


@pytest.mark.parametrize("b,a,c,k", [(2, 50, 7, 13), (3, 300, 64, 257),
                                     (1, 9, 1, 40)])
def test_plain_matches_jax_cpu_form(b, a, c, k):
    src, idx = make_inputs(0, b, a, c, k)
    ref = np.asarray(jax_gather_rows(jnp.asarray(src), jnp.asarray(idx)))
    got = gather.gather_rows(torch.from_numpy(src), torch.from_numpy(idx))
    assert got.shape == (b, k, c)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("b,a,c,k", [(2, 50, 7, 13), (2, 129, 16, 24)])
def test_plain_matches_pallas_kernel_interpret(b, a, c, k):
    """The TPU kernel's DMA ring in interpret mode (columns padded to 128
    lanes, indices to a multiple of 8, and sliced back)."""
    src, idx = make_inputs(1, b, a, c, k)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_pallas_gather(jnp.asarray(src), jnp.asarray(idx)))
    got = gather.gather_rows(torch.from_numpy(src), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_out_of_range_indices_follow_the_cpu_form():
    """-1 is the last row, -A the first; A, -A - 1 and far values are NaN
    rows: the chosen contract, equal to jnp.take_along_axis's."""
    src = np.arange(2 * 5 * 3, dtype=np.float32).reshape(2, 5, 3)
    idx = np.array([[-1, 5, -5, -6, 4, 0], [7, -2, 2, 1, 3, -100]],
                   np.int32)
    ref = np.asarray(jax_gather_rows(jnp.asarray(src), jnp.asarray(idx)))
    got = gather.gather_rows(torch.from_numpy(src),
                             torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0, 0], src[0, 4])
    np.testing.assert_array_equal(got[0, 2], src[0, 0])
    assert np.isnan(got[0, [1, 3]]).all() and np.isnan(got[1, [0, 5]]).all()
    wrapped = (idx >= -5) & (idx < 5)
    assert not np.isnan(got[wrapped]).any()


def test_strided_source_and_cpu_takes_no_kernel(monkeypatch):
    """A strided view of the rows gives the gather of its values, and a CPU
    tensor never reaches the kernel library or its counter."""
    def no_build():
        raise AssertionError("kernel library requested for a CPU tensor")

    monkeypatch.setattr(_build, "library", no_build)
    src, idx = make_inputs(2, 2, 40, 12, 30)
    view = torch.from_numpy(src).transpose(1, 2).contiguous().transpose(1, 2)
    assert not view.is_contiguous()
    got = gather.gather_rows(view[..., 2:9], torch.from_numpy(idx))
    np.testing.assert_array_equal(
        got.numpy(), np.take_along_axis(src[..., 2:9], idx[..., None], 1))
    assert _build.LAUNCHES["gather_rows"] == 0


class _CudaLooking(torch.Tensor):
    """A CPU tensor that the wrapper takes for a CUDA one: the launch path's
    checks and call, without a card."""

    @property
    def is_cuda(self):
        return True


def test_launch_path_refuses_and_binds_once(monkeypatch):
    """gather_rows' one-expression checks still refuse int64 indices and
    indices on another device before any launch; a call that passes them
    reaches the function `_build` bound once, with the strides and sizes
    the kernel takes; `_build.function` answers from its cache without
    asking for the library again."""
    calls = []

    def no_build():
        raise AssertionError("kernel library requested")

    def fake_kernel(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(_build, "library", no_build)
    monkeypatch.setitem(_build._functions, "p3d_gather_rows", fake_kernel)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 7)
    monkeypatch.setitem(_build.LAUNCHES, "gather_rows", 0)
    src, idx = make_inputs(3, 2, 40, 12, 30)
    src = torch.from_numpy(src).as_subclass(_CudaLooking)
    idx = torch.from_numpy(idx)
    with pytest.raises(TypeError, match="int32"):
        gather.gather_rows(src, idx.long())
    with pytest.raises(ValueError, match="device"):
        gather.gather_rows(src, idx.to("meta"))
    with pytest.raises(ValueError, match=r"\[B, A, C\]"):
        gather.gather_rows(src[0], idx)
    assert not calls and _build.LAUNCHES["gather_rows"] == 0
    view = src[:, ::2, 3:10]
    out = gather.gather_rows(view, idx)
    assert tuple(out.shape) == (2, 30, 7) and out.is_contiguous()
    (args,) = calls
    assert args[1:4] == view.stride() and args[6:] == (2, 20, 30, 7, 7)
    assert args[0] == view.data_ptr() and args[5] == out.data_ptr()
    assert _build.LAUNCHES["gather_rows"] == 1
    assert _build.function("p3d_gather_rows") is fake_kernel
    with pytest.raises(AssertionError, match="library requested"):
        _build.function("p3d_sparse_conv3d_not_cached")


def test_nchw_view_matches_jax_cpu_form():
    """SMOKE's decode hands the regression map NCHW [B, C, H, W] as the
    view [B, H*W, C] (channel stride H*W): the plain version reads it in
    place and gives the JAX CPU form on the NHWC rows, at c = 10."""
    rng = np.random.default_rng(4)
    b, c, h, w, k = 2, 10, 6, 8, 11
    nchw = rng.normal(size=(b, c, h, w)).astype(np.float32)
    idx = rng.integers(0, h * w, (b, k)).astype(np.int32)
    rows = torch.from_numpy(nchw).flatten(2).transpose(1, 2)
    assert rows.stride() == (c * h * w, 1, h * w)
    ref = np.asarray(jax_gather_rows(
        jnp.asarray(nchw.transpose(0, 2, 3, 1).reshape(b, h * w, c)),
        jnp.asarray(idx)))
    got = gather.gather_rows(rows, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), ref)
