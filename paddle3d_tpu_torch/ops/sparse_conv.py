"""Sorted-key sparse 3-D convolution with a fused eval-BatchNorm epilogue.

Port of paddle3d_tpu/ops/pallas/sparse_conv.py:sparse_conv3d_win and its
packed twin _sparse_conv3d_packed (TPU kernels `_kernel` and
`_kernel_packed`, K8), as two hand-written kernels in csrc/sparse_conv.cu
(whose header says what bounds them and how they work): the neighbour map
(`sparse_conv3d_map`, plain version `neighbour_map`), which the model layers
build once per key set and hand to every submanifold conv on it, and the
conv over a map (`sparse_conv3d`, plain version `sparse_conv3d_plain`),
which multiplies only where a tap hits. On a CUDA tensor each entry
launches its kernel; on a CPU tensor it takes its plain version. The plain
conv repeats the kernel's arithmetic in the kernel's order (tap, then input
channel, each product and sum rounded on its own), so the two agree bit for
bit.
"""
import torch

from . import _build
from .sparse import kernel_offsets, lookup_coords

__all__ = ["sparse_conv3d", "sparse_conv3d_plain", "sparse_conv3d_map",
           "neighbour_map", "kernel_pairs"]

#: output channels the kernel takes: multiples of 16 up to 128
_COUT_STEP, _COUT_MAX = 16, 128


def kernel_pairs(nbr: torch.Tensor, cout: int) -> int:
    """(row, tap) pairs the conv kernel multiplies for the map nbr
    [B, Vq, K^3], cin * cout products each (csrc/sparse_conv.cu): a block
    owns 256 query rows at 16 output channels, 128 up to 64, 64 above, and
    multiplies each tap's hits rounded up to a warp's 8 rows. Against the
    hits, the share of products computed beyond the needed."""
    hit = nbr >= 0
    b, vq, k3 = hit.shape
    rows = 256 if cout == 16 else 128 if cout <= 64 else 64
    tiles = torch.cat([hit, hit.new_zeros((b, (-vq) % rows, k3))],
                      1).reshape(b, -1, rows, k3).sum(dim=2)
    return int(((tiles + 7) // 8 * 8).sum())


def _folded(weights, scale):
    return weights if scale is None else weights * scale[None, :]


def neighbour_map(qbase: torch.Tensor, in_keys: torch.Tensor, D: int, H: int,
                  W: int, kernel_size: int = 3) -> torch.Tensor:
    """Plain version of the map kernel: -> nbr [B, Vq, K^3] int32, the row
    of in_keys[b] holding the key of (z, y, x)(qbase[b, i]) + offset(k), or
    -1 where that coordinate leaves the grid, the key is absent, or the
    query is padding (outside [0, D*H*W)); ops/sparse.lookup_coords over
    each row's sorted keys."""
    hw = H * W
    valid = (qbase >= 0) & (qbase < D * hw)
    q = torch.where(valid, qbase, 0)
    z = torch.div(q, hw, rounding_mode="floor")
    y = torch.div(q - z * hw, W, rounding_mode="floor")
    coords = torch.stack([z, y, q - z * hw - y * W], dim=-1)
    off = torch.as_tensor(kernel_offsets(kernel_size), dtype=coords.dtype,
                          device=coords.device)
    b, vq = qbase.shape
    k3 = off.shape[0]
    query = (coords[:, :, None] + off).reshape(b, vq * k3, 3)
    rows = torch.arange(in_keys.shape[1], dtype=torch.int32,
                        device=in_keys.device).expand(b, -1)
    nbr = lookup_coords(in_keys.contiguous(), rows, query,
                        valid.repeat_interleave(k3, dim=1), (D, H, W))
    return nbr.reshape(b, vq, k3)


def _epilogue(acc, qbase, dhw, shift, relu):
    if shift is not None:
        acc = acc + shift
    if relu:
        acc = acc.clamp(min=0.)
    valid = (qbase >= 0) & (qbase < dhw)
    return torch.where(valid[..., None], acc, 0.)


def _map_shape_ok(nbr, qbase, kernel_size):
    b, vq = qbase.shape
    if tuple(nbr.shape) != (b, vq, kernel_size ** 3):
        raise ValueError("nbr [B, Vq, K^3] = {} expected, got {}".format(
            (b, vq, kernel_size ** 3), tuple(nbr.shape)))


def sparse_conv3d_plain(qbase, in_keys, in_feats, weights, D, H, W,
                        kernel_size: int = 3, scale=None, shift=None,
                        relu: bool = False, nbr=None) -> torch.Tensor:
    """Plain version of K8: the neighbour map (`neighbour_map`, unless a
    prebuilt one for these keys is given), then per tap a gather of the
    input rows (zero for misses) and one multiply-then-add per input
    channel, in the kernel's order."""
    w = _folded(weights, scale)
    b, vq = qbase.shape
    cin = in_feats.shape[-1]
    if nbr is None:
        nbr = neighbour_map(qbase, in_keys, D, H, W, kernel_size)
    else:
        _map_shape_ok(nbr, qbase, kernel_size)
    acc = in_feats.new_zeros((b, vq, w.shape[-1]))
    for k in range(nbr.shape[-1]):
        idx = nbr[..., k]
        hit = idx >= 0
        if not bool(hit.any()):
            continue            # adding zero products leaves every bit
        g = torch.gather(in_feats, 1, idx.clamp(min=0).long()[..., None]
                         .expand(-1, -1, cin))
        g = torch.where(hit[..., None], g, 0.)
        for c in range(cin):
            acc.add_(g[..., c:c + 1] * w[k * cin + c])
    return _epilogue(acc, qbase, D * H * W, shift, relu)


def _check_keys(qbase, in_keys, D, H, W, kernel_size):
    if qbase.dtype != torch.int32 or in_keys.dtype != torch.int32:
        raise TypeError("the sparse conv kernels take int32 keys, got {} "
                        "and {}".format(qbase.dtype, in_keys.dtype))
    if kernel_size not in (1, 3):
        raise ValueError("kernel_size must be 1 or 3")
    if (qbase.dim() != 2 or in_keys.dim() != 2 or
            in_keys.shape[0] != qbase.shape[0] or in_keys.shape[1] < 1):
        raise ValueError("qbase [B, Vq] and in_keys [B, Vin >= 1] expected, "
                         "got {} and {}".format(tuple(qbase.shape),
                                                tuple(in_keys.shape)))
    # keys, their padding sentinels and the span bounds stay in int32
    if (D * H * W + H * W + W + 8 + max(qbase.shape[1],
                                        in_keys.shape[1])) >= 2 ** 31:
        raise ValueError("grid {} too large for int32 keys".format(
            (D, H, W)))
    if in_keys.device != qbase.device:
        raise ValueError("the sparse conv's keys lie on different devices")
    if not (qbase.is_contiguous() and in_keys.is_contiguous()):
        raise ValueError("the sparse conv kernels need contiguous keys")


def _check(qbase, in_keys, in_feats, w, shift, nbr, D, H, W, kernel_size):
    _check_keys(qbase, in_keys, D, H, W, kernel_size)
    if in_feats.dtype != torch.float32 or w.dtype != torch.float32 or (
            shift is not None and shift.dtype != torch.float32):
        raise TypeError("sparse_conv3d kernel takes f32 features, weights "
                        "and shift")
    b, vq = qbase.shape
    vin, cin = in_keys.shape[1], in_feats.shape[-1]
    cout = w.shape[-1]
    if (tuple(in_feats.shape) != (b, vin, cin) or
            tuple(w.shape) != (kernel_size ** 3 * cin, cout) or
            (shift is not None and tuple(shift.shape) != (cout,))):
        raise ValueError(
            "in_feats [B, Vin, Cin], weights [K^3 * Cin, Cout] and shift "
            "[Cout] expected, got {}, {}, {}".format(
                tuple(in_feats.shape), tuple(w.shape),
                None if shift is None else tuple(shift.shape)))
    if cout % _COUT_STEP or not _COUT_STEP <= cout <= _COUT_MAX:
        raise ValueError("the sparse_conv3d kernel takes a multiple of {} "
                         "up to {} output channels, got {}".format(
                             _COUT_STEP, _COUT_MAX, cout))
    tensors = [in_feats, w] + [t for t in (shift, nbr) if t is not None]
    if nbr is not None:
        if nbr.dtype != torch.int32:
            raise TypeError("sparse_conv3d kernel takes an int32 map, got "
                            "{}".format(nbr.dtype))
        _map_shape_ok(nbr, qbase, kernel_size)
    if any(t.device != qbase.device for t in tensors):
        raise ValueError("sparse_conv3d inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sparse_conv3d kernel needs contiguous inputs")


def sparse_conv3d_map(qbase: torch.Tensor, in_keys: torch.Tensor, D: int,
                      H: int, W: int, kernel_size: int = 3) -> torch.Tensor:
    """The neighbour map of query keys qbase [B, Vq] over the sorted input
    keys in_keys [B, Vin] (both int32, as `sparse_conv3d` takes them) ->
    nbr [B, Vq, K^3] int32, `neighbour_map`'s contract. On a CUDA tensor the
    map kernel builds it; on a CPU tensor `neighbour_map`. One map serves
    every conv with these query keys, input keys, grid and kernel size."""
    if not qbase.is_cuda:
        return neighbour_map(qbase, in_keys, D, H, W, kernel_size)
    _check_keys(qbase, in_keys, D, H, W, kernel_size)
    b, vq = qbase.shape
    nbr = torch.empty((b, vq, kernel_size ** 3), dtype=torch.int32,
                      device=qbase.device)
    err = _build.function("p3d_sparse_conv_map")(
        qbase.data_ptr(), in_keys.data_ptr(), nbr.data_ptr(), b, vq,
        in_keys.shape[1], D, H, W, kernel_size,
        _build.stream_ptr(qbase.device))
    _build.check(err, "sparse_conv3d_map")
    _build.LAUNCHES["sparse_conv3d_map"] += 1
    return nbr


def sparse_conv3d(qbase: torch.Tensor, in_keys: torch.Tensor,
                  in_feats: torch.Tensor, weights: torch.Tensor, D: int,
                  H: int, W: int, kernel_size: int = 3, scale=None,
                  shift=None, relu: bool = False, nbr=None) -> torch.Tensor:
    """Sparse 3-D conv on sorted keys, K = 1 or 3 (the contract of the JAX
    package's sparse_conv3d_win).

    qbase [B, Vq] int32: the input-grid key of each output site (its own
    key for a submanifold conv, the key of out_coord * stride for a strided
    one), sorted ascending per row, padding rows >= D*H*W. in_keys
    [B, Vin] int32: the input's active keys, sorted and distinct, padding
    rows >= D*H*W (distinct sentinels). in_feats [B, Vin, Cin] f32, zero on
    padding rows. weights [K^3 * Cin, Cout], row kidx * Cin + cin with
    kidx over (dz, dy, dx) as ops/sparse.kernel_offsets orders them. nbr:
    the neighbour map of qbase over in_keys (`sparse_conv3d_map`) when the
    caller has one, else it is built here.
    -> out [B, Vq, Cout] f32: conv(x) * scale + shift (scale folded into
    the weights), then the optional relu, on valid rows (0 <= qbase <
    D*H*W); padding rows are exactly zero."""
    if not qbase.is_cuda:
        return sparse_conv3d_plain(qbase, in_keys, in_feats, weights, D, H,
                                   W, kernel_size, scale, shift, relu, nbr)
    w = _folded(weights, scale).contiguous()
    if w.data_ptr() % 16:           # the kernel reads float4 weight rows
        w = w.clone()
    _check(qbase, in_keys, in_feats, w, shift, nbr, D, H, W, kernel_size)
    if nbr is None:
        nbr = sparse_conv3d_map(qbase, in_keys, D, H, W, kernel_size)
    b, vq = qbase.shape
    out = torch.empty((b, vq, w.shape[-1]), dtype=torch.float32,
                      device=qbase.device)
    err = _build.function("p3d_sparse_conv3d")(
        qbase.data_ptr(), nbr.data_ptr(), in_feats.data_ptr(), w.data_ptr(),
        None if shift is None else shift.data_ptr(), out.data_ptr(), b, vq,
        in_keys.shape[1], in_feats.shape[-1], w.shape[-1], D * H * W,
        kernel_size, int(relu), _build.stream_ptr(qbase.device))
    _build.check(err, "sparse_conv3d")
    _build.LAUNCHES["sparse_conv3d"] += 1
    return out
