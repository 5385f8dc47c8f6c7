"""Index-valued camera geometry in the arithmetic the JAX package compiles
to under jit on the CPU.

A frustum point's voxel or depth bin is the floor of a computed value: a
point on a voxel face lands on one side or the other by the last bit of
its coordinates. The camera models' parity tests hold the port's ranks
index for index against the JAX functions under jax.jit, so the port
computes those coordinates in the order and the roundings XLA's CPU
backend gives them, found by comparing bit patterns on the JAX package's
own functions:

  * jnp.linspace(0, stop, n) is i * (stop / (n - 1)), then stop
    (jax_linspace);
  * a division of a computed value by a constant is a product with the
    constant's rounded reciprocal (reciprocal);
  * an einsum of 3 x 3 matrices with a stack of 3-vectors sums row 2 as
    a chain of fused multiply-adds, fma(m2, v2, fma(m1, v1, m0 v0)), and
    rows 0 and 1 as (p0 + p1) + p2 or as the chain, by the dot XLA emits
    for it: in LSSViewTransformer.get_lidar_coor the per-camera einsums
    sum rows 0 and 1 plainly, the BEV augmentation's (one matrix a frame)
    does for a batch of one frame and chains them for more (matvec3;
    found at one frame of six cameras and two of two); the 3 x 3 by
    3 x 3 product is chains throughout (matmul3);
  * jnp.linalg.inv is LAPACK's getrf then two trsm solves (inv3).

Every step is an elementwise torch op (no matmul, no library solver), so
the card and the CPU compute the same bits: cuBLAS, cuSOLVER and the CUDA
compiler's contraction of a * b + c never enter. An f32 fused
multiply-add is computed in f64, where the product is exact (fma). In f64
the same formulas run with plain products and sums: the JAX package's f64
steps are compared with a tolerance there, not bit for bit.
"""
import torch

__all__ = ["jax_linspace", "reciprocal", "fma", "matvec3", "matmul3",
           "inv3"]


def jax_linspace(stop: float, num: int, dtype) -> torch.Tensor:
    """jnp.linspace(0, stop, num) in the arithmetic XLA compiles it to:
    i * (stop / (num - 1)) for i < num - 1, rounded in dtype, then stop
    (torch.linspace rounds otherwise)."""
    if num == 1:
        return torch.zeros(1, dtype=dtype)
    delta = torch.tensor(stop, dtype=dtype) / (num - 1)
    return torch.cat([torch.arange(num - 1, dtype=dtype) * delta,
                      torch.full((1,), stop, dtype=dtype)])


def reciprocal(v: float, like: torch.Tensor) -> torch.Tensor:
    """1 / v rounded in like's dtype, as a one-element tensor on like's
    device. Under jit XLA turns a division by a constant (the voxel size,
    the bin size) into a multiplication by this reciprocal; the port
    multiplies by it too, so that a value on a voxel face or a bin edge
    falls on the same side."""
    one = torch.ones(1, dtype=like.dtype)
    return (one / torch.tensor(v, dtype=like.dtype)).to(like.device)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once, in the dtype of the result of a * b + c. In
    f32 the product and the sum are taken in f64: the product of two f32
    values is exact there, and the sum rounds to f64 before f32 (a double
    rounding that differs from a true fused multiply-add only when the
    f64 sum lies on an f32 midpoint)."""
    if torch.result_type(a, b) == torch.float32:
        return (a.double() * b.double() + c.double()).float()
    return a * b + c


def matvec3(m: torch.Tensor, v, chain_rows01: bool) -> list:
    """The einsum "...ij,...j->...i" of a [..., 3, 3] matrix (broadcast
    against the vectors) with the 3-vectors v = [v0, v1, v2] (tensors of
    one shape): row 2 a chain of fused multiply-adds, rows 0 and 1 the
    chain too with chain_rows01, else summed as (p0 + p1) + p2.
    -> [out0, out1, out2]."""
    out = []
    for i in range(3):
        if i < 2 and not chain_rows01:
            out.append((m[..., i, 0] * v[0] + m[..., i, 1] * v[1]) +
                       m[..., i, 2] * v[2])
        else:
            out.append(fma(m[..., i, 2], v[2], fma(m[..., i, 1], v[1],
                                                   m[..., i, 0] * v[0])))
    return out


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of [..., 3, 3] matrices, each entry the fused-multiply-add
    chain fma(a_i2, b_2k, fma(a_i1, b_1k, a_i0 b_0k)) (the JAX package's
    jnp.einsum("bnij,bnjk->bnik") under jit)."""
    rows = []
    for i in range(3):
        rows.append(torch.stack([
            fma(a[..., i, 2], b[..., 2, k], fma(
                a[..., i, 1], b[..., 1, k], a[..., i, 0] * b[..., 0, k]))
            for k in range(3)], dim=-1))
    return torch.stack(rows, dim=-2)


def _pick(rows, p, first):
    """Rows `first` and p (p >= first, a tensor [...]) swapped, the rest
    kept: rows a list of [..., 3] tensors."""
    out = list(rows)
    for k in range(first + 1, len(rows)):
        hit = (p == k)[..., None]
        out[first] = torch.where(hit, rows[k], out[first])
        out[k] = torch.where(hit, rows[first], rows[k])
    return out


def inv3(m: torch.Tensor) -> torch.Tensor:
    """The inverse of [..., 3, 3] matrices as jnp.linalg.inv computes it
    on the CPU: LAPACK's getrf (OpenBLAS's left-looking getf2: partial
    pivoting on the first largest magnitude, the column below a pivot
    scaled by its reciprocal) on the matrix, then the permuted identity
    through the unit-lower and the upper trsm (the diagonal applied as
    its reciprocal), each step in the roundings those kernels give."""
    rows = [m[..., i, :] for i in range(3)]
    mag = torch.stack([r[..., 0].abs() for r in rows], dim=-1)
    p0 = torch.argmax(mag, dim=-1)           # the first of equal maxima
    rows = _pick(rows, p0, 0)
    a0, a1, a2 = rows
    r0 = 1.0 / a0[..., 0]
    l10, l20 = a1[..., 0] * r0, a2[..., 0] * r0
    u01 = a0[..., 1]
    b1 = a1[..., 1] - u01 * l10
    b2 = a2[..., 1] - u01 * l20
    p1 = 1 + (b2.abs() > b1.abs()).long()
    # the second pivot swaps rows 1 and 2 of L's first column, of the
    # column being factored and of the rest
    swap = p1 == 2
    l10, l20 = torch.where(swap, l20, l10), torch.where(swap, l10, l20)
    b1, b2 = torch.where(swap, b2, b1), torch.where(swap, b1, b2)
    c1 = torch.where(swap, a2[..., 2], a1[..., 2])
    c2 = torch.where(swap, a1[..., 2], a2[..., 2])
    u11 = b1
    r1 = 1.0 / u11
    l21 = b2 * r1
    u02 = a0[..., 2]
    u12 = c1 - l10 * u02
    u22 = c2 - fma(l21, u12, l20 * u02)
    r2 = 1.0 / u22

    # the permutation: row i of the solve's right side is e_{perm[i]}
    idx = torch.arange(3, device=m.device).expand(p0.shape + (3,))
    perm = [idx[..., i] for i in range(3)]
    perm = _pick([q[..., None] for q in perm], p0, 0)
    perm = _pick(perm, p1, 1)
    eye = [(q == torch.arange(3, device=m.device)).to(m.dtype)
           for q in perm]                    # rows of P, [..., 3]
    # unit lower, column by column
    y0 = eye[0]
    y1 = fma(-y0, l10[..., None], eye[1])
    y2 = fma(-y1, l21[..., None], fma(-y0, l20[..., None], eye[2]))
    # upper, the last row first
    x2 = y2 * r2[..., None]
    t0 = y0 - u02[..., None] * x2
    t1 = y1 - u12[..., None] * x2
    x1 = t1 * r1[..., None]
    x0 = fma(-u01[..., None], x1, t0) * r0[..., None]
    return torch.stack([x0, x1, x2], dim=-2)
