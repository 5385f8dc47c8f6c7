// Row gather (K14): out[b, i, :] = src[b, idx[b, i], :].
//
// Replaces the TPU kernel paddle3d_tpu/ops/pallas/gather.py:_gather_kernel
// (entry _pallas_gather, public gather_rows), which streams the requested
// rows with a ring of single-row DMAs because XLA on that TPU lowered a
// batched row gather to a select cascade. No path of the JAX package calls
// it; the port carries it as an op, ops/gather.gather_rows.
//
// Out-of-range indices follow the JAX function's CPU form
// (jnp.take_along_axis): an index in [-A, 0) wraps once to idx + A, any
// other index outside [0, A) gives a row of NaN. (The Pallas kernel has no
// defined answer for them.)
//
// What bounds it on the H100: bytes. Each output row is one source row read
// and one row written, plus its index: at gather.py's shape (8 x 1,000 rows
// of 7 channels from 107,136 anchors) ~0.45 MB, at a voxel-row gather's
// (4 x 120,000 rows of 64 from 160,000) ~246 MB.
//
// Design: one warp an output row. Lane 0 reads the index and broadcasts it;
// the lanes copy the row's channels, as 16-byte vectors when the channels
// are unit-strided, a multiple of four and 16-byte aligned, else one float
// a lane (src may be any strided view). The TPU kernel's lane padding to
// 128 and its DMA ring have no counterpart here.
//
// Built by ops/_build.py with nvcc for sm_90a into the git-ignored
// build/torch_kernels/, with the other csrc/ sources, and bound with
// ctypes through a plain C entry point.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const float* __restrict__ src, long long ssb,
                       long long ssa, long long ssc,
                       const int* __restrict__ idx, float* __restrict__ out,
                       int a, int k, int c, long long nrows) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= nrows) return;
  const int lane = threadIdx.x & 31;
  int j = 0;
  if (lane == 0) j = idx[row];
  j = __shfl_sync(0xffffffffu, j, 0);
  if (j < 0) j += a;  // wrap once, as take_along_axis does
  float* o = out + row * c;
  if (j < 0 || j >= a) {
    for (int ch = lane; ch < c; ch += 32) o[ch] = __int_as_float(0x7fc00000);
    return;
  }
  const float* s = src + (row / k) * ssb + j * ssa;
  if (kVec) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    float4* o4 = reinterpret_cast<float4*>(o);
    for (int v = lane; v < c / 4; v += 32) o4[v] = __ldg(s4 + v);
  } else {
    for (int ch = lane; ch < c; ch += 32) o[ch] = __ldg(s + ch * ssc);
  }
}

}  // namespace

// src: element (b, a, ch) at src[b*ssb + a*ssa + ch*ssc]; idx [b, k] int32;
// out [b, k, c] contiguous. Returns cudaGetLastError().
extern "C" int p3d_gather_rows(const float* src, long long ssb, long long ssa,
                               long long ssc, const int* idx, float* out,
                               int b, int a, int k, int c, void* stream) {
  if (c < 0 || a < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long nrows = static_cast<long long>(b) * k;
  if (nrows == 0 || c == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((nrows + kWarps - 1) / kWarps));
  const bool vec = ssc == 1 && c % 4 == 0 && ssa % 4 == 0 && ssb % 4 == 0 &&
                   reinterpret_cast<size_t>(src) % 16 == 0 &&
                   reinterpret_cast<size_t>(out) % 16 == 0;
  if (vec) {
    gather_rows_kernel<true><<<grid, kThreads, 0, s>>>(src, ssb, ssa, ssc,
                                                       idx, out, a, k, c,
                                                       nrows);
  } else {
    gather_rows_kernel<false><<<grid, kThreads, 0, s>>>(src, ssb, ssa, ssc,
                                                        idx, out, a, k, c,
                                                        nrows);
  }
  return static_cast<int>(cudaGetLastError());
}
