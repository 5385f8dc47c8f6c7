// Row gather (K14): out[b, i, :] = src[b, idx[b, i], :].
//
// Replaces the TPU kernel paddle3d_tpu/ops/pallas/gather.py:_gather_kernel
// (entry _pallas_gather, public gather_rows), which streams the requested
// rows with a ring of single-row DMAs because XLA on that TPU lowered a
// batched row gather to a select cascade. The port's SMOKE decode calls it
// (models/detection/smoke/smoke.py: top-k rows of the NCHW regression map,
// read in place through a strided view); ops/gather.gather_rows wraps it.
//
// Out-of-range indices follow the JAX function's CPU form
// (jnp.take_along_axis): an index in [-A, 0) wraps once to idx + A, any
// other index outside [0, A) gives a row of NaN. (The Pallas kernel has no
// defined answer for them.)
//
// What bounds it on the H100: bytes, and at small shapes one launch's
// latency. Each output row is one source row read and one row written,
// plus its index: a voxel-row gather (4 x 120,000 rows of 64 channels)
// moves ~246 MB, 0.074 ms at the card's memory rate; gather.py's shape
// (8 x 1,000 rows of 7) ~0.45 MB and SMOKE's decode (B x 50 rows of 10)
// a few KB, both far below one launch.
//
// Design. The first version gave each output row a warp whose lane 0 read
// the index before the row load, so a warp kept one row in flight and at
// c = 64 half its lanes idle. Here:
//   * a group of lanes sized to the row serves it: c / 4 lanes for rows
//     of float4s (two rows a warp at c = 64, eight at c = 16); a row wider
//     than 32 float4s is cut into pieces of 32;
//   * a warp's indices come in one coalesced load (a lane an index) and
//     reach their groups by shuffles;
//   * each thread issues its loads for kInFlight pieces before its first
//     store, so a warp keeps up to 32 rows in flight (one piece a thread
//     where that would leave SMs idle);
//   * a strided source (SMOKE's NCHW map as [B, H*W, C] with channel stride
//     H*W) is read in place, one float a lane, in the flat form;
//   * rows that are not whole float4s take the flat form: a thread
//     kInFlight output floats a block apart, every lane busy (c lanes a
//     row, a float each, left lanes idle and measured 13-14 % slower at
//     8 x 100,000 x 3; the flat form on float4 rows 1.9x slower than lane
//     groups: PERF.md, PR 18).
//
// Built by ops/_build.py with nvcc for sm_90a into the git-ignored
// build/torch_kernels/, with the other csrc/ sources, and bound with
// ctypes through a plain C entry point.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kInFlight = 4;  // pieces (or floats) a thread loads at once
constexpr long long kMaxOut = INT_MAX - 2 * kThreads * kInFlight;

struct Args {
  const float* src;
  long long ssb, ssa, ssc;  // element strides of src [B, A, C]
  const int* idx;           // [B, K] contiguous
  float* out;               // [B, K, C] contiguous
  int a, k, c;
  int units;    // float4s a row: c / 4
  int pieces;   // pieces a row: ceil(units / g)
  int g;        // lanes a piece
  int r;        // pieces a warp serves at once: 32 / g
  int u;        // such sets a warp loads before storing (r * u <= 32)
  int total;    // pieces in all: B * K * pieces
};

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// The row index a piece reads: wrapped once, or -1 when out of range.
__device__ __forceinline__ int wrap(int j, int a) {
  if (j < 0) j += a;
  return (j < 0 || j >= a) ? -1 : j;
}

// Lane groups on rows of whole float4s.
__global__ void __launch_bounds__(kThreads)
    gather_rows_group_kernel(const Args p) {
  const int lane = threadIdx.x & 31;
  const int w = p.r * p.u;  // pieces of this warp
  const int first = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * w;
  if (first >= p.total) return;
  // one coalesced load of the warp's indices: lane l holds piece first + l's
  int mine = 0;
  if (lane < w && first + lane < p.total) {
    mine = p.idx[(first + lane) / p.pieces];
  }
  const int grp = lane / p.g;  // the piece of a set this lane serves
  const int sub = lane - grp * p.g;
  const bool active = grp < p.r;
  float4 val[kInFlight];
  int row[kInFlight], unit[kInFlight];
#pragma unroll
  for (int t = 0; t < kInFlight; ++t) {
    const int q = t * p.r + grp;  // < 32 for an active lane of a used set
    const int j = __shfl_sync(0xffffffffu, mine, active ? (q & 31) : 0);
    const int pc = first + q;
    row[t] = -1;
    if (!active || t >= p.u || pc >= p.total) continue;
    const int rw = pc / p.pieces;
    unit[t] = (pc - rw * p.pieces) * p.g + sub;
    if (unit[t] >= p.units) continue;
    row[t] = rw;
    const int jj = wrap(j, p.a);
    if (jj < 0) {
      val[t] = make_float4(nan_f(), nan_f(), nan_f(), nan_f());
      continue;
    }
    const float* s = p.src + static_cast<long long>(rw / p.k) * p.ssb +
                     static_cast<long long>(jj) * p.ssa;
    val[t] = __ldg(reinterpret_cast<const float4*>(s) + unit[t]);
  }
#pragma unroll
  for (int t = 0; t < kInFlight; ++t) {
    if (row[t] < 0) continue;
    reinterpret_cast<float4*>(p.out + static_cast<long long>(row[t]) * p.c)
        [unit[t]] = val[t];
  }
}

// The flat form: thread t of a block writes the block's outputs t,
// t + kThreads, ... (kU of them), each reading its own row's index (the
// lanes of a row share it through L1).
template <int kU>
__global__ void __launch_bounds__(kThreads) gather_rows_flat_kernel(
    const Args p, int nout) {
  const int first = blockIdx.x * (kThreads * kU) + threadIdx.x;
  int e[kU], j[kU];
#pragma unroll
  for (int t = 0; t < kU; ++t) {
    e[t] = first + t * kThreads;
    j[t] = e[t] < nout ? p.idx[e[t] / p.c] : 0;
  }
  float val[kU];
#pragma unroll
  for (int t = 0; t < kU; ++t) {
    if (e[t] >= nout) continue;
    const int rw = e[t] / p.c;
    const int ch = e[t] - rw * p.c;
    const int jj = wrap(j[t], p.a);
    val[t] = jj < 0 ? nan_f()
                    : __ldg(p.src + static_cast<long long>(rw / p.k) * p.ssb +
                            static_cast<long long>(jj) * p.ssa +
                            static_cast<long long>(ch) * p.ssc);
  }
#pragma unroll
  for (int t = 0; t < kU; ++t) {
    if (e[t] < nout) p.out[e[t]] = val[t];
  }
}

// The SM count of the current device (cached per device).
cudaError_t sm_count(int* sms) {
  static int cache[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cache[dev] > 0) {
    *sms = cache[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) cache[dev] = *sms;
  return err;
}

int launch(const float* src, long long ssb, long long ssa, long long ssc,
           const int* idx, float* out, int b, int a, int k, int c,
           cudaStream_t stream) {
  if (c < 0 || a < 0 || k < 0 || b < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long nout = static_cast<long long>(b) * k * c;
  if (nout == 0) return static_cast<int>(cudaSuccess);
  // 32-bit positions: a grid's last block may run kThreads * kInFlight
  // past the end
  if (nout > kMaxOut) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = ssc == 1 && c % 4 == 0 && ssa % 4 == 0 && ssb % 4 == 0 &&
                   reinterpret_cast<size_t>(src) % 16 == 0 &&
                   reinterpret_cast<size_t>(out) % 16 == 0;
  Args p{src, ssb, ssa, ssc, idx, out, a, k, c, 0, 0, 0, 0, 0, 0};
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a grid of fewer than two blocks an SM leaves SMs idle at the small
  // shapes: there a thread loads one unit, so the work spreads
  const long long few = 2LL * sms * kThreads * kInFlight;
  // rows of whole float4s take lane groups, other rows the flat form
  if (!vec) {
    const bool wide = nout >= few;
    const int per_block = kThreads * (wide ? kInFlight : 1);
    const unsigned grid =
        static_cast<unsigned>((nout + per_block - 1) / per_block);
    if (wide) {
      gather_rows_flat_kernel<kInFlight><<<grid, kThreads, 0, stream>>>(
          p, static_cast<int>(nout));
    } else {
      gather_rows_flat_kernel<1><<<grid, kThreads, 0, stream>>>(
          p, static_cast<int>(nout));
    }
    return static_cast<int>(cudaGetLastError());
  }
  p.units = c / 4;
  p.g = p.units < 32 ? p.units : 32;
  p.pieces = (p.units + p.g - 1) / p.g;
  p.r = 32 / p.g;
  const long long total = static_cast<long long>(b) * k * p.pieces;
  p.total = static_cast<int>(total);  // <= nout
  p.u = 32 / p.r < kInFlight ? 32 / p.r : kInFlight;
  if (total < 2LL * sms * kWarps * p.r * p.u) p.u = 1;  // spread out
  const int per_warp = p.r * p.u;
  const long long warps = (total + per_warp - 1) / per_warp;
  const unsigned grid = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  gather_rows_group_kernel<<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src: element (b, a, ch) at src[b*ssb + a*ssa + ch*ssc]; idx [b, k] int32;
// out [b, k, c] contiguous, at most INT_MAX - 2,048 values. Returns
// cudaGetLastError().
extern "C" int p3d_gather_rows(const float* src, long long ssb, long long ssa,
                               long long ssc, const int* idx, float* out,
                               int b, int a, int k, int c, void* stream) {
  return launch(src, ssb, ssa, ssc, idx, out, b, a, k, c,
                static_cast<cudaStream_t>(stream));
}
