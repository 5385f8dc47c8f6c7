// Segmented window max with arg-max offsets (K12), and its backward.
//
//   out[b, j, c] = max over rows i in [j - win, j + win] ∩ [0, n) with
//                  keys[b, i] == keys[b, j] of vals[b, i, c]
//   off[b, j, c] = i - j of the row that gave it (int8, |off| <= win)
//   gin[b, j, c] = sum over |s| <= win of [off[b, j+s, c] == -s] g[b, j+s, c]
//
// with win = 2^steps - 1. Replaces the TPU kernels
// paddle3d_tpu/ops/pallas/seg_window.py:_fwd_kernel (entry _fwd) and
// _bwd_kernel (entry _vjp_bwd). Those see each row block beside a halo
// array the host builds with pad + reshape passes (_halo); nothing of that
// is carried over: a block here stages its own halo.
//
// The offsets are index-valued: a different winner on a tie is a different
// gradient. So the forward runs the Pallas kernel's doubling in its merge
// order, step by step over one snapshot: for d = 1, 2, ..., 2^(steps-1),
// the row d below wins on strictly greater, then the row d above on
// strictly greater than the updated best (ops/seg_window.py's plain version
// does the same on whole arrays). The backward adds, for each row, its own
// cotangent where its offset is 0, then for s = 1..win the cotangent of row
// j+s where that row's offset is -s and of row j-s where it is +s, in that
// order, each addition rounded on its own (__fadd_rn): the plain version's
// order, so both are bit-equal to it. Rows outside [0, n) carry key -3
// (callers' keys are >= -2), value -inf and cotangent 0.
//
// What bounds them on the H100: bytes. Each element is read once (4 bytes)
// and written once with its offset (4 + 1 bytes), or read with its offset
// and written once in the backward; the work is a few compares a step.
//
// Design: a block owns kRows = 256 rows of one batch row and kCh = 32
// channels (one lane each, channels fastest: a warp reads 128 contiguous
// bytes of a row), plus win rows of halo on each side, staged in dynamic
// shared memory. The forward double-buffers values and offsets across the
// doubling steps (each step reads the snapshot and writes the other buffer);
// 8 warps stride over the rows. At win = 31 a forward block takes 103 KB and
// a backward block 51 KB of shared memory.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRows = 256;              // centre rows per block
constexpr int kCh = 32;                 // channels per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kInvalid = -3;            // key of rows outside the array

__host__ __device__ inline size_t fwd_smem(int win) {
  const size_t len = kRows + 2 * win;
  return len * sizeof(int) + 2 * len * kCh * (sizeof(float) + 1);
}

__host__ __device__ inline size_t bwd_smem(int win) {
  const size_t len = kRows + 2 * win;
  return len * kCh * (sizeof(float) + 1);
}

__global__ void __launch_bounds__(kThreads)
seg_window_fwd_kernel(const float* __restrict__ vals,
                      const int* __restrict__ keys, float* __restrict__ out,
                      signed char* __restrict__ off, int n, int c, int steps,
                      int win) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int len = kRows + 2 * win;
  int* s_key = reinterpret_cast<int*>(smem);
  float* s_val = reinterpret_cast<float*>(s_key + len);       // 2 buffers
  signed char* s_off = reinterpret_cast<signed char*>(s_val + 2 * len * kCh);

  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRows - win;    // absolute row of e = 0
  const int lane = threadIdx.x & 31;
  const int wy = threadIdx.x >> 5;
  const int ch = blockIdx.y * kCh + lane;
  const bool live_ch = ch < c;
  const float neg = -__int_as_float(0x7f800000);

  for (int e = threadIdx.x; e < len; e += kThreads) {
    const int r = row0 + e;
    s_key[e] = (r >= 0 && r < n) ? keys[static_cast<size_t>(b) * n + r]
                                 : kInvalid;
  }
  for (int e = wy; e < len; e += kWarps) {
    const int r = row0 + e;
    float v = neg;
    if (live_ch && r >= 0 && r < n) {
      v = vals[(static_cast<size_t>(b) * n + r) * c + ch];
    }
    s_val[e * kCh + lane] = v;
    s_off[e * kCh + lane] = 0;
  }
  __syncthreads();

  int cur = 0;
  for (int s = 0; s < steps; ++s) {
    const int d = 1 << s;
    const float* a_val = s_val + cur * len * kCh;
    const signed char* a_off = s_off + cur * len * kCh;
    float* b_val = s_val + (cur ^ 1) * len * kCh;
    signed char* b_off = s_off + (cur ^ 1) * len * kCh;
    for (int e = wy; e < len; e += kWarps) {
      const int key = s_key[e];
      float best = a_val[e * kCh + lane];
      int o = a_off[e * kCh + lane];
      float cand_dn = neg, cand_up = neg;
      int off_dn = 0, off_up = 0;
      if (e - d >= 0 && s_key[e - d] == key) {
        cand_dn = a_val[(e - d) * kCh + lane];
        off_dn = a_off[(e - d) * kCh + lane] - d;
      }
      if (e + d < len && s_key[e + d] == key) {
        cand_up = a_val[(e + d) * kCh + lane];
        off_up = a_off[(e + d) * kCh + lane] + d;
      }
      if (cand_dn > best) {
        best = cand_dn;
        o = off_dn;
      }
      if (cand_up > best) {
        best = cand_up;
        o = off_up;
      }
      b_val[e * kCh + lane] = best;
      b_off[e * kCh + lane] = static_cast<signed char>(o);
    }
    __syncthreads();
    cur ^= 1;
  }

  if (!live_ch) return;
  const float* a_val = s_val + cur * len * kCh;
  const signed char* a_off = s_off + cur * len * kCh;
  for (int e = win + wy; e < win + kRows; e += kWarps) {
    const int r = row0 + e;
    if (r >= n) break;
    const size_t at = (static_cast<size_t>(b) * n + r) * c + ch;
    out[at] = a_val[e * kCh + lane];
    off[at] = a_off[e * kCh + lane];
  }
}

__global__ void __launch_bounds__(kThreads)
seg_window_bwd_kernel(const signed char* __restrict__ off,
                      const float* __restrict__ g, float* __restrict__ gin,
                      int n, int c, int win) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int len = kRows + 2 * win;
  float* s_g = reinterpret_cast<float*>(smem);
  signed char* s_off = reinterpret_cast<signed char*>(s_g + len * kCh);

  const int b = blockIdx.z;
  const int row0 = blockIdx.x * kRows - win;
  const int lane = threadIdx.x & 31;
  const int wy = threadIdx.x >> 5;
  const int ch = blockIdx.y * kCh + lane;
  const bool live_ch = ch < c;

  for (int e = wy; e < len; e += kWarps) {
    const int r = row0 + e;
    float v = 0.f;
    int o = 0;
    if (live_ch && r >= 0 && r < n) {
      const size_t at = (static_cast<size_t>(b) * n + r) * c + ch;
      v = g[at];
      o = off[at];
    }
    s_g[e * kCh + lane] = v;
    s_off[e * kCh + lane] = static_cast<signed char>(o);
  }
  __syncthreads();
  if (!live_ch) return;

  for (int e = win + wy; e < win + kRows; e += kWarps) {
    const int r = row0 + e;
    if (r >= n) break;
    float acc = s_off[e * kCh + lane] == 0 ? s_g[e * kCh + lane] : 0.f;
    for (int s = 1; s <= win; ++s) {
      const int up = (e + s) * kCh + lane;
      const int dn = (e - s) * kCh + lane;
      acc = __fadd_rn(acc, s_off[up] == -s ? s_g[up] : 0.f);
      acc = __fadd_rn(acc, s_off[dn] == s ? s_g[dn] : 0.f);
    }
    gin[(static_cast<size_t>(b) * n + r) * c + ch] = acc;
  }
}

dim3 grid_for(int b, int n, int c) {
  return dim3((n + kRows - 1) / kRows, (c + kCh - 1) / kCh, b);
}

}  // namespace

// vals [b, n, c] f32 and keys [b, n] int32 (sorted per batch row, >= -2),
// contiguous; out [b, n, c] f32 and off [b, n, c] int8, every element
// written. steps = ceil(log2 max_len), at most 7 (int8 offsets). Returns
// cudaGetLastError().
extern "C" int p3d_seg_window_max(const float* vals, const int* keys,
                                  float* out, signed char* off, int b, int n,
                                  int c, int steps, void* stream) {
  if (steps < 0 || steps > 7 || n < 0 || c < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0 || c == 0) return static_cast<int>(cudaSuccess);
  if (b > 65535 || (c + kCh - 1) / kCh > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int win = (1 << steps) - 1;
  const size_t smem = fwd_smem(win);
  cudaError_t err = cudaFuncSetAttribute(
      seg_window_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_window_fwd_kernel<<<grid_for(b, n, c), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      vals, keys, out, off, n, c, steps, win);
  return static_cast<int>(cudaGetLastError());
}

// off [b, n, c] int8 (from p3d_seg_window_max) and g [b, n, c] f32,
// contiguous; gin [b, n, c] f32, every element written. win = 2^steps - 1
// of the forward, at most 127. Returns cudaGetLastError().
extern "C" int p3d_seg_window_max_bwd(const signed char* off, const float* g,
                                      float* gin, int b, int n, int c,
                                      int win, void* stream) {
  if (win < 0 || win > 127 || n < 0 || c < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0 || c == 0) return static_cast<int>(cudaSuccess);
  if (b > 65535 || (c + kCh - 1) / kCh > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = bwd_smem(win);
  cudaError_t err = cudaFuncSetAttribute(
      seg_window_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_window_bwd_kernel<<<grid_for(b, n, c), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      off, g, gin, n, c, win);
  return static_cast<int>(cudaGetLastError());
}
