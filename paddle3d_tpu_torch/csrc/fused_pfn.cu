// Fused pillar feature net, eval: cell-sorted points -> each pillar's PFN
// max feature on its emission row (its last kept row), zero elsewhere, plus
// an optional occupancy channel.
//
// Replaces the TPU kernel paddle3d_tpu/ops/pallas/fused_pfn.py:_kernel with
// its _decorate (entry fused_pfn_rows), for one BN-folded PFN layer
// (p3d_fused_pfn_rows) or two (p3d_fused_pfn2_rows, below).
//
// Semantics kept exactly: a row's rank is its arrival order within its
// pillar (the sort is stable), and a row is kept when rank < P and the
// pillar's ordinal in key order is below max_voxels. The decoration is the
// point, xyz minus the mean over the pillar's kept rows, and x/y minus the
// pillar centre; then relu(W x + b) and the max over the kept rows. The
// pillar ordinal (the TPU kernel's SMEM carry across its sequential grid)
// is computed by the wrapper as a cumsum of head flags and passed in
// `vox`: blocks here run in no order, so nothing can carry between them.
//
// What bounds it on the H100: neither bytes nor FLOPs at the KITTI shape
// (8 x 20,000 rows: ~2.6 MB of points in, ~42 MB of rows out, ~0.2 GFLOP),
// so it is launch- and latency-bound; the output write is the largest
// stream. Design: a block owns kRows output rows and stages their keys with
// a halo of P rows behind and one ahead, and their points with P-1 rows
// behind, in shared memory. One thread per row finds its rank by walking at
// most P same-key neighbours; only emission rows do more, summing the
// pillar's kept points for the mean. The 9 x u1 product runs in registers,
// one thread per (emission row, output channel), with the folded weights in
// shared memory; the max over the pillar is a loop over its <= P kept rows.
// The tile goes out through shared memory so the channel-major [B, C, N]
// writes are coalesced. The TPU's lane rolls and doubling scans have no
// counterpart.
//
// Two PFN layers (p3d_fused_pfn2_rows, the TPU kernel's n_layers == 2
// branch, CenterPoint-pillars): y1 = relu(W1 x + b1) on every kept row,
// m1 = the max of y1 over the pillar's kept rows, t = relu(W2 [y1, m1] +
// b2) on every kept row, and the max of t over them at the emission row.
// What bounds it: operations. At nuScenes (8 x 250,000 rows, u1 = 32,
// u2 = 64) ~2e6 kept rows each need 32 x 10 + 64 x 32 products (the m1
// half of W2 is per pillar), ~9 GFLOP of f32 outside the tensor cores,
// against ~40 MB of points in and ~512 MB of rows out. Design: a block owns
// the pillars whose emission row lies in its 64 rows (the train kernels'
// ownership rule, csrc/fused_pfn_train.cu): their rows all lie in the
// staged window. Each owned window row is decorated once and its y1
// computed once into shared memory (one thread per (row, channel)); m1 per
// emission row; then one thread per (emission row, output channel), the
// channel fastest so a warp shares its pillar and reads y1 and m1 as
// broadcasts and W2 (transposed in shared memory) conflict-free, starts
// from b2 + the m1 half of W2 and runs the y1 half over the pillar's <= P
// rows. Above 48 KB of shared memory the launch sets the attribute.
//
// Rounding: the rank rules and the decoration come from csrc/pfn_common.cuh,
// shared with the train kernels (K3/K4); sums, products and the centre use
// explicit round-to-nearest intrinsics, in the same order as the plain
// PyTorch version (paddle3d_tpu_torch/ops/fused_pfn.py: each product from
// its bias up in k order; the second layer's m1 half before its y1 half),
// so nvcc contracts nothing into an FMA and the two agree bit for bit.
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "pfn_common.cuh"

namespace {

using p3d::Geometry;
using p3d::kMaxCdec;
using p3d::kMaxCin;

constexpr int kRows = 128;
constexpr int kThreads = 256;

__host__ __device__ constexpr int key_window(int p) { return kRows + p + 1; }
__host__ __device__ constexpr int pts_window(int p) { return kRows + p - 1; }

size_t smem_bytes(int c_in, int c_dec, int u1, int p) {
  const size_t floats = static_cast<size_t>(u1) * c_dec + u1 +
                        static_cast<size_t>(c_in) * pts_window(p) +
                        5 * kRows + static_cast<size_t>(u1) * (kRows + 1);
  const size_t ints = key_window(p) + kRows;
  return floats * sizeof(float) + ints * sizeof(int);
}

__global__ void __launch_bounds__(kThreads)
    fused_pfn_kernel(const int* __restrict__ keys,
                     const float* __restrict__ pts,
                     const int* __restrict__ vox,
                     const float* __restrict__ w1t,
                     const float* __restrict__ b1, float* __restrict__ out,
                     int n, int c_in, int c_dec, int u1, int p,
                     int max_voxels, Geometry geo, int with_distance,
                     int occupancy) {
  extern __shared__ float smem[];
  const int kw = key_window(p);  // keys of rows [r0 - p, r0 + kRows]
  const int pw = pts_window(p);  // points of rows [r0 - p + 1, r0 + kRows)
  float* s_w = smem;                    // [u1][c_dec]
  float* s_b = s_w + u1 * c_dec;        // [u1]
  float* s_pts = s_b + u1;              // [c_in][pw]
  float* s_mean = s_pts + c_in * pw;    // [kRows][3]
  float* s_cx = s_mean + 3 * kRows;     // [kRows]
  float* s_cy = s_cx + kRows;           // [kRows]
  float* s_out = s_cy + kRows;          // [u1][kRows + 1], padded vs banks
  int* s_key = reinterpret_cast<int*>(s_out + u1 * (kRows + 1));  // [kw]
  int* s_rank = s_key + kw;  // [kRows]; -1 where the row emits nothing

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int* kb = keys + static_cast<size_t>(b) * n;
  const float* pb = pts + static_cast<size_t>(b) * c_in * n;

  for (int t = threadIdx.x; t < u1 * c_dec; t += blockDim.x) s_w[t] = w1t[t];
  for (int t = threadIdx.x; t < u1; t += blockDim.x) s_b[t] = b1[t];
  for (int t = threadIdx.x; t < kw; t += blockDim.x) {
    const int i = r0 - p + t;
    s_key[t] = i < 0 ? -1 : (i < n ? kb[i] : p3d::kSent);
  }
  for (int t = threadIdx.x; t < c_in * pw; t += blockDim.x) {
    const int ch = t / pw;
    const int i = r0 - p + 1 + (t - ch * pw);
    s_pts[t] = (i >= 0 && i < n) ? pb[static_cast<size_t>(ch) * n + i] : 0.f;
  }
  __syncthreads();

  // rank, keep, emit; mean and centre of each emitting row's pillar
  for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
    const int i = r0 + r;
    const int t = r + p;  // row i in s_key
    int emit_rank = -1;
    if (i < n) {
      emit_rank = p3d::emit_rank(s_key, t, p,
                                 vox[static_cast<size_t>(b) * n + i],
                                 max_voxels);
      if (emit_rank >= 0) {
        // kept rows are i - rank .. i, in row order; row i - rank is
        // s_pts column r + p - 1 - rank
        p3d::pillar_mean(s_pts, pw, r + p - 1 - emit_rank, emit_rank,
                         s_mean + 3 * r);
        p3d::cell_centre(s_key[t], geo, s_cx + r, s_cy + r);
      }
    }
    s_rank[r] = emit_rank;
  }
  __syncthreads();

  // one thread per (row, channel), channel fastest: a warp shares its row
  for (int f = threadIdx.x; f < kRows * u1; f += blockDim.x) {
    const int r = f / u1;
    const int c = f - r * u1;
    const int rank = s_rank[r];
    float m = 0.f;
    if (rank >= 0) {
      const float* w = s_w + c * c_dec;
      m = -INFINITY;
      const int j0 = r + p - 1 - rank;
      for (int j = j0; j <= j0 + rank; ++j) {
        float x[kMaxCdec];
        p3d::decorate(s_pts, pw, j, c_in, s_mean + 3 * r, s_cx[r], s_cy[r],
                      with_distance, x);
        float v = s_b[c];
#pragma unroll
        for (int q = 0; q < kMaxCdec; ++q) {
          if (q < c_dec) v = __fadd_rn(v, __fmul_rn(w[q], x[q]));
        }
        m = fmaxf(m, fmaxf(v, 0.f));
      }
    }
    s_out[c * (kRows + 1) + r] = m;
  }
  __syncthreads();

  const int c_out = u1 + (occupancy ? 1 : 0);
  float* ob = out + static_cast<size_t>(b) * c_out * n;
  for (int f = threadIdx.x; f < u1 * kRows; f += blockDim.x) {
    const int c = f / kRows;
    const int r = f - c * kRows;
    if (r0 + r < n) {
      ob[static_cast<size_t>(c) * n + r0 + r] = s_out[c * (kRows + 1) + r];
    }
  }
  if (occupancy) {
    for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
      if (r0 + r < n) {
        ob[static_cast<size_t>(u1) * n + r0 + r] = s_rank[r] >= 0 ? 1.f : 0.f;
      }
    }
  }
}

constexpr int kRows2 = 64;
constexpr int kRows2Pad = kRows2 + 1;

__host__ __device__ constexpr int pts_window2(int p) { return kRows2 + p - 1; }

size_t smem2_bytes(int c_in, int c_dec, int u1, int u2, int p) {
  const size_t pw = pts_window2(p);
  const size_t floats = static_cast<size_t>(u1) * c_dec + u1 +
                        static_cast<size_t>(2 * u1) * u2 + u2 +
                        (c_in + c_dec + u1) * pw + 5 * kRows2 +
                        static_cast<size_t>(u1) * kRows2 +
                        static_cast<size_t>(u2) * kRows2Pad;
  const size_t ints = (kRows2 + p + 1) + kRows2 + pw;
  return floats * sizeof(float) + ints * sizeof(int);
}

__global__ void __launch_bounds__(kThreads)
    fused_pfn2_kernel(const int* __restrict__ keys,
                      const float* __restrict__ pts,
                      const int* __restrict__ vox,
                      const float* __restrict__ w1t,
                      const float* __restrict__ b1,
                      const float* __restrict__ w2t,
                      const float* __restrict__ b2, float* __restrict__ out,
                      int n, int c_in, int c_dec, int u1, int u2, int p,
                      int max_voxels, Geometry geo, int with_distance,
                      int occupancy) {
  extern __shared__ float smem[];
  const int kw = kRows2 + p + 1;  // keys of rows [r0 - p, r0 + kRows2]
  const int pw = pts_window2(p);  // points of rows [r0 - p + 1, r0 + kRows2)
  float* s_w1 = smem;                   // [u1][c_dec]
  float* s_b1 = s_w1 + u1 * c_dec;      // [u1]
  float* s_w2 = s_b1 + u1;              // [2 u1][u2], W2 transposed
  float* s_b2 = s_w2 + 2 * u1 * u2;     // [u2]
  float* s_pts = s_b2 + u2;             // [c_in][pw]
  float* s_x = s_pts + c_in * pw;       // [c_dec][pw] decorated owned rows
  float* s_y1 = s_x + c_dec * pw;       // [pw][u1] y1 of owned rows
  float* s_m1 = s_y1 + pw * u1;         // [kRows2][u1] pillar max of y1
  float* s_mean = s_m1 + kRows2 * u1;   // [kRows2][3]
  float* s_cx = s_mean + 3 * kRows2;    // [kRows2]
  float* s_cy = s_cx + kRows2;          // [kRows2]
  float* s_out = s_cy + kRows2;         // [u2][kRows2Pad]
  int* s_key = reinterpret_cast<int*>(s_out + u2 * kRows2Pad);  // [kw]
  int* s_rank = s_key + kw;   // [kRows2]; -1 where the row emits nothing
  int* s_own = s_rank + kRows2;  // [pw]; block row of the owning emission

  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kRows2;
  const int* kb = keys + static_cast<size_t>(b) * n;
  const float* pb = pts + static_cast<size_t>(b) * c_in * n;

  for (int t = threadIdx.x; t < u1 * c_dec; t += blockDim.x) s_w1[t] = w1t[t];
  for (int t = threadIdx.x; t < u1; t += blockDim.x) s_b1[t] = b1[t];
  for (int t = threadIdx.x; t < 2 * u1 * u2; t += blockDim.x) {
    const int o = t / (2 * u1);  // coalesced read of w2t [u2][2 u1]
    const int k = t - o * 2 * u1;
    s_w2[k * u2 + o] = w2t[t];
  }
  for (int t = threadIdx.x; t < u2; t += blockDim.x) s_b2[t] = b2[t];
  for (int t = threadIdx.x; t < kw; t += blockDim.x) {
    const int i = r0 - p + t;
    s_key[t] = i < 0 ? -1 : (i < n ? kb[i] : p3d::kSent);
  }
  for (int t = threadIdx.x; t < c_in * pw; t += blockDim.x) {
    const int ch = t / pw;
    const int i = r0 - p + 1 + (t - ch * pw);
    s_pts[t] = (i >= 0 && i < n) ? pb[static_cast<size_t>(ch) * n + i] : 0.f;
  }
  for (int t = threadIdx.x; t < pw; t += blockDim.x) s_own[t] = -1;
  __syncthreads();

  // emission rows: rank, the pillar's mean and centre, its rows' owner
  for (int r = threadIdx.x; r < kRows2; r += blockDim.x) {
    const int i = r0 + r;
    int rank = -1;
    if (i < n) {
      rank = p3d::emit_rank(s_key, r + p, p,
                            vox[static_cast<size_t>(b) * n + i], max_voxels);
      if (rank >= 0) {
        const int j0 = r + p - 1 - rank;  // the pillar's head in the window
        p3d::pillar_mean(s_pts, pw, j0, rank, s_mean + 3 * r);
        p3d::cell_centre(s_key[r + p], geo, s_cx + r, s_cy + r);
        for (int j = j0; j <= j0 + rank; ++j) s_own[j] = r;
      }
    }
    s_rank[r] = rank;
  }
  __syncthreads();

  // decorate each owned window row once
  for (int w = threadIdx.x; w < pw; w += blockDim.x) {
    const int o = s_own[w];
    float x[kMaxCdec];
    if (o >= 0) {
      p3d::decorate(s_pts, pw, w, c_in, s_mean + 3 * o, s_cx[o], s_cy[o],
                    with_distance, x);
    }
#pragma unroll
    for (int q = 0; q < kMaxCdec; ++q) {
      if (q < c_dec) s_x[q * pw + w] = o >= 0 ? x[q] : 0.f;
    }
  }
  __syncthreads();

  // y1 = relu(b1 + W1 x) from the bias up in k order, channel fastest
  for (int f = threadIdx.x; f < pw * u1; f += blockDim.x) {
    const int w = f / u1;
    const int c = f - w * u1;
    float v = 0.f;
    if (s_own[w] >= 0) {
      const float* wc = s_w1 + c * c_dec;
      v = s_b1[c];
#pragma unroll
      for (int q = 0; q < kMaxCdec; ++q) {
        if (q < c_dec) v = __fadd_rn(v, __fmul_rn(wc[q], s_x[q * pw + w]));
      }
      v = fmaxf(v, 0.f);
    }
    s_y1[f] = v;
  }
  __syncthreads();

  // m1: the pillar max of y1, per emission row
  for (int f = threadIdx.x; f < kRows2 * u1; f += blockDim.x) {
    const int r = f / u1;
    const int c = f - r * u1;
    const int rank = s_rank[r];
    float m = 0.f;
    if (rank >= 0) {
      const int j0 = r + p - 1 - rank;
      m = -INFINITY;
      for (int j = j0; j <= j0 + rank; ++j) m = fmaxf(m, s_y1[j * u1 + c]);
    }
    s_m1[f] = m;
  }
  __syncthreads();

  // t = relu(b2 + W2[:, u1:] m1 + W2[:, :u1] y1) and its pillar max, one
  // thread per (emission row, output channel), the channel fastest
  for (int f = threadIdx.x; f < kRows2 * u2; f += blockDim.x) {
    const int r = f / u2;
    const int o = f - r * u2;
    const int rank = s_rank[r];
    float m = 0.f;
    if (rank >= 0) {
      float base = s_b2[o];
      const float* m1 = s_m1 + r * u1;
      for (int k = 0; k < u1; ++k) {
        base = __fadd_rn(base, __fmul_rn(s_w2[(u1 + k) * u2 + o], m1[k]));
      }
      m = -INFINITY;
      const int j0 = r + p - 1 - rank;
      for (int j = j0; j <= j0 + rank; ++j) {
        const float* y1 = s_y1 + j * u1;
        float v = base;
        for (int k = 0; k < u1; ++k) {
          v = __fadd_rn(v, __fmul_rn(s_w2[k * u2 + o], y1[k]));
        }
        m = fmaxf(m, fmaxf(v, 0.f));
      }
    }
    s_out[o * kRows2Pad + r] = m;
  }
  __syncthreads();

  const int c_out = u2 + (occupancy ? 1 : 0);
  float* ob = out + static_cast<size_t>(b) * c_out * n;
  for (int f = threadIdx.x; f < u2 * kRows2; f += blockDim.x) {
    const int o = f / kRows2;
    const int r = f - o * kRows2;
    if (r0 + r < n) {
      ob[static_cast<size_t>(o) * n + r0 + r] = s_out[o * kRows2Pad + r];
    }
  }
  if (occupancy) {
    for (int r = threadIdx.x; r < kRows2; r += blockDim.x) {
      if (r0 + r < n) {
        ob[static_cast<size_t>(u2) * n + r0 + r] = s_rank[r] >= 0 ? 1.f : 0.f;
      }
    }
  }
}

}  // namespace

// keys [b, n] int32 sorted (sentinel 2^31-1); pts [b, c_in, n] f32; vox
// [b, n] int32 pillar ordinals; w1t [u1, c_dec] and b1 [u1] BN-folded;
// out [b, u1 (+1 with occupancy), n] f32. Returns cudaGetLastError().
extern "C" int p3d_fused_pfn_rows(const int* keys, const float* pts,
                                  const int* vox, const float* w1t,
                                  const float* b1, float* out, int b, int n,
                                  int c_in, int c_dec, int u1, int p,
                                  int max_voxels, int nx, float vx, float vy,
                                  float x_off, float y_off, int with_distance,
                                  int occupancy, void* stream) {
  if (c_in < 3 || c_in > kMaxCin || c_dec != c_in + 5 + (with_distance ? 1 : 0)
      || p < 1 || u1 < 1 || nx < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const size_t smem = smem_bytes(c_in, c_dec, u1, p);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_pfn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + kRows - 1) / kRows, b);
  const Geometry geo{nx, vx, vy, x_off, y_off};
  fused_pfn_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      keys, pts, vox, w1t, b1, out, n, c_in, c_dec, u1, p, max_voxels, geo,
      with_distance, occupancy);
  return static_cast<int>(cudaGetLastError());
}

// Two layers: as p3d_fused_pfn_rows, plus w2t [u2, 2 u1] (columns: y1 half,
// then m1 half) and b2 [u2] BN-folded; out [b, u2 (+1 with occupancy), n].
extern "C" int p3d_fused_pfn2_rows(const int* keys, const float* pts,
                                   const int* vox, const float* w1t,
                                   const float* b1, const float* w2t,
                                   const float* b2, float* out, int b, int n,
                                   int c_in, int c_dec, int u1, int u2, int p,
                                   int max_voxels, int nx, float vx, float vy,
                                   float x_off, float y_off, int with_distance,
                                   int occupancy, void* stream) {
  if (c_in < 3 || c_in > kMaxCin || c_dec != c_in + 5 + (with_distance ? 1 : 0)
      || p < 1 || u1 < 1 || u2 < 1 || nx < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const size_t smem = smem2_bytes(c_in, c_dec, u1, u2, p);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_pfn2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + kRows2 - 1) / kRows2, b);
  const Geometry geo{nx, vx, vy, x_off, y_off};
  fused_pfn2_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      keys, pts, vox, w1t, b1, w2t, b2, out, n, c_in, c_dec, u1, u2, p,
      max_voxels, geo, with_distance, occupancy);
  return static_cast<int>(cudaGetLastError());
}
