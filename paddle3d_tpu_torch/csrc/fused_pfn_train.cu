// Fused pillar feature net, train mode: the two kernels around K1 that give
// the one-layer PFN batch-statistics BatchNorm and its backward.
//
//   K3 p3d_pfn_stats replaces paddle3d_tpu/ops/pallas/fused_pfn_train.py
//      :_kernel_stats (entry _pfn_stats): per block, the sums
//      [sum z, sum z^2, count, sum x (x) z, sum x] over its kept rows, with
//      z = W1 x the pre-BN activation of a kept row's decorated input x.
//   K4 p3d_pfn_bwd replaces fused_pfn_train.py:_kernel_bwd (entry
//      _pfn_bwd): recomputes z and t = a z + c, routes the cotangent of each
//      pillar's emission row to its FIRST argmax row per channel, gated by
//      relu' (t > 0), and sums per block [sum dt, sum dt zhat, sum x (x) dt],
//      zhat = (z - mu) invsig.
//
// The caller (paddle3d_tpu_torch/ops/fused_pfn_train.py) sums the
// per-block partials in PyTorch, derives the batch mean and variance and the
// dW1 / dgamma / dbeta formula, and runs K1 with the folded weights. No
// float atomics: each block writes its own partial, in a fixed order, so two
// runs agree bit for bit. The sums accumulate in f64 (each product of two
// f32 values is exact there): the formula cancels (var = s2/M - mu^2,
// t3 - sx mu^T over ~1e5 rows), and f32 sums taken in two orders gave dW1s
// 2.7e-2 of its largest entry apart on the card.
//
// Design: a block owns the pillars whose emission row (their last kept row)
// lies in its kRows rows, and stages keys and points as K1 does
// (csrc/pfn_common.cuh): every kept row of such a pillar lies at most p - 1
// rows before its emission row, inside the window. Each window row is marked
// with the block row of its emission row when that is in the block, so
// every kept row is counted by exactly one block. The window rows are
// decorated (one thread per row, the shared helpers, so bit for bit as K1
// and the plain version), then z is computed in k order, one thread per
// (row, channel). K3 reduces over the window in row order, one thread per
// output; K4 runs one thread per (emission row, channel) over the pillar's
// <= p rows (strictly greater, so the first maximum wins), keeps
// (dt, zhat, argmax row) in shared memory, and reduces those in row
// order. The TPU kernels' ones-dots, lane rolls and doubling scans have no
// counterpart.
//
// Layouts: keys [B, N] int32 sorted (sentinel 2^31-1); points channel-major
// [B, C_in, N]; vox [B, N] int32 pillar ordinals (the max_voxels cap);
// w1t [u1, C_dec]; a, c, mu, invsig [u1]. K4's cotangent g is that of K1's
// channel-major [B, C, N] rows, read through its strides (autograd hands it
// over as a transposed view of the scatter VJP's [B, N, C] rows; channels
// >= u1, the occupancy, are ignored). Partials, f64: K3 [B, nblk, 4 + C_dec,
// u1] (rows s1, s2, count, t3[C_dec], sx padded to u1); K4 [B, nblk,
// 2 + C_dec, u1] (rows sdt, sdtz, t1[C_dec]).
//
// What bounds them on the H100 at KITTI (8 x 20,000 rows, u1 = 64,
// P = 32): neither bytes (~3 MB in, ~8 MB of partials out) nor FLOPs
// (~0.2 GFLOP): latency and the staging of a P - 1 row halo per 64-row
// block. Both are simple first versions.
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "pfn_common.cuh"

namespace {

using p3d::Geometry;
using p3d::kMaxCdec;
using p3d::kMaxCin;

constexpr int kRows = 64;
constexpr int kRowsPad = kRows + 1;
constexpr int kThreads = 256;

__host__ __device__ constexpr int key_window(int p) { return kRows + p + 1; }
__host__ __device__ constexpr int pts_window(int p) { return kRows + p - 1; }

// Shared memory both kernels stage: floats, then ints.
struct Stage {
  float* w;     // [u1][c_dec]
  float* pts;   // [c_in][pw]
  float* x;     // [c_dec][pw]  decorated rows, zero where not owned
  float* z;     // [u1][pw]     W1 x, zero where not owned
  float* mean;  // [kRows][3]
  float* cx;    // [kRows]
  float* cy;    // [kRows]
  int* key;     // [kw]
  int* rank;    // [kRows]  emission rank of a block row, -1 if none
  int* own;     // [pw]     block row of the window row's emission row, -1
};

__host__ __device__ size_t stage_floats(int c_in, int c_dec, int u1, int p) {
  const size_t pw = pts_window(p);
  return static_cast<size_t>(u1) * c_dec + (c_in + c_dec + u1) * pw +
         5 * kRows;
}

__host__ __device__ size_t stage_ints(int p) {
  return key_window(p) + kRows + pts_window(p);
}

__device__ Stage carve(float* smem, int c_in, int c_dec, int u1, int p,
                       float** rest_f, int** rest_i, size_t extra_floats) {
  const int pw = pts_window(p);
  Stage s;
  s.w = smem;
  s.pts = s.w + u1 * c_dec;
  s.x = s.pts + c_in * pw;
  s.z = s.x + c_dec * pw;
  s.mean = s.z + u1 * pw;
  s.cx = s.mean + 3 * kRows;
  s.cy = s.cx + kRows;
  *rest_f = s.cy + kRows;
  s.key = reinterpret_cast<int*>(*rest_f + extra_floats);
  s.rank = s.key + key_window(p);
  s.own = s.rank + kRows;
  *rest_i = s.own + pw;
  return s;
}

// Stage the block's window, find its emission rows, decorate the rows they
// own and compute z = W1 x for them. Ends synchronised.
__device__ void stage_block(const Stage& s, const int* kb, const float* pb,
                            const int* vb, const float* w1t, int n, int r0,
                            int c_in, int c_dec, int u1, int p,
                            int max_voxels, const Geometry& geo,
                            bool with_distance) {
  const int kw = key_window(p);
  const int pw = pts_window(p);
  for (int t = threadIdx.x; t < u1 * c_dec; t += blockDim.x) s.w[t] = w1t[t];
  for (int t = threadIdx.x; t < kw; t += blockDim.x) {
    const int i = r0 - p + t;
    s.key[t] = i < 0 ? -1 : (i < n ? kb[i] : p3d::kSent);
  }
  for (int t = threadIdx.x; t < c_in * pw; t += blockDim.x) {
    const int ch = t / pw;
    const int i = r0 - p + 1 + (t - ch * pw);
    s.pts[t] = (i >= 0 && i < n) ? pb[static_cast<size_t>(ch) * n + i] : 0.f;
  }
  for (int t = threadIdx.x; t < pw; t += blockDim.x) s.own[t] = -1;
  __syncthreads();

  for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
    const int i = r0 + r;
    int rank = -1;
    if (i < n) {
      rank = p3d::emit_rank(s.key, r + p, p, vb[i], max_voxels);
      if (rank >= 0) {
        const int j0 = r + p - 1 - rank;  // the pillar's head in the window
        p3d::pillar_mean(s.pts, pw, j0, rank, s.mean + 3 * r);
        p3d::cell_centre(s.key[r + p], geo, s.cx + r, s.cy + r);
        for (int j = j0; j <= j0 + rank; ++j) s.own[j] = r;
      }
    }
    s.rank[r] = rank;
  }
  __syncthreads();

  for (int w = threadIdx.x; w < pw; w += blockDim.x) {
    const int o = s.own[w];
    float x[kMaxCdec];
    if (o >= 0) {
      p3d::decorate(s.pts, pw, w, c_in, s.mean + 3 * o, s.cx[o], s.cy[o],
                    with_distance, x);
    }
#pragma unroll
    for (int q = 0; q < kMaxCdec; ++q) {
      if (q < c_dec) s.x[q * pw + w] = o >= 0 ? x[q] : 0.f;
    }
  }
  __syncthreads();

  // z in k order (the plain version's order: bit for bit), channel fastest
  for (int f = threadIdx.x; f < pw * u1; f += blockDim.x) {
    const int w = f / u1;
    const int c = f - w * u1;
    float z = 0.f;
    if (s.own[w] >= 0) {
      const float* wc = s.w + c * c_dec;
#pragma unroll
      for (int q = 0; q < kMaxCdec; ++q) {
        if (q < c_dec) z = __fadd_rn(z, __fmul_rn(wc[q], s.x[q * pw + w]));
      }
    }
    s.z[c * pw + w] = z;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    pfn_stats_kernel(const int* __restrict__ keys,
                     const float* __restrict__ pts,
                     const int* __restrict__ vox,
                     const float* __restrict__ w1t, double* __restrict__ out,
                     int n, int c_in, int c_dec, int u1, int p,
                     int max_voxels, Geometry geo, int with_distance) {
  extern __shared__ float smem[];
  float* rest_f;
  int* rest_i;
  const Stage s = carve(smem, c_in, c_dec, u1, p, &rest_f, &rest_i, 0);
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const size_t bn = static_cast<size_t>(b) * n;
  stage_block(s, keys + bn, pts + bn * c_in, vox + bn, w1t, n, r0, c_in,
              c_dec, u1, p, max_voxels, geo, with_distance != 0);

  const int pw = pts_window(p);
  const int ro = 4 + c_dec;
  double* ob = out + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) *
                         ro * u1;
  for (int f = threadIdx.x; f < ro * u1; f += blockDim.x) {
    const int row = f / u1;
    const int c = f - row * u1;
    const float* zc = s.z + c * pw;
    double acc = 0.0;
    if (row == 0) {
      for (int w = 0; w < pw; ++w) acc += zc[w];
    } else if (row == 1) {
      for (int w = 0; w < pw; ++w) {
        acc += static_cast<double>(zc[w]) * zc[w];
      }
    } else if (row == 2) {
      for (int w = 0; w < pw; ++w) acc += s.own[w] >= 0 ? 1.0 : 0.0;
    } else if (row < 3 + c_dec) {
      const float* xk = s.x + (row - 3) * pw;
      for (int w = 0; w < pw; ++w) {
        acc += static_cast<double>(xk[w]) * zc[w];
      }
    } else if (c < c_dec) {
      const float* xk = s.x + c * pw;
      for (int w = 0; w < pw; ++w) acc += xk[w];
    }
    ob[f] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
    pfn_bwd_kernel(const int* __restrict__ keys,
                   const float* __restrict__ pts,
                   const int* __restrict__ vox,
                   const float* __restrict__ w1t,
                   const float* __restrict__ a, const float* __restrict__ cc,
                   const float* __restrict__ mu,
                   const float* __restrict__ invsig,
                   const float* __restrict__ g, long long gsb, long long gsc,
                   long long gsn, double* __restrict__ out, int n, int c_in,
                   int c_dec, int u1, int p, int max_voxels, Geometry geo,
                   int with_distance) {
  extern __shared__ float smem[];
  float* rest_f;
  int* rest_i;
  const size_t extra = 4 * static_cast<size_t>(u1) + 2 * u1 * kRowsPad;
  const Stage s = carve(smem, c_in, c_dec, u1, p, &rest_f, &rest_i, extra);
  // per (channel, block row): [u1][kRowsPad], padded against bank conflicts
  float* s_a = rest_f;           // [u1]
  float* s_c = s_a + u1;         // [u1]
  float* s_mu = s_c + u1;        // [u1]
  float* s_is = s_mu + u1;       // [u1]
  float* s_dt = s_is + u1;       // dt routed to the pillar's argmax row
  float* s_zh = s_dt + u1 * kRowsPad;  // zhat of that row
  int* s_arg = rest_i;           // window row of the argmax, -1 for none
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const size_t bn = static_cast<size_t>(b) * n;
  for (int t = threadIdx.x; t < u1; t += blockDim.x) {
    s_a[t] = a[t];
    s_c[t] = cc[t];
    s_mu[t] = mu[t];
    s_is[t] = invsig[t];
  }
  stage_block(s, keys + bn, pts + bn * c_in, vox + bn, w1t, n, r0, c_in,
              c_dec, u1, p, max_voxels, geo, with_distance != 0);

  const int pw = pts_window(p);
  const float* gb = g + static_cast<long long>(b) * gsb;
  for (int f = threadIdx.x; f < kRows * u1; f += blockDim.x) {
    const int r = f / u1;
    const int c = f - r * u1;
    const int rank = s.rank[r];
    float dt = 0.f, zhat = 0.f;
    int arg = -1;
    if (rank >= 0) {
      const float* zc = s.z + c * pw;
      const int j0 = r + p - 1 - rank;
      float best = -INFINITY, tbest = 0.f;
      int jbest = j0;
      for (int j = j0; j <= j0 + rank; ++j) {
        const float t = __fadd_rn(__fmul_rn(zc[j], s_a[c]), s_c[c]);
        const float y = fmaxf(t, 0.f);
        if (y > best) {  // strictly: the first maximum wins
          best = y;
          tbest = t;
          jbest = j;
        }
      }
      if (tbest > 0.f) {  // relu'(0) = 0
        dt = gb[c * gsc + static_cast<long long>(r0 + r) * gsn];
        zhat = __fmul_rn(__fsub_rn(zc[jbest], s_mu[c]), s_is[c]);
        arg = jbest;
      }
    }
    s_dt[c * kRowsPad + r] = dt;
    s_zh[c * kRowsPad + r] = zhat;
    s_arg[c * kRowsPad + r] = arg;
  }
  __syncthreads();

  const int ro = 2 + c_dec;
  double* ob = out + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) *
                         ro * u1;
  for (int f = threadIdx.x; f < ro * u1; f += blockDim.x) {
    const int row = f / u1;
    const int c = f - row * u1;
    const float* dtc = s_dt + c * kRowsPad;
    double acc = 0.0;
    if (row == 0) {
      for (int r = 0; r < kRows; ++r) acc += dtc[r];
    } else if (row == 1) {
      const float* zhc = s_zh + c * kRowsPad;
      for (int r = 0; r < kRows; ++r) {
        acc += static_cast<double>(dtc[r]) * zhc[r];
      }
    } else {
      const float* xk = s.x + (row - 2) * pw;
      const int* argc = s_arg + c * kRowsPad;
      for (int r = 0; r < kRows; ++r) {
        if (argc[r] >= 0) acc += static_cast<double>(xk[argc[r]]) * dtc[r];
      }
    }
    ob[f] = acc;
  }
}

bool bad_shape(int c_in, int c_dec, int u1, int p, int nx,
               int with_distance) {
  return c_in < 3 || c_in > kMaxCin ||
         c_dec != c_in + 5 + (with_distance ? 1 : 0) || p < 1 || u1 < c_dec ||
         nx < 1;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// K3. out [b, ceil(n / 64), 4 + c_dec, u1] f64 partials (see the header).
// Returns cudaGetLastError().
extern "C" int p3d_pfn_stats(const int* keys, const float* pts,
                             const int* vox, const float* w1t, double* out,
                             int b, int n, int c_in, int c_dec, int u1, int p,
                             int max_voxels, int nx, float vx, float vy,
                             float x_off, float y_off, int with_distance,
                             void* stream) {
  if (bad_shape(c_in, c_dec, u1, p, nx, with_distance)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = stage_floats(c_in, c_dec, u1, p) * sizeof(float) +
                      stage_ints(p) * sizeof(int);
  const cudaError_t err = allow_smem(pfn_stats_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kRows - 1) / kRows, b);
  pfn_stats_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      keys, pts, vox, w1t, out, n, c_in, c_dec, u1, p, max_voxels,
      Geometry{nx, vx, vy, x_off, y_off}, with_distance);
  return static_cast<int>(cudaGetLastError());
}

// K4. g: the rows cotangent, element (b, c, i) at g[b*gsb + c*gsc + i*gsn]
// for c < u1. out [b, ceil(n / 64), 2 + c_dec, u1] f64 partials. Returns
// cudaGetLastError().
extern "C" int p3d_pfn_bwd(const int* keys, const float* pts, const int* vox,
                           const float* w1t, const float* a, const float* cc,
                           const float* mu, const float* invsig,
                           const float* g, long long gsb, long long gsc,
                           long long gsn, double* out, int b, int n, int c_in,
                           int c_dec, int u1, int p, int max_voxels, int nx,
                           float vx, float vy, float x_off, float y_off,
                           int with_distance, void* stream) {
  if (bad_shape(c_in, c_dec, u1, p, nx, with_distance)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const size_t smem =
      (stage_floats(c_in, c_dec, u1, p) + 4 * static_cast<size_t>(u1) +
       2 * static_cast<size_t>(u1) * kRowsPad) * sizeof(float) +
      (stage_ints(p) + static_cast<size_t>(u1) * kRowsPad) * sizeof(int);
  const cudaError_t err = allow_smem(pfn_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + kRows - 1) / kRows, b);
  pfn_bwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      keys, pts, vox, w1t, a, cc, mu, invsig, g, gsb, gsc, gsn, out, n, c_in,
      c_dec, u1, p, max_voxels, Geometry{nx, vx, vy, x_off, y_off},
      with_distance);
  return static_cast<int>(cudaGetLastError());
}
