// Fused pillar feature net, eval: cell-sorted points -> each pillar's PFN
// max feature on its emission row (its last kept row), zero elsewhere, plus
// an optional occupancy channel.
//
// Replaces the TPU kernel paddle3d_tpu/ops/pallas/fused_pfn.py:_kernel with
// its _decorate (entry fused_pfn_rows), for one BN-folded PFN layer.
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
// Rounding: the rank rules and the decoration come from csrc/pfn_common.cuh,
// shared with the train kernels (K3/K4); sums, products and the centre use
// explicit round-to-nearest intrinsics, in the same order as the plain
// PyTorch version (paddle3d_tpu_torch/ops/fused_pfn.py), so nvcc contracts
// nothing into an FMA and the two agree bit for bit.
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
