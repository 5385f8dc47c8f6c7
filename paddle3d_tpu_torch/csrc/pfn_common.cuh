// Device helpers shared by the fused PFN kernels: K1 (csrc/fused_pfn.cu)
// and K3/K4 (csrc/fused_pfn_train.cu). The rank, keep and emission rules,
// the pillar mean, the cell centre and the point decoration live here once,
// so the three kernels decorate a row bit for bit alike, and alike with the
// plain PyTorch version (paddle3d_tpu_torch/ops/fused_pfn.py,
// _decorate_plain): explicit round-to-nearest intrinsics, in its order, so
// nvcc contracts nothing into an FMA.
//
// Staging convention of all three kernels: a block owning rows
// [r0, r0 + R) stages the keys of rows [r0 - p, r0 + R] in s_key (row
// r0 + r at s_key[r + p]) and the point columns of rows [r0 - p + 1,
// r0 + R) in s_pts ([c_in][pw], pw = R + p - 1; row r0 + r at column
// r + p - 1). A pillar's kept rows all lie at or before its emission row
// (its last kept row), at most p - 1 rows back, so the window holds every
// row an emission row of the block needs.
#pragma once

#include <cuda_runtime.h>

namespace p3d {

constexpr int kSent = 0x7fffffff;
constexpr int kMaxCin = 8;
constexpr int kMaxCdec = kMaxCin + 6;

struct Geometry {
  int nx;
  float vx, vy, x_off, y_off;
};

// Emission rank of the row at s_key[t]: its arrival rank in its pillar
// when it is kept (rank < p, pillar ordinal `vox` < max_voxels) and is
// the pillar's last kept row; -1 otherwise. Its kept rows are the rank + 1
// rows ending at it.
__device__ __forceinline__ int emit_rank(const int* s_key, int t, int p,
                                         int vox, int max_voxels) {
  const int k = s_key[t];
  int rank = 0;
  while (rank < p && s_key[t - rank - 1] == k) ++rank;
  const bool keep = k != kSent && rank < p && vox < max_voxels;
  return (keep && (s_key[t + 1] != k || rank == p - 1)) ? rank : -1;
}

// Mean of x, y, z over s_pts columns j0 .. j0 + rank, summed in row order.
__device__ __forceinline__ void pillar_mean(const float* s_pts, int pw,
                                            int j0, int rank, float* mean) {
  float sx = 0.f, sy = 0.f, sz = 0.f;
  for (int j = j0; j <= j0 + rank; ++j) {
    sx = __fadd_rn(sx, s_pts[j]);
    sy = __fadd_rn(sy, s_pts[pw + j]);
    sz = __fadd_rn(sz, s_pts[2 * pw + j]);
  }
  const float cnt = static_cast<float>(rank + 1);
  mean[0] = __fdiv_rn(sx, cnt);
  mean[1] = __fdiv_rn(sy, cnt);
  mean[2] = __fdiv_rn(sz, cnt);
}

// Centre of cell key k (row-major over nx columns).
__device__ __forceinline__ void cell_centre(int k, const Geometry& geo,
                                            float* cx, float* cy) {
  const int yc = k / geo.nx;
  const int xc = k - yc * geo.nx;
  *cx = __fadd_rn(__fmul_rn(static_cast<float>(xc), geo.vx), geo.x_off);
  *cy = __fadd_rn(__fmul_rn(static_cast<float>(yc), geo.vy), geo.y_off);
}

// PFN input of the point in s_pts column j: its c_in channels, xyz minus
// the pillar mean, x and y minus the pillar centre (and its distance).
__device__ __forceinline__ void decorate(const float* s_pts, int pw, int j,
                                         int c_in, const float* mean,
                                         float cx, float cy,
                                         bool with_distance, float* x) {
#pragma unroll
  for (int q = 0; q < kMaxCin; ++q) {
    if (q < c_in) x[q] = s_pts[q * pw + j];
  }
  const float px = s_pts[j], py = s_pts[pw + j], pz = s_pts[2 * pw + j];
  x[c_in] = __fsub_rn(px, mean[0]);
  x[c_in + 1] = __fsub_rn(py, mean[1]);
  x[c_in + 2] = __fsub_rn(pz, mean[2]);
  x[c_in + 3] = __fsub_rn(px, cx);
  x[c_in + 4] = __fsub_rn(py, cy);
  if (with_distance) {
    x[c_in + 5] = __fsqrt_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py)),
                  __fmul_rn(pz, pz)));
  }
}

}  // namespace p3d
