// Masked farthest-point sampling (K10): idx[b, 0] is the first valid point
// of scan b (0 when it has none), and idx[b, k] the lowest index among the
// points whose squared distance to the picks idx[b, :k] is largest; an
// invalid point is never picked (its distance is pinned at -1).
//
// Replaces the TPU kernel paddle3d_tpu/ops/pallas/fps.py:_kernel (entry
// _fps_tpu, reached through farthest_point_sample_batched). That body keeps
// the scan in VMEM as (8, N/8) tiles, finds the last pick's coordinates by
// a masked sum (it cannot gather) and marks invalid points with a far-away
// coordinate; none of that is carried over.
//
// What bounds it on the H100: neither bytes nor operations but a chain of
// npoint - 1 dependent steps, each a sweep over the scan's points followed
// by a block-wide argmax, and only B blocks run (one a scan), so at most B
// of the card's 132 SMs work. The bytes moved once are the scan and npoint
// ints; the operations 10 a point a step.
//
// Design: one block of 1,024 threads per scan. A thread owns the points
// tid, tid + 1024, ... and keeps their running squared distance in
// registers (PPT of them, a template parameter, so that the array never
// leaves the register file); the coordinates are re-read each step from
// the scan in device memory, which at 12 bytes a point stays in L1/L2 (a
// scan of 20,000 points is 240 KB: more than one SM's shared memory). A
// step updates d2 = min(d2, |p - last|^2) for the thread's valid points and
// keeps the thread's best (d2, index); a warp reduces 32 of those with
// shuffles, the 32 warp results go through shared memory, and every warp
// reduces them again on its own, so a step costs one __syncthreads (the
// partials are double-buffered by step parity). The pair (d2, index) is
// compared as "larger d2, or equal d2 and lower index", which is the
// first-index tie rule of the plain version whatever the reduction order.
// Scans longer than 1,024 * 32 points keep d2 in a scratch buffer in
// device memory instead (PPT = 0).
//
// The squared distance is (dx*dx + dy*dy) + dz*dz with every product and
// sum rounded on its own (__fmul_rn, __fadd_rn: no fused multiply-add), the
// order of the plain PyTorch version: an index-valued function, so a last
// bit is a different answer.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 1e10f;

struct Best {
  float d;
  int i;
};

__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.d > a.d || (b.d == a.d && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ Best warp_best(Best v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    Best o;
    o.d = __shfl_xor_sync(0xffffffffu, v.d, s);
    o.i = __shfl_xor_sync(0xffffffffu, v.i, s);
    v = better(v, o);
  }
  return v;
}

__device__ __forceinline__ float dist2(float px, float py, float pz,
                                       float lx, float ly, float lz) {
  const float dx = px - lx;
  const float dy = py - ly;
  const float dz = pz - lz;
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// PPT > 0: d2 of point j * kThreads + tid in register d2[j]; PPT == 0: in
// scratch[b * n + i]
template <int PPT>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz,
           const unsigned char* __restrict__ mask, int* __restrict__ idx,
           float* __restrict__ scratch, int n, int npoint) {
  __shared__ float s_d[2][kWarps];
  __shared__ int s_i[2][kWarps];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float* pts = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  const unsigned char* msk = mask + static_cast<size_t>(blockIdx.x) * n;
  int* out = idx + static_cast<size_t>(blockIdx.x) * npoint;
  float* far = scratch + static_cast<size_t>(blockIdx.x) * n;

  float d2[PPT > 0 ? PPT : 1];
  // the first valid point: the block's best of (-index) over valid points
  Best mine;
  mine.d = -1.f;     // 0 for "has a valid point"
  mine.i = n;
  if (PPT > 0) {
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int i = j * kThreads + tid;
      const bool valid = i < n && msk[i];
      // slots past the scan's end hold -2: below every real point
      d2[j] = valid ? kBig : (i < n ? -1.f : -2.f);
      if (valid && mine.i == n) {
        mine.d = 0.f;
        mine.i = i;
      }
    }
  } else {
    for (int i = tid; i < n; i += kThreads) {
      const bool valid = msk[i];
      far[i] = valid ? kBig : -1.f;
      if (valid && mine.i == n) {
        mine.d = 0.f;
        mine.i = i;
      }
    }
  }
  mine = warp_best(mine);
  if (lane == 0) {
    s_d[0][warp] = mine.d;
    s_i[0][warp] = mine.i;
  }
  __syncthreads();
  Best all;
  all.d = s_d[0][lane];
  all.i = s_i[0][lane];
  all = warp_best(all);
  int last = all.i < n ? all.i : 0;
  if (tid == 0) out[0] = last;

  for (int k = 1; k < npoint; ++k) {
    const float lx = pts[3 * last];
    const float ly = pts[3 * last + 1];
    const float lz = pts[3 * last + 2];
    mine.d = -3.f;
    mine.i = n;
    if (PPT > 0) {
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const int i = j * kThreads + tid;
        float d = d2[j];
        if (d >= 0.f) {     // valid: invalid (-1) and padding (-2) stay
          d = fminf(d, dist2(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], lx,
                             ly, lz));
          d2[j] = d;
        }
        if (d > mine.d) {   // ascending i: ties keep the lower index
          mine.d = d;
          mine.i = i;
        }
      }
    } else {
      for (int i = tid; i < n; i += kThreads) {
        float d = far[i];
        if (d >= 0.f) {
          d = fminf(d, dist2(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], lx,
                             ly, lz));
          far[i] = d;
        }
        if (d > mine.d) {
          mine.d = d;
          mine.i = i;
        }
      }
    }
    mine = warp_best(mine);
    const int buf = k & 1;
    if (lane == 0) {
      s_d[buf][warp] = mine.d;
      s_i[buf][warp] = mine.i;
    }
    __syncthreads();
    all.d = s_d[buf][lane];
    all.i = s_i[buf][lane];
    all = warp_best(all);
    last = all.i;
    if (tid == 0) out[k] = last;
  }
}

template <int PPT>
int launch(const float* xyz, const unsigned char* mask, int* idx,
           float* scratch, int b, int n, int npoint, cudaStream_t stream) {
  fps_kernel<PPT><<<b, kThreads, 0, stream>>>(xyz, mask, idx, scratch, n,
                                              npoint);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xyz [b, n, 3] f32, mask [b, n] bytes (0 / 1), both contiguous; idx
// [b, npoint] int32, every element written. scratch: [b, n] f32, needed
// (and touched) only when n > 32768, else it may be null. Valid points
// must have finite coordinates. Returns cudaGetLastError().
extern "C" int p3d_farthest_point_sample(const float* xyz,
                                         const unsigned char* mask, int* idx,
                                         float* scratch, int b, int n,
                                         int npoint, void* stream) {
  if (n < 1 || npoint < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ppt = (n + kThreads - 1) / kThreads;
  if (ppt <= 1) return launch<1>(xyz, mask, idx, scratch, b, n, npoint, s);
  if (ppt <= 2) return launch<2>(xyz, mask, idx, scratch, b, n, npoint, s);
  if (ppt <= 4) return launch<4>(xyz, mask, idx, scratch, b, n, npoint, s);
  if (ppt <= 8) return launch<8>(xyz, mask, idx, scratch, b, n, npoint, s);
  if (ppt <= 12) return launch<12>(xyz, mask, idx, scratch, b, n, npoint, s);
  if (ppt <= 16) return launch<16>(xyz, mask, idx, scratch, b, n, npoint, s);
  if (ppt <= 20) return launch<20>(xyz, mask, idx, scratch, b, n, npoint, s);
  if (ppt <= 24) return launch<24>(xyz, mask, idx, scratch, b, n, npoint, s);
  if (ppt <= 32) return launch<32>(xyz, mask, idx, scratch, b, n, npoint, s);
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch<0>(xyz, mask, idx, scratch, b, n, npoint, s);
}
