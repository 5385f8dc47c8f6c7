// Ball query (K9): for each query centre, the indices of the first
// `nsample` valid support points, in index order, within `radius`.
//
//   idx[b, q, s]  = index of the (s+1)-th point i (ascending) with mask[b, i]
//                   and d2(new_xyz[b, q], xyz[b, i]) <= r2, s < count;
//                   slots s >= max(count, 1) repeat idx[b, q, 0];
//                   all 0 when no point is in range
//   count[b, q]   = min(number of such points, nsample)
//
// Replaces the TPU kernel paddle3d_tpu/ops/pallas/ball_query.py:_kernel
// (entry _ball_query_tpu, reached through ball_query_batched). That body is
// built around what a TPU lacks: [128, 512] distance blocks, a log-doubling
// cumsum for the rank, nsample masked reductions to place the hits, a
// bit-packed visit mask and a far-away coordinate sentinel for invalid
// points. None of that is carried over.
//
// What bounds it on the H100: operations, and few of them. The bytes are
// small (the support set, the queries and M * (nsample + 1) ints out; the
// support set is re-read by every block but stays in L2), and an in-ball
// test is eight f32 operations. What the kernel really waits for is the walk
// itself: a query that fills its nsample slots early leaves early, one in
// an empty region walks the whole set.
//
// Design: one warp per query, 16 queries a block. The block walks the
// support set in index order in tiles of 1,024 points staged through shared
// memory (coordinates as they lie, xyz interleaved: a stride of 3 words is
// free of bank conflicts; the mask bytes beside them). A warp takes a tile
// 32 points at a time: each lane tests one point, __ballot_sync gives the
// hits, __popc of the lower lanes a hit's rank, and the lane writes
// idx[count + rank] while that is below nsample. The order of hits is the
// index order by construction, so there is nothing to sort or scan. A warp
// stops testing once it holds nsample hits, and the block leaves the tile
// loop when all its warps have (__syncthreads_and). Empty slots are filled
// by the same warp at the end. The mask is tested directly.
//
// The squared distance is (dx*dx + dy*dy) + dz*dz with every product and
// sum rounded on its own (__fmul_rn, __fadd_rn: no fused multiply-add), the
// order of the plain PyTorch version, so that the two agree index for index
// on points that lie on the ball's surface to the last bit.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 16;               // queries per block
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 1024;              // support points per shared tile

__global__ void __launch_bounds__(kThreads)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ new_xyz,
                  const unsigned char* __restrict__ mask,
                  int* __restrict__ idx, int* __restrict__ cnt, float r2,
                  int n, int m, int nsample) {
  __shared__ float s_xyz[kTile * 3];
  __shared__ unsigned char s_mask[kTile];

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + warp;
  const bool live = q < m;
  const float* pts = xyz + static_cast<size_t>(b) * n * 3;
  const unsigned char* msk = mask + static_cast<size_t>(b) * n;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    const float* c = new_xyz + (static_cast<size_t>(b) * m + q) * 3;
    qx = c[0];
    qy = c[1];
    qz = c[2];
  }
  int* out = idx + (static_cast<size_t>(b) * m + (live ? q : 0)) * nsample;
  int count = 0;      // hits so far, uncapped within the chunk that filled
  int first = 0;      // index of the first hit
  bool done = !live;

  for (int base = 0; base < n; base += kTile) {
    if (__syncthreads_and(done)) break;   // also fences the tile's readers
    const int len = min(kTile, n - base);
    for (int i = threadIdx.x; i < len * 3; i += kThreads) {
      s_xyz[i] = pts[static_cast<size_t>(base) * 3 + i];
    }
    for (int i = threadIdx.x; i < len; i += kThreads) {
      s_mask[i] = msk[base + i];
    }
    __syncthreads();
    if (done) continue;
    for (int off = 0; off < len; off += 32) {
      const int i = off + lane;
      bool hit = false;
      if (i < len && s_mask[i]) {
        const float dx = qx - s_xyz[3 * i];
        const float dy = qy - s_xyz[3 * i + 1];
        const float dz = qz - s_xyz[3 * i + 2];
        const float d2 = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        hit = d2 <= r2;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (ballot == 0u) continue;
      if (count == 0) first = base + off + __ffs(ballot) - 1;
      const int slot = count + __popc(ballot & ((1u << lane) - 1u));
      if (hit && slot < nsample) out[slot] = base + i;
      count += __popc(ballot);
      if (count >= nsample) {
        done = true;
        break;
      }
    }
  }
  if (!live) return;
  count = min(count, nsample);
  for (int s = max(count, 1) + lane; s < nsample; s += 32) out[s] = first;
  if (lane == 0) {
    if (count == 0) out[0] = 0;
    cnt[static_cast<size_t>(b) * m + q] = count;
  }
}

}  // namespace

// xyz [b, n, 3] f32, new_xyz [b, m, 3] f32, mask [b, n] bytes (0 / 1), all
// contiguous; idx [b, m, nsample] int32 and cnt [b, m] int32, every element
// written. r2 is the squared radius, already rounded to f32. Returns
// cudaGetLastError().
extern "C" int p3d_ball_query(const float* xyz, const float* new_xyz,
                              const unsigned char* mask, int* idx, int* cnt,
                              float r2, int b, int n, int m, int nsample,
                              void* stream) {
  if (nsample < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || m == 0) return static_cast<int>(cudaSuccess);
  if (b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kWarps - 1) / kWarps, b);
  ball_query_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz, new_xyz, mask, idx, cnt, r2, n, m, nsample);
  return static_cast<int>(cudaGetLastError());
}
