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
// (entry _ball_query_tpu, reached through ball_query_batched). That body
// tests [128, 512] blocks, ranks hits by a log-doubling cumsum and places
// them by nsample masked reductions, none of which is carried over; what is
// carried over is its cull (ball_query.py:115-137): a (query block, support
// chunk) pair whose bounding boxes lie more than the radius apart is never
// visited.
//
// What bounds it on the H100: the walk, not bytes or arithmetic. The bytes
// are small (the support set, the queries and M * (nsample + 1) ints out)
// and an in-ball test is eight f32 operations, but a query whose ball holds
// fewer than nsample points must look at the whole support set: a walk
// that tests every point (the port's first kernel) ran ~880 M tests for a
// PV-RCNN forward whose balls hold a few million points.
//
// Design: a warp a query, 32 queries a block; the support set is cut, in
// index order, into chunks of 32 points (one warp step), and a pre-pass
// (chunk_boxes_kernel) writes each chunk's bounding box over its valid
// points. The block walks the chunks 32 at a time (a round):
//   1. each lane tests one chunk's box against its warp's ball, so a warp
//      knows in one step which chunks of the round it must visit;
//   2. the union over the block's warps is staged into shared memory,
//      chunk c by warp c and a lane a point (the next round's boxes loaded
//      behind them), and each point is tested against the box of the
//      block's 32 queries: the chunk keeps a 32-bit mask of the points that
//      may lie in some ball of the block;
//   3. each warp visits its chunks in index order, testing only the points
//      of that mask: __ballot_sync gives the hits, __popc of the lower
//      lanes a hit's rank, and the lane writes idx[count + rank] while that
//      is below nsample; the warp stops at nsample hits, the block when all
//      its warps have (__syncthreads_and).
// Supports in spatial order (voxel centres in key order) make chunk boxes
// small, so step 1 skips most chunks; queries in spatial order (an RoI's
// grid points) make the block's box small, so step 2 leaves few points
// even where chunks are wide (farthest-point keypoints). Supports and
// queries both in no spatial order (raw points around farthest-point
// keypoints) keep the first kernel's walk.
//
// Exactness: both culls compute the gap between two boxes (a point is a box
// of size 0) as coordinate differences in the point test's direction,
// query minus support, g = fl(q_hi - p_lo) when the query side lies below,
// fl(q_lo - p_hi) above, else 0, and skip only where
// fl(fl(fl(gx*gx) + fl(gy*gy)) + fl(gz*gz)) > r2. Rounding to nearest is
// monotone, so every point of a skipped chunk or box has a rounded distance
// at least as large, and fails the point test: the result is the walk's,
// index for index. ops/ball_query.cull_plain repeats both tests.
//
// The squared distance is (dx*dx + dy*dy) + dz*dz with every product and
// sum rounded on its own (__fmul_rn, __fadd_rn: no fused multiply-add), the
// order of the plain PyTorch version, so that the two agree index for index
// on points that lie on the ball's surface to the last bit.
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kWarps = 32;               // queries per block
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;               // support points a chunk
constexpr int kRound = 32;               // chunks a round: a lane each
constexpr int kBoxWarps = 8;             // chunks a pre-pass block
static_assert(kRound == 32 && kWarps == kRound,
              "a lane tests a chunk's box, a warp stages a chunk");

__device__ __forceinline__ float d2_of(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The query-minus-support difference of the closest pair of two intervals
// on one axis, rounded as the point test rounds it (0 where they overlap).
__device__ __forceinline__ float gap(float q_lo, float q_hi, float p_lo,
                                     float p_hi) {
  return q_hi < p_lo ? __fsub_rn(q_hi, p_lo)
                     : (q_lo > p_hi ? __fsub_rn(q_lo, p_hi) : 0.f);
}

// boxes[b, c] = (lo, hi) of chunk c's valid points as two float4; an empty
// chunk gets lo = +inf, hi = -inf, which every box test skips.
__global__ void __launch_bounds__(kBoxWarps * 32)
    chunk_boxes_kernel(const float* __restrict__ xyz,
                       const unsigned char* __restrict__ mask,
                       float4* __restrict__ boxes, int n, int n_chunks) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * kBoxWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= n_chunks) return;  // whole warps
  const int i = c * kChunk + lane;
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  if (i < n && mask[static_cast<size_t>(b) * n + i]) {
    const float* p = xyz + (static_cast<size_t>(b) * n + i) * 3;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = p[a];
      hi[a] = p[a];
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], d));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], d));
    }
  }
  if (lane == 0) {
    float4* box = boxes + (static_cast<size_t>(b) * n_chunks + c) * 2;
    box[0] = make_float4(lo[0], lo[1], lo[2], 0.f);
    box[1] = make_float4(hi[0], hi[1], hi[2], 0.f);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ new_xyz,
                  const unsigned char* __restrict__ mask,
                  const float4* __restrict__ boxes,
                  int* __restrict__ idx, int* __restrict__ cnt, float r2,
                  int n, int m, int nsample, int n_chunks) {
  __shared__ float s_xyz[kRound * kChunk * 3];  // staged chunks, as they lie
  __shared__ unsigned s_pass[kRound];    // a chunk's points in the block box
  __shared__ unsigned s_want[kWarps];    // a warp's chunks of the round
  __shared__ float s_q[kWarps][3];
  __shared__ float s_box[6];             // the box of the block's queries

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + warp;
  const bool live = q < m;
  const float* pts = xyz + static_cast<size_t>(b) * n * 3;
  const unsigned char* msk = mask + static_cast<size_t>(b) * n;
  const float4* bx = boxes + static_cast<size_t>(b) * n_chunks * 2;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    const float* c = new_xyz + (static_cast<size_t>(b) * m + q) * 3;
    qx = c[0];
    qy = c[1];
    qz = c[2];
  }
  if (lane == 0) {
    s_q[warp][0] = live ? qx : NAN;  // fminf / fmaxf skip a NaN
    s_q[warp][1] = live ? qy : NAN;
    s_q[warp][2] = live ? qz : NAN;
  }
  __syncthreads();
  // the box of the block's queries (NaN coordinates left out: such a query
  // tests false against every point), kept in shared memory
  if (threadIdx.x < 3) {
    const int a = threadIdx.x;
    float lo = INFINITY, hi = -INFINITY;
    for (int w = 0; w < kWarps; ++w) {
      lo = fminf(lo, s_q[w][a]);
      hi = fmaxf(hi, s_q[w][a]);
    }
    s_box[a] = lo;
    s_box[3 + a] = hi;
  }

  int* out = idx + (static_cast<size_t>(b) * m + (live ? q : 0)) * nsample;
  int count = 0;      // hits so far, uncapped within the chunk that filled
  int first = 0;      // index of the first hit
  bool done = !live;

  // this lane's chunk box for the round, loaded a round ahead
  float4 blo = make_float4(0.f, 0.f, 0.f, 0.f), bhi = blo;
  if (!done && lane < n_chunks) {
    blo = bx[lane * 2];
    bhi = bx[lane * 2 + 1];
  }
  for (int c0 = 0; c0 < n_chunks; c0 += kRound) {
    if (__syncthreads_and(done)) break;   // also fences the last readers
    // 1. which chunks of the round this warp's ball may reach
    bool visit = false;
    if (!done && c0 + lane < n_chunks) {
      visit = !(d2_of(gap(qx, qx, blo.x, bhi.x), gap(qy, qy, blo.y, bhi.y),
                      gap(qz, qz, blo.z, bhi.z)) > r2);
    }
    const unsigned want = __ballot_sync(0xffffffffu, visit);
    if (lane == 0) s_want[warp] = want;
    __syncthreads();
    const unsigned need = __reduce_or_sync(0xffffffffu, s_want[lane]);

    // 2. stage the chunks some warp visits, chunk `warp` of the round by
    // this warp, a lane a point, its loads started before the next round's
    // boxes; mark the points that may lie in a ball of the block
    const bool staged = (need >> warp) & 1u;  // uniform over the warp
    const int i = (c0 + warp) * kChunk + lane;
    bool ok = staged && i < n;
    float px = 0.f, py = 0.f, pz = 0.f;
    if (ok) {
      px = pts[static_cast<size_t>(i) * 3];
      py = pts[static_cast<size_t>(i) * 3 + 1];
      pz = pts[static_cast<size_t>(i) * 3 + 2];
      ok = msk[i] != 0;
    }
    if (!done && c0 + kRound + lane < n_chunks) {
      blo = bx[(c0 + kRound + lane) * 2];
      bhi = bx[(c0 + kRound + lane) * 2 + 1];
    }
    if (staged) {
      float* sp = s_xyz + (warp * kChunk + lane) * 3;
      sp[0] = px;
      sp[1] = py;
      sp[2] = pz;
      const bool pass =
          ok && !(d2_of(gap(s_box[0], s_box[3], px, px),
                        gap(s_box[1], s_box[4], py, py),
                        gap(s_box[2], s_box[5], pz, pz)) > r2);
      const unsigned bits = __ballot_sync(0xffffffffu, pass);
      if (lane == 0) s_pass[warp] = bits;
    }
    __syncthreads();
    if (done) continue;

    // 3. this warp's chunks that hold a marked point, in index order, their
    // marked points only
    const unsigned marked = __ballot_sync(
        0xffffffffu, ((need >> lane) & 1u) && s_pass[lane] != 0u);
    for (unsigned vis = want & marked; vis != 0u; vis &= vis - 1u) {
      const int cl = __ffs(vis) - 1;
      const unsigned bits = s_pass[cl];
      bool hit = false;
      if ((bits >> lane) & 1u) {
        const float* p = s_xyz + (cl * kChunk + lane) * 3;
        hit = d2_of(__fsub_rn(qx, p[0]), __fsub_rn(qy, p[1]),
                    __fsub_rn(qz, p[2])) <= r2;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (ballot == 0u) continue;
      const int base = (c0 + cl) * kChunk;
      if (count == 0) first = base + __ffs(ballot) - 1;
      const int slot = count + __popc(ballot & ((1u << lane) - 1u));
      if (hit && slot < nsample) out[slot] = base + lane;
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
// contiguous; boxes: scratch of b * ceil(n / 32) * 8 f32, 16-byte aligned;
// idx [b, m, nsample] int32 and cnt [b, m] int32, every element written. r2
// is the squared radius, already rounded to f32. Returns cudaGetLastError().
extern "C" int p3d_ball_query(const float* xyz, const float* new_xyz,
                              const unsigned char* mask, float* boxes,
                              int* idx, int* cnt, float r2, int b, int n,
                              int m, int nsample, void* stream) {
  if (nsample < 1 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || m == 0) return static_cast<int>(cudaSuccess);
  if (b > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (n + kChunk - 1) / kChunk;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* box4 = reinterpret_cast<float4*>(boxes);
  if (n_chunks > 0) {
    const dim3 bgrid((n_chunks + kBoxWarps - 1) / kBoxWarps, b);
    chunk_boxes_kernel<<<bgrid, kBoxWarps * 32, 0, st>>>(xyz, mask, box4, n,
                                                         n_chunks);
  }
  const dim3 grid((m + kWarps - 1) / kWarps, b);
  ball_query_kernel<<<grid, kThreads, 0, st>>>(
      xyz, new_xyz, mask, box4, idx, cnt, r2, n, m, nsample, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
