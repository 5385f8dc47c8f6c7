// Device helpers shared by the fused PFN kernels: K1 (csrc/fused_pfn.cu,
// one and two layers) and K3/K4 (csrc/fused_pfn_train.cu). The rank, keep
// and emission rules, the pillar mean, the cell centre and the point
// decoration live here once, so the kernels decorate a row bit for bit
// alike, and alike with the plain PyTorch version
// (paddle3d_tpu_torch/ops/fused_pfn.py, _decorate_plain): explicit
// round-to-nearest intrinsics, in its order, so nvcc contracts nothing into
// an FMA. So does the span machinery of the one-layer K1, K3 and K4 (the
// second half of this file).
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

#include <climits>
#include <cstdint>

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

// ---- spans: the one-layer K1, K3 and K4 ----------------------------------
//
// A block of kSpanThreads threads owns a span of rows of one scan (at most
// kMaxSpan, a multiple of 32) and stages its keys and points once, with the
// P-row halo behind it (stage_span, the convention above). It owns the
// pillars whose emission row lies in the span. span_valid_cap finds the
// rows before the scan's sentinel tail and the max_voxels cap: a row's
// pillar ordinal is at most its index, so only a span reaching past
// max_voxels rows counts the pillar heads before it (16-byte loads of the
// keys) and, by a block scan of its own heads, the cap row inside it. Then
// rank_tile walks the span in kSpanTile-row tiles, a thread a row: a
// max-scan of head rows gives each row its arrival rank, one block scan
// gives each emission row its ordinal e and its kept rows' place in a
// compacted list, and the emission thread sums its pillar's mean.

constexpr int kSpanThreads = 256;
constexpr int kSpanWarps = kSpanThreads / 32;
constexpr int kSpanTile = 256;   // rows a tile: a thread a row
constexpr int kMaxSpan = 1024;   // rows a block (a multiple of 32)
constexpr int kScanInts = kSpanWarps + 2;  // s_scan: warp totals, cap, start

static_assert(kSpanTile == kSpanThreads, "the rank pass takes a thread a row");

// Inclusive sum (or with kMax, max) of v over the block's threads in
// thread order, and the block's total (max); s_warp holds kSpanWarps ints.
// Every thread must call it.
template <bool kMax = false>
__device__ __forceinline__ int2 block_scan(int v, int* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const auto op = [](int a, int b) { return kMax ? max(a, b) : a + b; };
  const int none = kMax ? INT_MIN : 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = op(v, up);
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  int before = none, total = none;
#pragma unroll
  for (int w = 0; w < kSpanWarps; ++w) {
    const int t = s_warp[w];
    before = w < warp ? op(before, t) : before;
    total = op(total, t);
  }
  __syncthreads();
  return make_int2(op(before, v), total);
}

// Valid pillar heads among rows [0, end) of a scan (end a multiple of 4),
// summed over the block: 16-byte loads, kHeadUnroll a thread in flight,
// each lane's previous key from its neighbour lane.
constexpr int kHeadUnroll = 8;

__device__ __forceinline__ int heads_before(const int* __restrict__ kb,
                                            int end, int* s_warp) {
  int h = 0;
  const int lane = threadIdx.x & 31;
  if ((reinterpret_cast<uintptr_t>(kb) & 15) == 0) {
    const int4* k4 = reinterpret_cast<const int4*>(kb);
    const int quads = end / 4;
    // the loop runs alike for a warp's lanes (the shuffles need them all)
    for (int q0 = threadIdx.x - lane; q0 < quads;
         q0 += kSpanThreads * kHeadUnroll) {
      int4 v[kHeadUnroll];
      int first[kHeadUnroll];
#pragma unroll
      for (int u = 0; u < kHeadUnroll; ++u) {
        const int q = q0 + lane + u * kSpanThreads;
        v[u] = q < quads ? __ldg(k4 + q) : make_int4(-1, -1, -1, -1);
        first[u] = (lane == 0 && q > 0 && q < quads) ? __ldg(kb + 4 * q - 1)
                                                     : -1;
      }
#pragma unroll
      for (int u = 0; u < kHeadUnroll; ++u) {
        int prev = __shfl_up_sync(0xffffffffu, v[u].w, 1);
        if (lane == 0) prev = first[u];
        h += (v[u].x != kSent && v[u].x != -1 && v[u].x != prev) +
             (v[u].y != kSent && v[u].y != v[u].x) +
             (v[u].z != kSent && v[u].z != v[u].y) +
             (v[u].w != kSent && v[u].w != v[u].z);
      }
    }
  } else {
    for (int i = threadIdx.x; i < end; i += kSpanThreads) {
      const int k = __ldg(kb + i);
      h += k != kSent && (i == 0 || __ldg(kb + i - 1) != k);
    }
  }
  return block_scan(h, s_warp).y;
}

// The span's keys (rows [s0 - p, s0 + len] into s_key) and points (rows
// [s0 - p + 1, s0 + len) into s_pts, pw apart); no barrier.
__device__ __forceinline__ void stage_span(const int* __restrict__ kb,
                                           const float* __restrict__ pb,
                                           int n, int c_in, int p, int s0,
                                           int len, int pw, int* s_key,
                                           float* s_pts) {
  for (int t = threadIdx.x; t < len + p + 1; t += kSpanThreads) {
    const int i = s0 - p + t;
    s_key[t] = i < 0 ? -1 : (i < n ? kb[i] : kSent);
  }
  for (int ch = 0; ch < c_in; ++ch) {
    for (int j = threadIdx.x; j < len + p - 1; j += kSpanThreads) {
      const int i = s0 - p + 1 + j;
      s_pts[ch * pw + j] =
          (i >= 0 && i < n) ? pb[static_cast<size_t>(ch) * n + i] : 0.f;
    }
  }
}

// After a barrier past stage_span, every thread: the start of the segment
// holding the span's previous row, carried to the first tile in
// s_scan[kSpanWarps + 1]; -> (the span's rows before the scan's sentinel
// tail, the first row the max_voxels cap drops, or the end of those rows).
__device__ __forceinline__ int2 span_valid_cap(const int* __restrict__ kb,
                                               const int* s_key, int s0,
                                               int len, int p,
                                               int max_voxels, int* s_scan) {
  const int tid = threadIdx.x;
  // rows -1, -2, .. -p at s_key[p - 1], .., s_key[0]; at most p rows back
  // matter (a row further from its segment's start is not kept)
  if (tid < 32) {
    int run = p - 1;
    for (int j0 = 0; j0 < p - 1; j0 += 32) {
      const int j = j0 + tid;
      const unsigned eq = __ballot_sync(
          0xffffffffu, j < p - 1 && s_key[p - 2 - j] == s_key[p - 1]);
      if (eq != 0xffffffffu) {
        run = min(run, j0 + __ffs(~eq) - 1);
        break;
      }
    }
    if (tid == 0) s_scan[kSpanWarps + 1] = -1 - run;
  }
  // the rows before the sentinel tail (keys sort it last): the rows after
  // them keep and emit nothing
  int valid = 0;
  for (int r0 = 0; r0 < len; r0 += kSpanThreads) {
    const int r = r0 + tid;
    valid += __syncthreads_count(r < len && s_key[r + p] != kSent);
  }
  // the max_voxels cap: rows from `cap` on keep nothing
  int cap = s0 + valid;
  if (valid > 0 && s0 + valid > max_voxels) {  // uniform over the block
    int before = heads_before(kb, s0, s_scan);
    if (before > max_voxels) {
      cap = s0;
    } else {
      if (tid == 0) s_scan[kSpanWarps] = cap;
      for (int r0 = 0; r0 < valid && before <= max_voxels;
           r0 += kSpanThreads) {
        const int r = r0 + tid;
        const int head = r < valid && s_key[r + p] != s_key[r + p - 1];
        const int2 sc = block_scan(head, s_scan);
        if (head && before + sc.x == max_voxels + 1) {
          s_scan[kSpanWarps] = s0 + r;
        }
        before += sc.y;
      }
      __syncthreads();
      cap = s_scan[kSpanWarps];
    }
  }
  return make_int2(valid, cap);
}

// The shared-memory lists of one tile's pillars (those whose emission row
// lies in the tile), e in emission order: kstart[e] its first kept row in
// the compacted kept list (kstart[n_emit] = n_kept), kown / kcol a kept
// row's pillar and s_pts column, mean / cx / cy the pillar's mean and cell
// centre; erow[e] its emission row in the scan and eidx[r] tile row r's
// pillar or -1, each where not null.
struct TileLists {
  int* kstart;
  int* kown;
  int* kcol;
  float* mean;
  float* cx;
  float* cy;
  int* erow;
  int* eidx;
};

// One tile's rank pass, every thread (the tile's rows t0 .. t0 + 255 of
// the span, a thread a row, t0 < valid): each row's arrival rank in its
// pillar from a max-scan of the tile's head rows (and the start carried
// from the rows before), one scan of (emits, kept rows) for the lists, the
// emission thread's mean and centre; ends in a barrier. -> (n_emit,
// n_kept).
__device__ __forceinline__ int2 rank_tile(int t0, int valid, int cap, int s0,
                                          int p, int pw, const Geometry& geo,
                                          const int* s_key,
                                          const float* s_pts, int* s_scan,
                                          const TileLists& L) {
  const int tid = threadIdx.x;
  const int r = t0 + tid;
  const bool in = r < valid;
  const int key = in ? s_key[r + p] : kSent;
  const int start = max(
      block_scan<true>(in && key != s_key[r + p - 1] ? r : INT_MIN,
                       s_scan).x,
      s_scan[kSpanWarps + 1]);
  // kept: before the cap, a rank below p (the key is no sentinel: in); it
  // emits as its pillar's last kept row
  int rank = -1;
  if (in && s0 + r < cap && r - start < p &&
      (s_key[r + p + 1] != key || r - start == p - 1)) {
    rank = r - start;
  }
  const int packed = rank >= 0 ? (1 << 16) | (rank + 1) : 0;
  const int2 sc = block_scan(packed, s_scan);
  if (tid == kSpanTile - 1) s_scan[kSpanWarps + 1] = start;  // next tile's
  const int n_emit = sc.y >> 16;
  const int n_kept = sc.y & 0xffff;
  const int excl = sc.x - packed;
  if (L.eidx != nullptr) L.eidx[tid] = rank >= 0 ? excl >> 16 : -1;
  if (rank >= 0) {
    const int e = excl >> 16;
    const int k = excl & 0xffff;
    const int j0 = r + p - 1 - rank;  // the pillar's head in s_pts
    L.kstart[e] = k;
    if (L.erow != nullptr) L.erow[e] = s0 + r;
    for (int j = 0; j <= rank; ++j) {
      L.kown[k + j] = e;
      L.kcol[k + j] = j0 + j;
    }
    pillar_mean(s_pts, pw, j0, rank, L.mean + 3 * e);
    cell_centre(s_key[r + p], geo, L.cx + e, L.cy + e);
  }
  if (tid == 0) L.kstart[n_emit] = n_kept;
  __syncthreads();
  return make_int2(n_emit, n_kept);
}

}  // namespace p3d
