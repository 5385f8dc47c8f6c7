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
// has no carry here: blocks run in no order. Each kernel finds the cap row
// itself instead (below).
//
// One PFN layer (p3d_fused_pfn_rows; PointPillars-KITTI serving, and its
// training with the batch statistics folded into W1 and b1). What bounds
// it on the H100: neither bytes nor FLOPs at the KITTI shape (8 x 20,000
// rows, ~143,000 kept, u1 = 64: ~2.6 MB of points in, ~42 MB of rows out,
// ~0.16 GFLOP, rounded multiplies and adds: 13 us of bytes), so a block's
// latency: staging, the rank scans and their barriers, then one product
// chain a kept row and channel. Design: the span machinery of the train
// kernels (csrc/pfn_common.cuh: a block a span of ~600 rows of one scan,
// about two blocks an SM, keys and points staged once with the P-row
// halo; the max_voxels cap found inside the span, which costs nothing
// where a span ends before row max_voxels, as at KITTI serving; ranks by a
// max-scan of head rows; the sentinel tail skipped; each 256-row tile's
// emission rows and their kept rows compacted into lists). Each kept row
// is decorated once; a group of threads, a thread a channel with W1's row
// and the bias in registers, takes a run of whole pillars and computes
// four kept rows at once, each product from the bias up in k order, the
// row read as float4 broadcasts; the pillar max goes to shared memory at
// its last kept row, and the tile's channel rows leave as 16-byte streaming
// stores, zeros included, each element written once (no memset). A layer
// wider than 64 channels takes them 64 at a time. The earlier design
// (128-row blocks with a halo each, a walk of up to P neighbours a row,
// the decoration redone for every channel, the wrapper's cumsum of head
// flags for the cap) took 0.19 ms at KITTI serving. The TPU's lane rolls
// and doubling scans have no counterpart.
//
// Two PFN layers (p3d_fused_pfn2_rows, the TPU kernel's n_layers == 2
// branch, CenterPoint-pillars): y1 = relu(W1 x + b1) on every kept row,
// m1 = the max of y1 over the pillar's kept rows, t = relu(W2 [y1, m1] +
// b2) on every kept row, and the max of t over them at the emission row.
// What bounds it: at nuScenes (8 x 250,000 rows, u1 = 32, u2 = 64) ~2e6
// kept rows each need 32 x 10 + 64 x 32 products (the m1 half of W2 is per
// pillar), each a rounded multiply and a rounded add (no FMA: the plain
// version's bits), ~0.3 ms of f32 instructions on 132 SMs, against ~40 MB of
// points in and ~512 MB of mostly-zero rows out (~0.17 ms). A kernel that
// loads both operands of a product from shared memory is bound by those
// loads instead (two a product, ~1.1 ms). Design: persistent blocks (two
// an SM) walk 128-row tiles and own the pillars whose emission row lies in
// the tile (the train kernels' rule, csrc/fused_pfn_train.cu), so every
// row they need lies in the staged window; the weights are staged once a
// block. A tile compacts its emission rows and their kept rows into lists
// (two warp scans), so no thread walks a row that emits nothing. Each
// product then has one operand in a register and the other in a 16-byte
// broadcast load shared by four products: W1 a lane, a warp a kept row for
// layer 1; the m1 half of W2 a thread, a thread an (emission row, channel)
// for the pillar base; the y1 half of W2 in registers for the whole run, a
// thread an output channel over four kept rows at once for the rest. The
// pillar max runs over relu(t) a (kept row, channel) in shared memory, and
// the tile leaves as 16-byte streaming stores, zeros included. The cap is
// one row a scan from two small passes of its own (the wrapper's cumsum of
// head flags over every row took 0.36 ms at nuScenes on an H100), and a
// tile from the cap on writes its zeros and nothing else.
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

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// ---- one layer -----------------------------------------------------------

constexpr int kGroupC = 64;        // channels a group, a thread a channel
constexpr int kRes = kGroupC + 1;  // s_res row stride (see the writes)
constexpr int kIlp1 = 4;           // kept rows a thread carries at once

// Shared memory of the one-layer kernel, byte offsets from a 16-byte
// aligned base.
struct Layout1 {
  int x, res, pts, mean, cx, cy, key, kown, kcol, kstart, eidx, scan, bytes;
};

__host__ __device__ inline Layout1 layout1(int c_in, int kx, int p,
                                           int span) {
  const int kmax = p3d::kSpanTile + p - 1;  // kept rows of a tile's pillars
  const int pw = span + p - 1;
  Layout1 l{};
  int o = 0;
  l.x = o;      o += round_up(kmax * kx * 4, 16);   // [kept][kx] decorated
  l.res = o;    o += p3d::kSpanTile * kRes * 4;     // [emit][kRes] maxima
  l.pts = o;    o += round_up(c_in * pw * 4, 16);
  l.mean = o;   o += p3d::kSpanTile * 3 * 4;
  l.cx = o;     o += p3d::kSpanTile * 4;
  l.cy = o;     o += p3d::kSpanTile * 4;
  l.key = o;    o += round_up((span + p + 1) * 4, 16);
  l.kown = o;   o += round_up(kmax * 4, 16);
  l.kcol = o;   o += round_up(kmax * 4, 16);
  l.kstart = o; o += round_up((p3d::kSpanTile + 1) * 4, 16);
  l.eidx = o;   o += p3d::kSpanTile * 4;            // tile row -> e or -1
  l.scan = o;   o += round_up(p3d::kScanInts * 4, 16);
  l.bytes = o;
  return l;
}

// value(k, t) into channel rows k < nch of p (n floats apart), tile rows
// t < rows: 16-byte streaming stores where a channel row's 16-byte units
// lie whole in [0, rows), scalar ones at its ends. Every element once.
template <typename Value>
__device__ __forceinline__ void write_tile(float* p, size_t n, int nch,
                                           int rows, Value value) {
  const int um = (rows + 6) >> 2;  // 16-byte units a row, at most
  for (int f = threadIdx.x; f < nch * um; f += p3d::kSpanThreads) {
    const int k = f / um;
    const int u = f - k * um;
    float* row = p + k * n;
    const int ph = static_cast<int>(reinterpret_cast<size_t>(row) >> 2) & 3;
    const int t = 4 * u - ph;        // the unit's first tile row
    if (t >= rows) continue;
    if (t >= 0 && t + 4 <= rows) {
      __stcs(reinterpret_cast<float4*>(row + t),
             make_float4(value(k, t), value(k, t + 1), value(k, t + 2),
                         value(k, t + 3)));
    } else {
      for (int j = max(t, 0); j < min(t + 4, rows); ++j) {
        __stcs(row + j, value(k, j));
      }
    }
  }
}

// One block a span of one scan (p3d's span machinery: staging, the cap,
// the rank pass and the tile's pillar lists). Per 256-row tile: each kept
// row decorated once (s_x); then, per group of gs channels, a group of gs
// threads (a thread a channel, W1's row and the bias in registers) takes a
// run of whole pillars holding about 1 / groups of the tile's kept rows and
// computes relu(b1 + W1 x) of kIlp1 rows at once, each from the bias up in
// k order, the row read as float4 broadcasts; the pillar max goes to s_res
// at its last kept row; then the tile's channel rows of that group leave
// as 16-byte streaming stores, zeros included (with the occupancy channel
// after the last group). A tile from the sentinel tail on writes zeros
// only. kCin / kDist as in the train kernels: KITTI's 4 point channels
// without the distance, or 0 for any (guarded).
template <int kCin, bool kDist>
__global__ void __launch_bounds__(p3d::kSpanThreads, 2)
    fused_pfn_kernel(const int* __restrict__ keys,
                     const float* __restrict__ pts,
                     const float* __restrict__ w1t,
                     const float* __restrict__ b1, float* __restrict__ out,
                     int n, int c_in_arg, int c_dec_arg, int u1, int p,
                     int max_voxels, int span, Geometry geo,
                     int with_distance_arg, int occupancy) {
  constexpr int kN = kCin ? kCin + 5 + kDist : kMaxCdec;
  constexpr int kX = (kN + 3) & ~3;   // s_x row: float4 loads
  const int c_dec = kCin ? kN : c_dec_arg;
  const int c_in = kCin ? kCin : c_in_arg;
  const bool with_distance = kCin ? kDist : with_distance_arg != 0;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const Layout1 L = layout1(c_in, kX, p, span);
  float* s_x = reinterpret_cast<float*>(base + L.x);
  float* s_res = reinterpret_cast<float*>(base + L.res);
  float* s_pts = reinterpret_cast<float*>(base + L.pts);
  int* s_key = reinterpret_cast<int*>(base + L.key);
  int* s_kstart = reinterpret_cast<int*>(base + L.kstart);
  int* s_eidx = reinterpret_cast<int*>(base + L.eidx);
  int* s_scan = reinterpret_cast<int*>(base + L.scan);
  const p3d::TileLists lists{
      s_kstart, reinterpret_cast<int*>(base + L.kown),
      reinterpret_cast<int*>(base + L.kcol),
      reinterpret_cast<float*>(base + L.mean),
      reinterpret_cast<float*>(base + L.cx),
      reinterpret_cast<float*>(base + L.cy), nullptr, s_eidx};

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * span;
  const int len = max(0, min(span, n - s0));
  const int pw = span + p - 1;  // points of rows [s0 - p + 1, s0 + span)
  const int* kb = keys + static_cast<size_t>(b) * n;
  const float* pb = pts + static_cast<size_t>(b) * c_in * n;
  const int gs = u1 <= 32 ? 32 : kGroupC;  // a group: a thread a channel
  const int groups = p3d::kSpanThreads / gs;
  const int c = tid % gs;
  const int grp = tid / gs;

  p3d::stage_span(kb, pb, n, c_in, p, s0, len, pw, s_key, s_pts);
  // W1's row and the bias of channel cg + c
  float w[kN];
  float bias = 0.f;
  auto load_w = [&](int cg) {
    const bool live = cg + c < u1;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      w[k] = (live && k < c_dec) ? w1t[(cg + c) * c_dec + k] : 0.f;
    }
    bias = live ? b1[cg + c] : 0.f;
  };
  load_w(0);
  __syncthreads();
  const int2 vc = p3d::span_valid_cap(kb, s_key, s0, len, p, max_voxels,
                                      s_scan);
  const int valid = vc.x;

  const int c_out = u1 + (occupancy ? 1 : 0);
  float* ob = out + static_cast<size_t>(b) * c_out * n + s0;
  for (int t0 = 0; t0 < len; t0 += p3d::kSpanTile) {
    const int rows = min(p3d::kSpanTile, len - t0);
    int n_emit = 0, n_kept = 0;
    if (t0 < valid) {  // uniform over the block
      const int2 ek = p3d::rank_tile(t0, valid, vc.y, s0, p, pw, geo, s_key,
                                     s_pts, s_scan, lists);
      n_emit = ek.x;
      n_kept = ek.y;
      // each kept row decorated once
      for (int q = tid; q < n_kept; q += p3d::kSpanThreads) {
        const int e = lists.kown[q];
        float x[kX > kMaxCdec ? kX : kMaxCdec];
        p3d::decorate(s_pts, pw, lists.kcol[q], c_in, lists.mean + 3 * e,
                      lists.cx[e], lists.cy[e], with_distance, x);
#pragma unroll
        for (int k = 0; k < kX; ++k) s_x[q * kX + k] = k < c_dec ? x[k] : 0.f;
      }
    } else {
      s_eidx[tid] = -1;  // the sentinel tail: zeros only
    }
    __syncthreads();

    // the group's run of whole pillars: from the first pillar at or past
    // kept row grp * n_kept / groups
    auto first_at = [&](int row) {
      int lo = 0, hi = n_emit;
      while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (s_kstart[mid] < row) lo = mid + 1; else hi = mid;
      }
      return lo;
    };
    const int e_lo = first_at(grp * n_kept / groups);
    const int e_hi = first_at((grp + 1) * n_kept / groups);
    for (int cg = 0; cg < u1; cg += gs) {
      if (u1 > gs) load_w(cg);  // a layer wider than a group
      if (e_lo < e_hi) {  // uniform over the group
        // relu(b1 + W1 x) of the group's kept rows in row order, kIlp1 at
        // once, and each pillar's max over its kept rows into s_res
        int e = e_lo;
        int q_last = s_kstart[e + 1] - 1;
        const int q_hi = s_kstart[e_hi];
        float m = -INFINITY;
        for (int q0 = s_kstart[e_lo]; q0 < q_hi; q0 += kIlp1) {
          float y[kIlp1];
#pragma unroll
          for (int i = 0; i < kIlp1; ++i) {
            const float4* xr = reinterpret_cast<const float4*>(
                s_x + min(q0 + i, q_hi - 1) * kX);
            float v = bias;
#pragma unroll
            for (int k4 = 0; k4 < kX / 4; ++k4) {
              const float4 f = xr[k4];
              const float xs[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int k = 4 * k4 + j;
                if (k < kN && k < c_dec) {
                  v = __fadd_rn(v, __fmul_rn(w[k], xs[j]));
                }
              }
            }
            y[i] = fmaxf(v, 0.f);
          }
#pragma unroll
          for (int i = 0; i < kIlp1; ++i) {
            if (q0 + i < q_hi) {
              m = fmaxf(m, y[i]);
              if (q0 + i == q_last) {  // the pillar's last kept row
                s_res[e * kRes + c] = m;
                m = -INFINITY;
                ++e;
                q_last = e < e_hi ? s_kstart[e + 1] - 1 : -1;
              }
            }
          }
        }
      }
      __syncthreads();
      // the tile's rows of channels cg .. cg + ce - 1 (and the occupancy
      // after the last group), zero off emission rows
      const int ce = min(gs, u1 - cg);
      const bool last = cg + gs >= u1;
      write_tile(ob + static_cast<size_t>(cg) * n + t0, n,
                 ce + (last && occupancy ? 1 : 0), rows,
                 [&](int k, int t) {
                   const int e = s_eidx[t];
                   return e < 0 ? 0.f : (k < ce ? s_res[e * kRes + k] : 1.f);
                 });
      __syncthreads();  // s_res and the lists are read before they change
    }
  }
}

// ---- two layers ----------------------------------------------------------

constexpr int kRows2 = 128;                  // rows a tile: four warps of one
constexpr int kThreads2 = 256;
constexpr int kWarps2 = kThreads2 / 32;
constexpr int kU1 = 32;                      // widest first layer taken
constexpr int kU2 = 64;                      // widest second layer taken
constexpr int kTeams = kThreads2 / kU2;      // row teams, a thread a channel
constexpr int kXs = 16;                      // s_x row stride, float4 rows
constexpr int kRs = kU2 + 1;                 // s_res row stride (see below)
constexpr int kIlp = 4;                      // rows a thread carries at once

static_assert(kRows2 == 4 * 32, "the row scan takes four warps");
static_assert(kMaxCdec <= kXs, "an s_x row holds every decorated channel");
static_assert(kU1 == 32, "a warp is one first-layer row");

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ constexpr int max3(int a, int b, int c) {
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// The max_voxels cap as one row a scan: cap[b] is the first row whose
// pillar ordinal in key order reaches max_voxels (n if none), so a row is
// kept by the cap exactly when it lies before cap[b]. Two small passes in
// place of a cumsum of head flags over every row: the valid pillar heads of
// each kCapRows-row chunk, then, a block a scan, the chunk where their
// running count passes max_voxels and the row inside it.
constexpr int kCapRows = 4096;
constexpr int kCapThreads = 1024;            // 4 rows a thread, a chunk

__device__ __forceinline__ int is_head(const int* kb, int i) {
  const int k = kb[i];
  return k != p3d::kSent && (i == 0 || kb[i - 1] != k);
}

// Inclusive sum of v over the block's threads in thread order, and the
// block's total; s_warp holds kCapThreads / 32 ints.
__device__ __forceinline__ int2 block_scan(int v, int* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += up;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < kCapThreads / 32; ++w) {
    const int t = s_warp[w];
    before += w < warp ? t : 0;
    total += t;
  }
  __syncthreads();
  return make_int2(before + v, total);
}

__global__ void __launch_bounds__(kCapThreads)
    pillar_heads_kernel(const int* __restrict__ keys, int* __restrict__ heads,
                        int n, int chunks) {
  __shared__ int s_warp[kCapThreads / 32];
  const int b = blockIdx.y;
  const int* kb = keys + static_cast<size_t>(b) * n;
  const int r = blockIdx.x * kCapRows + 4 * threadIdx.x;
  int h = 0;
  for (int j = 0; j < 4; ++j) h += r + j < n ? is_head(kb, r + j) : 0;
  const int2 sum = block_scan(h, s_warp);
  if (threadIdx.x == 0) heads[b * chunks + blockIdx.x] = sum.y;
}

__global__ void __launch_bounds__(kCapThreads)
    pillar_cap_kernel(const int* __restrict__ keys,
                      const int* __restrict__ heads, int* __restrict__ cap,
                      int n, int chunks, int max_voxels) {
  __shared__ int s_warp[kCapThreads / 32];
  __shared__ int s_hit[2];
  const int b = blockIdx.x;
  const int* kb = keys + static_cast<size_t>(b) * n;
  // the chunk where the running count of heads passes max_voxels, and the
  // heads before it
  int before = 0;
  bool found = false;
  for (int c0 = 0; c0 < chunks && !found; c0 += kCapThreads) {
    const int c = c0 + static_cast<int>(threadIdx.x);
    const int h = c < chunks ? heads[b * chunks + c] : 0;
    const int2 sum = block_scan(h, s_warp);
    const bool hit = before + sum.x > max_voxels &&
                     before + sum.x - h <= max_voxels;
    if (hit) {  // one thread at most
      s_hit[0] = c;
      s_hit[1] = before + sum.x - h;
    }
    before += sum.y;
    found = __syncthreads_or(hit);
  }
  if (!found) {
    if (threadIdx.x == 0) cap[b] = n;
    return;
  }
  const int chunk = s_hit[0];
  before = s_hit[1];
  // the row inside that chunk holding the (max_voxels - before + 1)-th head
  const int r = chunk * kCapRows + 4 * threadIdx.x;
  int f[4];
  int h = 0;
  for (int j = 0; j < 4; ++j) {
    f[j] = r + j < n ? is_head(kb, r + j) : 0;
    h += f[j];
  }
  int seen = before + block_scan(h, s_warp).x - h;
  for (int j = 0; j < 4; ++j) {
    seen += f[j];
    if (f[j] && seen == max_voxels + 1) cap[b] = r + j;
  }
}

// Shared memory of the two-layer kernel, in 4-byte words from a 16-byte
// aligned base; every array read by float4 / int4 starts on 16 bytes.
struct Layout2 {
  int w1, b1, w2m, b2, pts, y1, t, res, mean, cx, cy, floats;
  int eidx, key, kstart, kown, kcol, wsum, ints;
};

__host__ __device__ inline Layout2 layout2(int c_in, int p) {
  const int pw = kRows2 + p - 1;
  Layout2 l{};
  int f = 0;
  l.w1 = f;   f += kXs * kU1;          // [kXs][kU1]: W1 by input channel
  l.b1 = f;   f += kU1;
  l.w2m = f;  f += kU1 * kU2;          // [kU1][kU2]: the m1 half of W2
  l.b2 = f;   f += kU2;
  l.pts = f;  f += round4(c_in * pw);  // [c_in][pw] the point window
  l.y1 = f;   f += pw * kU1;           // [kept][kU1] first-layer rows
  l.t = f;    f += max3(pw * kU2, pw * kXs, kRows2 * kU1);
  l.res = f;  f += kRows2 * kRs;       // [emit][kRs] base, then the max
  l.mean = f; f += 3 * kRows2;
  l.cx = f;   f += kRows2;
  l.cy = f;   f += kRows2;
  l.floats = f;
  int i = 0;
  l.eidx = i;   i += kRows2;           // tile row -> emission ordinal or -1
  l.key = i;    i += kRows2 + p + 1;
  l.kstart = i; i += kRows2 + 1;       // emission -> its first kept row
  l.kown = i;   i += pw;               // kept row -> its emission
  l.kcol = i;   i += pw;               // kept row -> its s_pts column
  l.wsum = i;   i += 10;               // the row scan's warp totals, E, K
  l.ints = i;
  return l;
}

size_t smem2_bytes(int c_in, int p) {
  const Layout2 l = layout2(c_in, p);
  return static_cast<size_t>(l.floats + l.ints) * sizeof(float);
}

// One tile of 128 rows at a time, persistent blocks (weights staged once a
// block). Per tile: the rank pass and two warp scans give each emission row
// its ordinal e and the start of its kept rows in a compacted kept list;
// the kept rows are decorated once (s_x); layer 1 runs a warp a kept row,
// a lane a channel, W1 in registers and the row read as float4
// broadcasts (s_y1); m1 is the pillar max of y1; the base b2 + W2m m1 runs
// a thread an (emission, output channel), W2m in registers; layer 2 runs a
// thread an output channel over four kept rows at once, the y1 half of W2
// in registers for the whole run and y1 read as float4 broadcasts, and
// writes relu(t) a (kept row, channel) (s_t); the pillar max over s_t goes
// to s_res; the tile leaves as 16-byte streaming stores, zeros included.
// kRs = kU2 + 1 keeps s_res conflict-free both by channel (layers) and by
// row (the stores).
template <bool kFull>
__global__ void __launch_bounds__(kThreads2, 2)
    fused_pfn2_kernel(const int* __restrict__ keys,
                      const float* __restrict__ pts,
                      const int* __restrict__ cap,
                      const float* __restrict__ w1t,
                      const float* __restrict__ b1,
                      const float* __restrict__ w2t,
                      const float* __restrict__ b2, float* __restrict__ out,
                      int nb, int n, int c_in, int c_dec, int u1_arg,
                      int u2_arg, int p, int max_voxels, Geometry geo,
                      int with_distance, int occupancy) {
  // kFull: the widths are the kernel's own, so every width guard folds away
  const int u1 = kFull ? kU1 : u1_arg;
  const int u2 = kFull ? kU2 : u2_arg;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout2 L = layout2(c_in, p);
  float* s_w1 = smem + L.w1;
  float* s_b1 = smem + L.b1;
  float* s_w2m = smem + L.w2m;
  float* s_b2 = smem + L.b2;
  float* s_pts = smem + L.pts;
  float* s_y1 = smem + L.y1;
  float* s_t = smem + L.t;      // s_x, then s_m1, then s_t
  float* s_x = s_t;
  float* s_m1 = s_t;
  float* s_res = smem + L.res;
  float* s_mean = smem + L.mean;
  float* s_cx = smem + L.cx;
  float* s_cy = smem + L.cy;
  int* ismem = reinterpret_cast<int*>(smem + L.floats);
  int* s_eidx = ismem + L.eidx;
  int* s_key = ismem + L.key;
  int* s_kstart = ismem + L.kstart;
  int* s_kown = ismem + L.kown;
  int* s_kcol = ismem + L.kcol;
  int* s_wsum = ismem + L.wsum;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int pw = kRows2 + p - 1;  // points of rows [r0 - p + 1, r0 + kRows2)
  const int kw = kRows2 + p + 1;  // keys of rows [r0 - p, r0 + kRows2]
  const int o = tid % kU2;        // this thread's output channel (layer 2)
  const int team = tid / kU2;

  // weights once a block, each thread reading its own column (a transposed
  // store by consecutive threads would hit one bank)
  for (int t = tid; t < kXs * kU1; t += kThreads2) {
    const int q = t / kU1;
    const int c = t - q * kU1;
    s_w1[t] = (q < c_dec && c < u1) ? w1t[c * c_dec + q] : 0.f;
  }
  for (int t = tid; t < kU1; t += kThreads2) s_b1[t] = t < u1 ? b1[t] : 0.f;
  for (int t = tid; t < kU1 * kU2; t += kThreads2) {
    const int k = t / kU2;
    const int c = t - k * kU2;
    s_w2m[t] = (k < u1 && c < u2) ? w2t[c * 2 * u1 + u1 + k] : 0.f;
  }
  for (int t = tid; t < kU2; t += kThreads2) s_b2[t] = t < u2 ? b2[t] : 0.f;
  float w2y[kU1];  // the y1 half of W2 for channel o, for the whole run
#pragma unroll
  for (int k = 0; k < kU1; ++k) {
    w2y[k] = (k < u1 && o < u2) ? w2t[o * 2 * u1 + k] : 0.f;
  }

  const int tiles = (n + kRows2 - 1) / kRows2;
  for (int tile = blockIdx.x; tile < nb * tiles; tile += gridDim.x) {
    const int b = tile / tiles;
    const int r0 = (tile - b * tiles) * kRows2;
    const int* kb = keys + static_cast<size_t>(b) * n;
    const float* pb = pts + static_cast<size_t>(b) * c_in * n;
    // from the max_voxels cap or the scan's last valid row on (sentinels
    // sort last), a tile keeps no row: zeros only
    const int cap_b = cap[b];
    const bool empty = r0 >= cap_b || kb[r0] == p3d::kSent;
    __syncthreads();  // the last tile's readers are done
    if (!empty) {  // uniform over the block
      for (int t = tid; t < kw; t += kThreads2) {
        const int i = r0 - p + t;
        s_key[t] = i < 0 ? -1 : (i < n ? kb[i] : p3d::kSent);
      }
      for (int t = tid; t < c_in * pw; t += kThreads2) {
        const int ch = t / pw;
        const int i = r0 - p + 1 + (t - ch * pw);
        s_pts[t] = (i >= 0 && i < n) ? pb[static_cast<size_t>(ch) * n + i]
                                     : 0.f;
      }
      __syncthreads();

      // each tile row's emission rank; scans of (emits, kept rows) give an
      // emission row its ordinal e and its first kept row in the kept list
      int rank = -1;
      if (tid < kRows2 && r0 + tid < n) {
        rank = p3d::emit_rank(s_key, tid + p, p,
                              r0 + tid < cap_b ? 0 : max_voxels, max_voxels);
      }
      int e_incl = rank >= 0 ? 1 : 0;
      int k_incl = rank + 1;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int e_up = __shfl_up_sync(0xffffffffu, e_incl, d);
        const int k_up = __shfl_up_sync(0xffffffffu, k_incl, d);
        if (lane >= d) {
          e_incl += e_up;
          k_incl += k_up;
        }
      }
      if (tid < kRows2 && lane == 31) {
        s_wsum[2 * warp] = e_incl;
        s_wsum[2 * warp + 1] = k_incl;
      }
      __syncthreads();
      if (tid < kRows2) {
        int e0 = 0, k0 = 0;
        for (int w = 0; w < warp; ++w) {
          e0 += s_wsum[2 * w];
          k0 += s_wsum[2 * w + 1];
        }
        s_eidx[tid] = rank >= 0 ? e0 + e_incl - 1 : -1;
        if (rank >= 0) {
          const int e = e0 + e_incl - 1;
          const int k = k0 + k_incl - rank - 1;
          const int j0 = tid + p - 1 - rank;  // the pillar's head in s_pts
          s_kstart[e] = k;
          for (int j = 0; j <= rank; ++j) {
            s_kown[k + j] = e;
            s_kcol[k + j] = j0 + j;
          }
          p3d::pillar_mean(s_pts, pw, j0, rank, s_mean + 3 * e);
          p3d::cell_centre(s_key[tid + p], geo, s_cx + e, s_cy + e);
        }
        if (tid == kRows2 - 1) {
          s_wsum[8] = e0 + e_incl;
          s_wsum[9] = k0 + k_incl;
          s_kstart[e0 + e_incl] = k0 + k_incl;
        }
      }
      __syncthreads();
      const int n_emit = s_wsum[8];
      const int n_kept = s_wsum[9];

      if (n_emit > 0) {  // uniform over the block
        // decorate each kept row once
        for (int q = tid; q < n_kept; q += kThreads2) {
          const int e = s_kown[q];
          float x[kMaxCdec];
          p3d::decorate(s_pts, pw, s_kcol[q], c_in, s_mean + 3 * e, s_cx[e],
                        s_cy[e], with_distance, x);
#pragma unroll
          for (int k = 0; k < kMaxCdec; ++k) {
            if (k < c_dec) s_x[q * kXs + k] = x[k];
          }
        }
        __syncthreads();

        // y1 = relu(b1 + W1 x), from the bias up in k order: a warp a kept
        // row (kIlp at once), a lane a channel
        {
          float w1[kXs];
#pragma unroll
          for (int k = 0; k < kXs; ++k) w1[k] = s_w1[k * kU1 + lane];
          const float bias = s_b1[lane];
          for (int q0 = warp * kIlp; q0 < n_kept; q0 += kWarps2 * kIlp) {
            float v[kIlp];
#pragma unroll
            for (int i = 0; i < kIlp; ++i) v[i] = bias;
#pragma unroll
            for (int k4 = 0; k4 < kXs / 4; ++k4) {
              if (4 * k4 >= c_dec) break;
#pragma unroll
              for (int i = 0; i < kIlp; ++i) {
                const int q = min(q0 + i, n_kept - 1);
                const float4 xv =
                    reinterpret_cast<const float4*>(s_x + q * kXs)[k4];
                const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  if (4 * k4 + j < c_dec) {
                    v[i] = __fadd_rn(v[i], __fmul_rn(w1[4 * k4 + j], xs[j]));
                  }
                }
              }
            }
#pragma unroll
            for (int i = 0; i < kIlp; ++i) {
              if (q0 + i < n_kept) {
                s_y1[(q0 + i) * kU1 + lane] =
                    lane < u1 ? fmaxf(v[i], 0.f) : 0.f;
              }
            }
          }
        }
        __syncthreads();

        // m1: the pillar max of y1, per emission row and channel
        for (int f = tid; f < n_emit * kU1; f += kThreads2) {
          const int e = f / kU1;
          const int c = f - e * kU1;
          float m = -INFINITY;
          for (int q = s_kstart[e]; q < s_kstart[e + 1]; ++q) {
            m = fmaxf(m, s_y1[q * kU1 + c]);
          }
          s_m1[f] = m;
        }
        __syncthreads();

        // the pillar's base b2 + W2[:, u1:] m1, from the bias up in k order:
        // a thread an (emission row, output channel), kIlp rows at once
        {
          float w2m[kU1];
#pragma unroll
          for (int k = 0; k < kU1; ++k) w2m[k] = s_w2m[k * kU2 + o];
          const float bias = s_b2[o];
          for (int e0 = team * kIlp; e0 < n_emit; e0 += kTeams * kIlp) {
            float v[kIlp];
#pragma unroll
            for (int i = 0; i < kIlp; ++i) v[i] = bias;
#pragma unroll
            for (int k4 = 0; k4 < kU1 / 4; ++k4) {
              if (!kFull && 4 * k4 >= u1) break;
#pragma unroll
              for (int i = 0; i < kIlp; ++i) {
                const int e = min(e0 + i, n_emit - 1);
                const float4 mv =
                    reinterpret_cast<const float4*>(s_m1 + e * kU1)[k4];
                const float ms[4] = {mv.x, mv.y, mv.z, mv.w};
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  if (kFull || 4 * k4 + j < u1) {
                    v[i] = __fadd_rn(v[i], __fmul_rn(w2m[4 * k4 + j], ms[j]));
                  }
                }
              }
            }
#pragma unroll
            for (int i = 0; i < kIlp; ++i) {
              if (e0 + i < n_emit) s_res[(e0 + i) * kRs + o] = v[i];
            }
          }
        }
        __syncthreads();

        // t = relu(base + W2[:, :u1] y1), the y1 half in k order after the
        // m1 half: a thread an output channel, kIlp kept rows at once
        for (int q0 = team * kIlp; q0 < n_kept; q0 += kTeams * kIlp) {
          float v[kIlp];
#pragma unroll
          for (int i = 0; i < kIlp; ++i) {
            const int q = min(q0 + i, n_kept - 1);
            v[i] = s_res[s_kown[q] * kRs + o];
          }
#pragma unroll
          for (int k4 = 0; k4 < kU1 / 4; ++k4) {
            if (!kFull && 4 * k4 >= u1) break;
#pragma unroll
            for (int i = 0; i < kIlp; ++i) {
              const int q = min(q0 + i, n_kept - 1);
              const float4 yv =
                  reinterpret_cast<const float4*>(s_y1 + q * kU1)[k4];
              const float ys[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (kFull || 4 * k4 + j < u1) {
                  v[i] = __fadd_rn(v[i], __fmul_rn(w2y[4 * k4 + j], ys[j]));
                }
              }
            }
          }
#pragma unroll
          for (int i = 0; i < kIlp; ++i) {
            if (q0 + i < n_kept) s_t[(q0 + i) * kU2 + o] = fmaxf(v[i], 0.f);
          }
        }
        __syncthreads();

        // the pillar max of t, in row order, over the base in s_res
        for (int f = tid; f < n_emit * kU2; f += kThreads2) {
          const int e = f / kU2;
          const int c = f - e * kU2;
          float m = -INFINITY;
          for (int q = s_kstart[e]; q < s_kstart[e + 1]; ++q) {
            m = fmaxf(m, s_t[q * kU2 + c]);
          }
          s_res[e * kRs + c] = m;
        }
        __syncthreads();
      }
    }

    // the tile's [c_out][kRows2] block, zero off emission rows
    const int c_out = u2 + (occupancy ? 1 : 0);
    float* ob = out + static_cast<size_t>(b) * c_out * n + r0;
    if ((n & 3) == 0 && r0 + kRows2 <= n) {
      for (int f = tid; f < c_out * (kRows2 / 4); f += kThreads2) {
        const int c = f / (kRows2 / 4);
        const int r = 4 * (f - c * (kRows2 / 4));
        const int4 e4 = empty ? make_int4(-1, -1, -1, -1)
                              : reinterpret_cast<const int4*>(s_eidx)[r / 4];
        const int es[4] = {e4.x, e4.y, e4.z, e4.w};
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = es[j] < 0 ? 0.f : (c < u2 ? s_res[es[j] * kRs + c] : 1.f);
        }
        __stcs(reinterpret_cast<float4*>(ob + static_cast<size_t>(c) * n + r),
               make_float4(v[0], v[1], v[2], v[3]));
      }
    } else {
      for (int f = tid; f < c_out * kRows2; f += kThreads2) {
        const int c = f / kRows2;
        const int r = f - c * kRows2;
        if (r0 + r < n) {
          const int e = empty ? -1 : s_eidx[r];
          ob[static_cast<size_t>(c) * n + r] =
              e < 0 ? 0.f : (c < u2 ? s_res[e * kRs + c] : 1.f);
        }
      }
    }
  }
}

}  // namespace

// keys [b, n] int32 sorted (sentinel 2^31-1); pts [b, c_in, n] f32; w1t
// [u1, c_dec] and b1 [u1] BN-folded, any u1 >= 1; out [b, u1 (+1 with
// occupancy), n] f32, every element written once. A block a span of
// ceil(n / spans) rows rounded up to 32 (at most p3d::kMaxSpan) of one
// scan. Returns cudaGetLastError().
extern "C" int p3d_fused_pfn_rows(const int* keys, const float* pts,
                                  const float* w1t, const float* b1,
                                  float* out, int spans, int b, int n,
                                  int c_in, int c_dec, int u1, int p,
                                  int max_voxels, int nx, float vx, float vy,
                                  float x_off, float y_off, int with_distance,
                                  int occupancy, void* stream) {
  if (c_in < 3 || c_in > kMaxCin || c_dec != c_in + 5 + (with_distance ? 1 : 0)
      || p < 1 || u1 < 1 || nx < 1 || spans < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const int span = round_up((n + spans - 1) / spans, 32);
  if (span > p3d::kMaxSpan) return static_cast<int>(cudaErrorInvalidValue);
  const bool four = c_in == 4 && !with_distance;  // every config
  void (*kernel)(const int*, const float*, const float*, const float*,
                 float*, int, int, int, int, int, int, int, Geometry, int,
                 int) = four ? fused_pfn_kernel<4, false>
                             : fused_pfn_kernel<0, false>;
  const Layout1 l = layout1(c_in, four ? 12 : round_up(kMaxCdec, 4), p, span);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Geometry geo{nx, vx, vy, x_off, y_off};
  kernel<<<dim3((n + span - 1) / span, b), p3d::kSpanThreads, l.bytes,
           static_cast<cudaStream_t>(stream)>>>(
      keys, pts, w1t, b1, out, n, c_in, c_dec, u1, p, max_voxels, span, geo,
      with_distance, occupancy);
  return static_cast<int>(cudaGetLastError());
}

// Two layers: as p3d_fused_pfn_rows, but `scratch` (b * (ceil(n / 4096) +
// 1) ints, overwritten) in place of vox, plus w2t [u2, 2 u1] (columns: y1
// half, then m1 half) and b2 [u2] BN-folded, u1 <= 32 and u2 <= 64; out [b,
// u2 (+1 with occupancy), n]. Launches the two cap passes, then one
// persistent block for each that the card holds at once, at most one a
// tile.
extern "C" int p3d_fused_pfn2_rows(const int* keys, const float* pts,
                                   int* scratch, const float* w1t,
                                   const float* b1, const float* w2t,
                                   const float* b2, float* out, int b, int n,
                                   int c_in, int c_dec, int u1, int u2, int p,
                                   int max_voxels, int nx, float vx, float vy,
                                   float x_off, float y_off, int with_distance,
                                   int occupancy, void* stream) {
  if (c_in < 3 || c_in > kMaxCin || c_dec != c_in + 5 + (with_distance ? 1 : 0)
      || p < 1 || u1 < 1 || u1 > kU1 || u2 < 1 || u2 > kU2 || nx < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const bool full = u1 == kU1 && u2 == kU2;
  void (*kernel)(const int*, const float*, const int*, const float*,
                 const float*, const float*, const float*, float*, int, int,
                 int, int, int, int, int, int, Geometry, int, int) =
      full ? fused_pfn2_kernel<true> : fused_pfn2_kernel<false>;
  const size_t smem = smem2_bytes(c_in, p);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads2, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles =
      static_cast<long long>(b) * ((n + kRows2 - 1) / kRows2);
  const int grid = static_cast<int>(
      tiles < static_cast<long long>(per_sm) * sms
          ? tiles : static_cast<long long>(per_sm) * sms);
  const Geometry geo{nx, vx, vy, x_off, y_off};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (n + kCapRows - 1) / kCapRows;
  int* cap = scratch + static_cast<size_t>(b) * chunks;
  pillar_heads_kernel<<<dim3(chunks, b), kCapThreads, 0, st>>>(
      keys, scratch, n, chunks);
  pillar_cap_kernel<<<b, kCapThreads, 0, st>>>(keys, scratch, cap, n, chunks,
                                               max_voxels);
  kernel<<<grid, kThreads2, smem, st>>>(
      keys, pts, cap, w1t, b1, w2t, b2, out, b, n, c_in, c_dec, u1, u2, p,
      max_voxels, geo, with_distance, occupancy);
  return static_cast<int>(cudaGetLastError());
}
