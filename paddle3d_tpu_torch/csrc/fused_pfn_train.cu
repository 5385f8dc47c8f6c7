// Fused pillar feature net, train mode: the two kernels around K1 that give
// the one-layer PFN batch-statistics BatchNorm and its backward.
//
//   K3 p3d_pfn_stats replaces paddle3d_tpu/ops/pallas/fused_pfn_train.py
//      :_kernel_stats (entry _pfn_stats): the sums [sum z, sum z^2, count,
//      sum x (x) z, sum x] over the kept rows, with z = W1 x the pre-BN
//      activation of a kept row's decorated input x.
//   K4 p3d_pfn_bwd replaces fused_pfn_train.py:_kernel_bwd (entry
//      _pfn_bwd): recomputes z and t = a z + c, routes the cotangent of each
//      pillar's emission row to its FIRST argmax row per channel, gated by
//      relu' (t > 0), and sums [sum dt, sum dt zhat, sum x (x) dt],
//      zhat = (z - mu) invsig.
//
// The caller (paddle3d_tpu_torch/ops/fused_pfn_train.py) derives the batch
// mean and variance and the dW1 / dgamma / dbeta formula from the sums and
// runs K1 with the folded weights. The sums accumulate in f64 (each product
// of two f32 values is exact there): the formula cancels (var = s2/M -
// mu^2, t3 - sx mu^T over ~1e5 rows), and f32 sums taken in two orders gave
// dW1s 2.7e-2 of its largest entry apart on the card. No float atomics,
// and every sum runs in an order fixed by the shapes alone: two calls give
// the same bits.
//
// What bounds them on the H100 at KITTI (8 x 20,000 rows, 142,729 kept,
// u1 = 64, C_dec = 9, P = 32): neither bytes (~3 MB in; K4 also reads the
// cotangent's ~18 MB at the ~68,000 emission rows) nor f64 FMAs, but a
// block's latency: staging a span from device memory, the rank scans and
// the decoration with their barriers (about half of either kernel), then
// K3's f32 products of z (9 a kept row and channel, each rounded alone: the
// plain version's bits) and f64 sums, and K4's arg-max chain a pillar.
// Neither more channels a thread, 128-thread blocks, nor K3's sums on the
// f64 tensor cores (mma m8n8k4) made them faster on the card; K4's
// cotangents through a cp.async ring did.
//
// Design. A block owns a span of rows of one scan (about two blocks an SM
// over the batch, at most kMaxSpan rows) and stages the span's keys and
// points once, with the P-row halo behind it (csrc/pfn_common.cuh's
// convention; the staging, the cap and the rank pass live there, shared
// with the one-layer K1). It owns the pillars whose emission row (their last kept row)
// lies in the span: their kept rows lie at most P - 1 rows before it. Rows
// from the scan's sentinel tail on are skipped. The max_voxels cap it finds
// itself: a row's pillar ordinal is at most its index, so only a span
// reaching past max_voxels rows counts the pillar heads before it (16-byte
// loads of the keys) and, by a block scan of its own heads, the cap row
// inside it. It walks the span in kTile-row tiles, a thread a row: a
// max-scan of head rows gives each row its arrival rank (the shared keep
// and emission rules), one block scan gives each emission row its ordinal
// and its kept rows' place in a compacted list, the emission thread sums
// its pillar's mean, and each kept row is decorated once (the shared
// helpers: bit for bit as K1 and the plain version) into an f32 and an f64
// copy. Then groups of threads, a thread a channel (64 a group, or 32 for
// u1 <= 32), compute z in f32 registers in k order from W1's row held in
// registers. K3: a group takes every groups-th kept row and adds [z, z^2,
// x z, x] into f64 registers kept for the whole span. K4: a group takes a
// run of whole pillars (about 1 / groups of the tile's kept rows), runs
// relu' and the first arg-max over each pillar's rows in f32, and only on
// that row, where t > 0, adds [dt, dt zhat, x dt] in f64; each thread
// copies its channel of the cotangent at the next kRing emission rows
// into a ring in shared memory (cp.async, read through the strides), so no
// register waits on those loads. At the span's end the groups' sums meet
// in shared memory in group order, the block writes one f64 partial, and a
// second small launch adds the partials in block order. The TPU kernels'
// ones-dots, lane rolls and doubling scans have no counterpart.
//
// Layouts: keys [B, N] int32 sorted (sentinel 2^31-1); points
// channel-major [B, C_in, N]; w1t [u1, C_dec], u1 <= 64; a, c, mu, invsig
// [u1]. K4's cotangent g is that of K1's channel-major [B, C, N] rows, read
// through its strides (autograd hands it over as a transposed view of the
// scatter VJP's [B, N, C] rows; channels >= u1, the occupancy, are
// ignored). buf, f64: the sums [rows][u1] (K3 rows s1, s2, count,
// t3[C_dec], sx padded to u1; K4 rows sdt, sdtz, t1[C_dec]), then each
// block's partial of the same shape.
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

#include "pfn_common.cuh"

namespace {

using p3d::Geometry;
using p3d::kMaxCdec;
using p3d::kMaxCin;

constexpr int kThreads = p3d::kSpanThreads;
constexpr int kTile = p3d::kSpanTile;   // rows a tile: a thread a row
constexpr int kMaxU1 = 64;        // channels a group, a thread a channel
constexpr int kMaxSpan = p3d::kMaxSpan;
constexpr int kRing = 8;          // K4: cotangent copies in flight a thread
constexpr int kReduceWarps = 32;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared memory, byte offsets from a 16-byte aligned base. The f64 and f32
// copies of the decorated rows come first; after the last tile the groups'
// sums reuse them.
struct Layout {
  int x64, x32, pts, mean, cx, cy, key, kown, kcol, kstart, erow, scan, ring;
  int bytes;
};

__host__ __device__ inline Layout layout(int c_in, int x32w, int x64w, int p,
                                         int span, int red_rows, bool bwd) {
  const int kmax = kTile + p - 1;   // kept rows of a tile's pillars
  const int pw = span + p - 1;
  Layout l{};
  int o = 0;
  l.x64 = o;
  l.x32 = o + kmax * x64w * 8;
  const int rows_bytes = kmax * (x64w * 8 + x32w * 4);
  const int red_bytes = red_rows * kThreads * 8;
  o += round_up(rows_bytes > red_bytes ? rows_bytes : red_bytes, 16);
  l.pts = o;    o += round_up(c_in * pw * 4, 16);
  l.mean = o;   o += kTile * 3 * 4;
  l.cx = o;     o += kTile * 4;
  l.cy = o;     o += kTile * 4;
  l.key = o;    o += round_up((span + p + 1) * 4, 16);
  l.kown = o;   o += round_up(kmax * 4, 16);
  l.kcol = o;   o += round_up(kmax * 4, 16);
  l.kstart = o; o += round_up((kTile + 1) * 4, 16);
  l.erow = o;   o += kTile * 4;
  l.scan = o;   o += round_up(p3d::kScanInts * 4, 16);
  l.ring = o;   o += bwd ? kRing * kThreads * 4 : 0;  // K4's cotangents
  l.bytes = o;
  return l;
}

// 4-byte asynchronous copy into shared memory: no register waits on it
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

struct Args {
  const int* keys;
  const float* pts;
  const float* w1t;
  const float* a;       // K4: the BN fold and statistics
  const float* cc;
  const float* mu;
  const float* invsig;
  const float* g;       // K4: the rows cotangent, through its strides
  long long gsb, gsc, gsn;
  double* part;         // [blocks][rows][u1]
  int n, c_in, c_dec, u1, p, max_voxels, span;
  Geometry geo;
  int with_distance;
};

// kCin: the point channels with kDist the distance channel (KITTI's 4
// and none: every config), or 0 for any C_in (guarded). kBwd: K4, else K3.
template <int kCin, bool kDist, bool kBwd>
__global__ void __launch_bounds__(kThreads, 2)
    pfn_train_kernel(const Args A) {
  constexpr int kN = kCin ? kCin + 5 + kDist : kMaxCdec;
  constexpr int kX32 = (kN + 3) & ~3;   // f32 row: float4 loads
  constexpr int kX64 = (kN + 1) & ~1;   // f64 row: double2 loads
  const int c_dec = kCin ? kN : A.c_dec;
  const int c_in = kCin ? kCin : A.c_in;
  const bool with_distance = kCin ? kDist : A.with_distance != 0;
  const int rows = (kBwd ? 2 : 4) + c_dec;
  const int p = A.p, n = A.n, u1 = A.u1;
  const int max_voxels = A.max_voxels;

  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  const Layout L = layout(c_in, kX32, kX64, p, A.span, rows, kBwd);
  double* s_x64 = reinterpret_cast<double*>(base + L.x64);
  float* s_x32 = reinterpret_cast<float*>(base + L.x32);
  double* s_red = s_x64;                 // after the last tile
  float* s_pts = reinterpret_cast<float*>(base + L.pts);
  float* s_mean = reinterpret_cast<float*>(base + L.mean);
  float* s_cx = reinterpret_cast<float*>(base + L.cx);
  float* s_cy = reinterpret_cast<float*>(base + L.cy);
  int* s_key = reinterpret_cast<int*>(base + L.key);
  int* s_kown = reinterpret_cast<int*>(base + L.kown);
  int* s_kcol = reinterpret_cast<int*>(base + L.kcol);
  int* s_kstart = reinterpret_cast<int*>(base + L.kstart);
  int* s_erow = reinterpret_cast<int*>(base + L.erow);
  int* s_scan = reinterpret_cast<int*>(base + L.scan);  // p3d::kScanInts
  float* s_ring = reinterpret_cast<float*>(base + L.ring);

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * A.span;
  const int s_len = max(0, min(A.span, n - s0));
  const int pw = A.span + p - 1;  // points of rows [s0 - p + 1, s0 + span)
  const int* kb = A.keys + static_cast<size_t>(b) * n;
  const float* pb = A.pts + static_cast<size_t>(b) * c_in * n;
  const int gs = u1 <= 32 ? 32 : kMaxU1;   // a group: a thread a channel
  const int groups = kThreads / gs;
  const int c = tid % gs;
  const int grp = tid / gs;
  const bool live = c < u1;

  // the span's keys (rows [s0 - p, s0 + s_len]) and points
  p3d::stage_span(kb, pb, n, c_in, p, s0, s_len, pw, s_key, s_pts);

  // per thread: W1's row of channel c, and for K4 its BN fold
  float w[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    w[k] = (live && k < c_dec) ? A.w1t[c * c_dec + k] : 0.f;
  }
  float ac = 0.f, ccc = 0.f, muc = 0.f, isc = 0.f;
  if (kBwd && live) {
    ac = A.a[c];
    ccc = A.cc[c];
    muc = A.mu[c];
    isc = A.invsig[c];
  }
  __syncthreads();

  // the rows before the sentinel tail, and the max_voxels cap
  const int2 vc = p3d::span_valid_cap(kb, s_key, s0, s_len, p, max_voxels,
                                      s_scan);
  const int s_valid = vc.x;
  const int cap = vc.y;

  // f64 sums for the whole span. K3: s1, s2, t3[k], sx[c]; K4: sdt, sdtz,
  // t1[k]
  double acc0 = 0.0, acc1 = 0.0, accx = 0.0;
  double acc[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) acc[k] = 0.0;
  int kept_total = 0;
  const float* gb = kBwd ? A.g + b * A.gsb : nullptr;

  for (int t0 = 0; t0 < s_valid; t0 += kTile) {
    // rank pass, a thread a row: the tile's pillar lists
    const int2 lists = p3d::rank_tile(
        t0, s_valid, cap, s0, p, pw, A.geo, s_key, s_pts, s_scan,
        p3d::TileLists{s_kstart, s_kown, s_kcol, s_mean, s_cx, s_cy, s_erow,
                       nullptr});
    const int n_emit = lists.x;
    const int n_kept = lists.y;
    kept_total += n_kept;

    // K4: a group takes a run of whole pillars holding about 1 / groups of
    // the tile's kept rows; each thread starts copying its channel of the
    // first kRing pillars' cotangents into its ring while the rows are
    // decorated (a copy a pillar, each committed as one group)
    int e_lo = 0, e_hi = 0;
    auto fetch = [&](int e, int slot) {
      if (live && e < e_hi) {
        cp_async4(s_ring + slot * kThreads + tid,
                  gb + c * A.gsc + static_cast<long long>(s_erow[e]) * A.gsn);
      }
      cp_async_commit();
    };
    if (kBwd) {
      auto first_at = [&](int row) {  // first pillar from kept row `row`
        int lo = 0, hi = n_emit;
        while (lo < hi) {
          const int mid = (lo + hi) / 2;
          if (s_kstart[mid] < row) lo = mid + 1; else hi = mid;
        }
        return lo;
      };
      e_lo = first_at(grp * n_kept / groups);
      e_hi = first_at((grp + 1) * n_kept / groups);
#pragma unroll
      for (int i = 0; i < kRing; ++i) fetch(e_lo + i, i);
    }

    // each kept row decorated once, in f32 and f64
    for (int q = tid; q < n_kept; q += kThreads) {
      const int e = s_kown[q];
      float x[kMaxCdec];
      p3d::decorate(s_pts, pw, s_kcol[q], c_in, s_mean + 3 * e, s_cx[e],
                    s_cy[e], with_distance, x);
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        if (k < c_dec) {
          s_x32[q * kX32 + k] = x[k];
          s_x64[q * kX64 + k] = x[k];
        }
      }
    }
    __syncthreads();

    if (!kBwd) {
      // K3: a group every groups-th kept row
#pragma unroll 2
      for (int q = grp; q < n_kept; q += groups) {
        float x[kX32];
        const float4* xr = reinterpret_cast<const float4*>(s_x32 + q * kX32);
#pragma unroll
        for (int v = 0; v < kX32 / 4; ++v) {
          const float4 f = xr[v];
          x[4 * v] = f.x;
          x[4 * v + 1] = f.y;
          x[4 * v + 2] = f.z;
          x[4 * v + 3] = f.w;
        }
        // z in k order, each product rounded alone (the plain version's
        // order: bit for bit)
        float z = __fmul_rn(x[0], w[0]);
#pragma unroll
        for (int k = 1; k < kN; ++k) {
          if (k < c_dec) z = __fadd_rn(z, __fmul_rn(x[k], w[k]));
        }
        const double zd = z;
        acc0 += zd;
        acc1 = fma(zd, zd, acc1);
        const double2* xd =
            reinterpret_cast<const double2*>(s_x64 + q * kX64);
#pragma unroll
        for (int v = 0; v < kX64 / 2; ++v) {
          const double2 d = xd[v];
          if (2 * v < c_dec) acc[2 * v] = fma(d.x, zd, acc[2 * v]);
          if (2 * v + 1 < c_dec) {
            acc[2 * v + 1] = fma(d.y, zd, acc[2 * v + 1]);
          }
        }
        if (c < c_dec) accx += s_x64[q * kX64 + c];
      }
    } else {
      // K4: the group's rows in order; a pillar's relu' and first arg-max
      // in f32 registers over its rows, and at its last row, where t > 0,
      // its f64 sums with the cotangent from the thread's ring
      int e = e_lo;
      int q_last = e < e_hi ? s_kstart[e + 1] - 1 : -1;
      float best = -INFINITY, tbest = 0.f, zbest = 0.f;
      int qbest = 0;
      const int q_hi = e_lo < e_hi ? s_kstart[e_hi] : 0;
#pragma unroll 2
      for (int q = e_lo < e_hi ? s_kstart[e_lo] : 0; q < q_hi; ++q) {
        float x[kX32];
        const float4* xr = reinterpret_cast<const float4*>(s_x32 + q * kX32);
#pragma unroll
        for (int v = 0; v < kX32 / 4; ++v) {
          const float4 f = xr[v];
          x[4 * v] = f.x;
          x[4 * v + 1] = f.y;
          x[4 * v + 2] = f.z;
          x[4 * v + 3] = f.w;
        }
        float z = __fmul_rn(x[0], w[0]);
#pragma unroll
        for (int k = 1; k < kN; ++k) {
          if (k < c_dec) z = __fadd_rn(z, __fmul_rn(x[k], w[k]));
        }
        const float t = __fadd_rn(__fmul_rn(z, ac), ccc);
        const float y = fmaxf(t, 0.f);
        if (y > best) {  // strictly: the first maximum wins
          best = y;
          tbest = t;
          zbest = z;
          qbest = q;
        }
        if (q == q_last) {  // uniform over the group
          // this pillar's copy is the oldest of the kRing in flight
          cp_async_wait<kRing - 1>();
          const int slot = (e - e_lo) % kRing;
          const float dtf = s_ring[slot * kThreads + tid];
          fetch(e + kRing, slot);
          if (tbest > 0.f) {  // relu'(0) = 0
            const double dt = dtf;
            const double zhat = __fmul_rn(__fsub_rn(zbest, muc), isc);
            acc0 += dt;
            acc1 = fma(dt, zhat, acc1);
            const double2* xd =
                reinterpret_cast<const double2*>(s_x64 + qbest * kX64);
#pragma unroll
            for (int v = 0; v < kX64 / 2; ++v) {
              const double2 d = xd[v];
              if (2 * v < c_dec) acc[2 * v] = fma(d.x, dt, acc[2 * v]);
              if (2 * v + 1 < c_dec) {
                acc[2 * v + 1] = fma(d.y, dt, acc[2 * v + 1]);
              }
            }
          }
          ++e;
          q_last = e < e_hi ? s_kstart[e + 1] - 1 : -1;
          best = -INFINITY;
          tbest = zbest = 0.f;
        }
      }
    }
    if (kBwd) cp_async_wait<0>();
    __syncthreads();  // the next tile rewrites the lists and rows
  }

  // the groups' sums in group order -> the block's partial [rows][u1]
  const int nrow_acc = kBwd ? 2 : 3;  // rows before the x sums
  auto put = [&](int row, double v) {
    s_red[(row * groups + grp) * gs + c] = v;
  };
  put(0, acc0);
  put(1, acc1);
  if (!kBwd) put(2, tid == 0 ? static_cast<double>(kept_total) : 0.0);
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    if (k < c_dec) put(nrow_acc + k, acc[k]);
  }
  if (!kBwd) put(3 + c_dec, c < c_dec ? accx : 0.0);
  __syncthreads();
  double* out = A.part + static_cast<size_t>(blockIdx.y * gridDim.x +
                                             blockIdx.x) * rows * u1;
  for (int s = tid; s < rows * u1; s += kThreads) {
    const int row = s / u1;
    const int ch = s - row * u1;
    double v = 0.0;
    for (int gi = 0; gi < groups; ++gi) {
      v += s_red[(row * groups + gi) * gs + ch];
    }
    out[s] = v;
  }
}

// out[s] = the sum over blocks j of part[j][s], in block order by warps
// (warp w takes blocks w, w + kReduceWarps, ...), then the warps in order.
__global__ void __launch_bounds__(kReduceWarps * 32)
    reduce_partials_kernel(const double* __restrict__ part,
                           double* __restrict__ out, int slots, int blocks) {
  __shared__ double s_sum[kReduceWarps][33];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = blockIdx.x * 32 + lane;
  double v = 0.0;
  if (s < slots) {
#pragma unroll 4
    for (int j = warp; j < blocks; j += kReduceWarps) {
      v += part[static_cast<size_t>(j) * slots + s];
    }
  }
  s_sum[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && s < slots) {
    double t = s_sum[0][lane];
    for (int w = 1; w < kReduceWarps; ++w) t += s_sum[w][lane];
    out[s] = t;
  }
}

bool bad_shape(int c_in, int c_dec, int u1, int p, int nx, int spans,
               int with_distance) {
  return c_in < 3 || c_in > kMaxCin ||
         c_dec != c_in + 5 + (with_distance ? 1 : 0) || p < 1 ||
         u1 < c_dec || u1 > kMaxU1 || nx < 1 || spans < 1;
}

// The kernel over spans x b blocks, then the partials' sum into buf[0 ..
// rows * u1). Rows of a span: n / spans rounded up to 32 (at most
// kMaxSpan).
template <bool kBwd>
cudaError_t launch(Args a, int b, int spans, double* buf,
                   cudaStream_t st) {
  const int rows = (kBwd ? 2 : 4) + a.c_dec;
  const int slots = rows * a.u1;
  a.part = buf + slots;
  int blocks = 0;
  if (b > 0 && a.n > 0) {
    a.span = round_up((a.n + spans - 1) / spans, 32);
    if (a.span > kMaxSpan) return cudaErrorInvalidValue;
    const bool four = a.c_in == 4 && !a.with_distance;  // every config
    void (*kernel)(const Args) = four ? pfn_train_kernel<4, false, kBwd>
                                      : pfn_train_kernel<0, false, kBwd>;
    const int w = four ? 9 : kMaxCdec;
    const Layout l = layout(a.c_in, (w + 3) & ~3, (w + 1) & ~1, a.p, a.span,
                            rows, kBwd);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.bytes);
    if (err != cudaSuccess) return err;
    const int used = (a.n + a.span - 1) / a.span;
    kernel<<<dim3(used, b), kThreads, l.bytes, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    blocks = used * b;
  }
  reduce_partials_kernel<<<(slots + 31) / 32, kReduceWarps * 32, 0, st>>>(
      a.part, buf, slots, blocks);
  return cudaGetLastError();
}

}  // namespace

// K3. buf: f64, (spans * b + 1) * (4 + c_dec) * u1 (the sums, then the
// blocks' partials; see the header). Returns cudaGetLastError().
extern "C" int p3d_pfn_stats(const int* keys, const float* pts,
                             const float* w1t, double* buf, int spans, int b,
                             int n, int c_in, int c_dec, int u1, int p,
                             int max_voxels, int nx, float vx, float vy,
                             float x_off, float y_off, int with_distance,
                             void* stream) {
  if (bad_shape(c_in, c_dec, u1, p, nx, spans, with_distance)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{};
  a.keys = keys;
  a.pts = pts;
  a.w1t = w1t;
  a.n = n;
  a.c_in = c_in;
  a.c_dec = c_dec;
  a.u1 = u1;
  a.p = p;
  a.max_voxels = max_voxels;
  a.geo = Geometry{nx, vx, vy, x_off, y_off};
  a.with_distance = with_distance;
  return static_cast<int>(
      launch<false>(a, b, spans, buf, static_cast<cudaStream_t>(stream)));
}

// K4. g: the rows cotangent, element (b, c, i) at g[b*gsb + c*gsc + i*gsn]
// for c < u1. buf: f64, (spans * b + 1) * (2 + c_dec) * u1. Returns
// cudaGetLastError().
extern "C" int p3d_pfn_bwd(const int* keys, const float* pts,
                           const float* w1t, const float* a, const float* cc,
                           const float* mu, const float* invsig,
                           const float* g, long long gsb, long long gsc,
                           long long gsn, double* buf, int spans, int b,
                           int n, int c_in, int c_dec, int u1, int p,
                           int max_voxels, int nx, float vx, float vy,
                           float x_off, float y_off, int with_distance,
                           void* stream) {
  if (bad_shape(c_in, c_dec, u1, p, nx, spans, with_distance)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args args{};
  args.keys = keys;
  args.pts = pts;
  args.w1t = w1t;
  args.a = a;
  args.cc = cc;
  args.mu = mu;
  args.invsig = invsig;
  args.g = g;
  args.gsb = gsb;
  args.gsc = gsc;
  args.gsn = gsn;
  args.n = n;
  args.c_in = c_in;
  args.c_dec = c_dec;
  args.u1 = u1;
  args.p = p;
  args.max_voxels = max_voxels;
  args.geo = Geometry{nx, vx, vy, x_off, y_off};
  args.with_distance = with_distance;
  return static_cast<int>(
      launch<true>(args, b, spans, buf, static_cast<cudaStream_t>(stream)));
}
