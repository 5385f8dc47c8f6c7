// Segmented window max with arg-max offsets (K12), and its backward.
//
//   out[b, j, c] = max over rows i in [j - win, j + win] ∩ [0, n) with
//                  keys[b, i] == keys[b, j] of vals[b, i, c]
//   off[b, j, c] = i - j of the row that gave it (int8, |off| <= win)
//   gin[b, j, c] = sum over |s| <= win of [off[b, j+s, c] == -s] g[b, j+s, c]
//
// with win = 2^steps - 1. Replaces the TPU kernels
// paddle3d_tpu/ops/pallas/seg_window.py:_fwd_kernel (entry _fwd) and
// _bwd_kernel (entry _vjp_bwd). Those see each row block beside a halo
// array the host builds with pad + reshape passes (_halo); nothing of that
// is carried over: a block stages its own halo.
//
// The offsets are index-valued: a different winner on a tie is a different
// gradient. So the forward runs the Pallas kernel's doubling in its merge
// order, step by step over one snapshot: for d = 1, 2, ..., 2^(steps-1),
// the row d below wins on strictly greater, then the row d above on
// strictly greater than the updated best (ops/seg_window.py's plain version
// does the same on whole arrays). The backward adds, for each row, its own
// cotangent where its offset is 0, then for s = 1..win the cotangent of row
// j+s where that row's offset is -s and of row j-s where it is +s, in that
// order, each addition rounded on its own (__fadd_rn): the plain version's
// order, so both are bit-equal to it. Rows outside [0, n) carry key -3
// (callers' keys are >= -2).
//
// What bounds them on the H100. Bytes at the limit: each element is read
// once (4 bytes) and written once with its offset (4 + 1), or read with its
// offset and written once in the backward. A first version ran at ~7x that,
// held by shared-memory instructions: its backward probed all 2 win
// neighbours of every element (an offset and a cotangent load each), its
// forward ran every doubling step over every staged row, and both staged
// 4 bytes a load. Yet only a row's own segment matters, and on a LiDAR
// scan's pillar keys segments are short (row-weighted mean ~5 rows, a
// quarter of the rows alone): ~4 of the 62 probes fall in the segment and
// ~35 % of the (row, step) pairs have a candidate. What bounds the kernels
// now is that floor plus the live steps' (forward) and the probes'
// (backward) shared-memory traffic, which the other blocks of an SM
// overlap with their loads and stores only in part.
//
// What the design does:
//   - Segment reach. A block loads its keys first and finds, by a binary
//     search over the sorted keys in shared memory, one thread a row, how
//     far each row's segment reaches down and up (capped at win). Only the
//     segments of the tile's first and last rows reach into the halo, so
//     only their halo rows are staged.
//   - Forward: work only on live rows. At step d a row whose segment
//     reaches neither d rows down nor d rows up has no candidate: it is
//     final, and no row reads it again (every row of its segment lies
//     closer than d). It skips the step and is written out from the buffer
//     its last live step wrote: it is never copied forward. Eight threads
//     own a row, four channels each (16-byte shared loads), so the branch
//     is uniform across a row's threads.
//   - Backward: probe only the row's own segment. A row's arg-max offset
//     points into its own segment (a candidate is taken only on an equal
//     key, and keys are sorted), so a probe outside the segment adds a
//     literal +0 in the plain version. Skipping it changes no bit but the
//     sign of a zero sum: a sum is -0 only when every term is -0, and
//     x + (+0) == x for every x but -0. So the kernel starts from the plain
//     version's own start value, adds the in-segment terms in the plain
//     order, then +0 once where any of the 2 win positions was skipped: the
//     same bits as the plain version. The few neighbour rows come from the
//     block's shared stage (read through L1 instead, they took longer).
//   - Staging by 16-byte cp.async (4 bytes for the backward's offsets): the
//     tile's rows start loading before the keys arrive, and the other blocks
//     of an SM step while a block loads.
//
// Layout: a block owns a tile of rows of one batch row and kCh = 32
// channels (one 128-byte slab a row), plus the halo rows its edge segments
// reach (at most win each side). Tiles of 256 rows (512 threads) forward and
// 128 rows (256 threads) backward: 128 rows and 256 / 1024 threads forward,
// 512 rows and 128 / 512 threads backward took longer; 256 rows backward
// took as long.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kCh = 32;                 // channels per block
constexpr int kFwdRows = 256;           // tile rows per forward block
constexpr int kBwdRows = 128;           // tile rows per backward block
constexpr int kFwdThreads = 512;
constexpr int kBwdThreads = 256;
constexpr int kInvalid = -3;            // key of rows outside the array

__host__ __device__ inline size_t fwd_smem(int win) {
  const size_t len = kFwdRows + 2 * win;
  // two buffers of values and offsets, keys, the packed reach of each row
  return 2 * len * kCh * (sizeof(float) + 1) + 2 * len * sizeof(int);
}

__host__ __device__ inline size_t bwd_smem(int win) {
  const size_t len = kBwdRows + 2 * win;
  // cotangents and offsets, keys, the reach of each row
  return len * kCh * (sizeof(float) + 1) + 2 * len * sizeof(int);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src) : "memory");
}

// first row of [lo, e] whose key is s_key[e]: the rows below e hold keys
// <= s_key[e] (sorted; -3 below the array), so equality is monotone
__device__ __forceinline__ int first_same(const int* s_key, int e, int lo) {
  const int key = s_key[e];
  int hi = e;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_key[mid] == key) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// last row of [e, hi] whose key is s_key[e] (above: keys >= s_key[e], then
// -3 past the array)
__device__ __forceinline__ int last_same(const int* s_key, int e, int hi) {
  const int key = s_key[e];
  int lo = e;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s_key[mid] == key) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// The staged rows of a tile, [lo, hi] in staging coordinates (row
// t0 - win + e at e): only the segments of the tile's first and last rows
// reach into the halo.
struct Span {
  int lo, hi;
};

// dn | up << 8: the rows of row e's segment below and above it within the
// span, at most win each way
__device__ __forceinline__ int reach_of(const int* s_key, int e, Span sp,
                                        int win) {
  const int dn = e - first_same(s_key, e, max(sp.lo, e - win));
  const int up = last_same(s_key, e, min(sp.hi, e + win)) - e;
  return dn | (up << 8);
}

// Loads the keys of staging rows [0, len) into s_key (kInvalid outside the
// array) and returns the span of a tile whose rows end at tile_end; ends
// with the keys visible to the block.
template <int kRows, int kThreads>
__device__ Span load_keys(const int* keys, int* s_key, int b, int n, int t0,
                          int win, int tile_end) {
  const int len = kRows + 2 * win;
  for (int e = threadIdx.x; e < len; e += kThreads) {
    const int r = t0 - win + e;
    s_key[e] = (r >= 0 && r < n) ? keys[static_cast<size_t>(b) * n + r]
                                 : kInvalid;
  }
  __syncthreads();
  return {first_same(s_key, win, 0), last_same(s_key, tile_end - 1, len - 1)};
}

// Copies rows [e0, e1) of the slab's channels [ch0, ch0 + kCh) of `src`
// into dst ([len][kCh] of T); staging row e is row row0 + e of src, whose
// rows lie ld elements apart and hold c channels. By kChunk-byte cp.async
// where vec, else by plain loads with `fill` past c.
template <typename T, int kChunk, int kThreads>
__device__ __forceinline__ void stage(const T* src, T* dst, int e0, int e1,
                                      long long row0, int ld, int c, int ch0,
                                      bool vec, T fill) {
  constexpr int kPer = kChunk / sizeof(T);      // elements a chunk
  constexpr int kChunks = kCh / kPer;           // chunks a row
  if (vec) {
    for (int i = threadIdx.x; i < (e1 - e0) * kChunks; i += kThreads) {
      const int e = e0 + i / kChunks;
      const int q = (i % kChunks) * kPer;
      if (ch0 + q < c) {
        const T* at = src + (row0 + e) * ld + ch0 + q;
        if (kChunk == 16) {
          cp_async16(dst + e * kCh + q, at);
        } else {
          cp_async4(dst + e * kCh + q, at);
        }
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < (e1 - e0) * kCh; i += kThreads) {
    const int e = e0 + i / kCh;
    const int l = i % kCh;
    dst[e * kCh + l] = ch0 + l < c ? src[(row0 + e) * ld + ch0 + l] : fill;
  }
}

__device__ __forceinline__ void take(float& best, signed char& o, float cand,
                                     int cand_off) {
  if (cand > best) {
    best = cand;
    o = static_cast<signed char>(cand_off);
  }
}

__global__ void __launch_bounds__(kFwdThreads)
seg_window_fwd_kernel(const float* __restrict__ vals,
                      const int* __restrict__ keys, float* __restrict__ out,
                      signed char* __restrict__ off, int n, int c, int steps,
                      int win, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int len = kFwdRows + 2 * win;
  float* s_val = reinterpret_cast<float*>(smem);          // [2][len][kCh]
  signed char* s_off = reinterpret_cast<signed char*>(s_val + 2 * len * kCh);
  int* s_key = reinterpret_cast<int*>(s_off + 2 * len * kCh);
  int* s_info = s_key + len;    // dn reach | up reach << 8 | live steps << 16

  const int b = blockIdx.z;
  const int t0 = blockIdx.x * kFwdRows;
  const int ch0 = blockIdx.y * kCh;
  const float neg = -__int_as_float(0x7f800000);

  // the tile's rows load while the keys arrive and the reaches are found
  const int tile_end = win + min(kFwdRows, n - t0);
  const long long row0 = static_cast<long long>(b) * n + t0 - win;
  stage<float, 16, kFwdThreads>(vals, s_val, win, tile_end, row0, c, c, ch0,
                                vec, neg);
  const Span sp = load_keys<kFwdRows, kFwdThreads>(keys, s_key, b, n, t0,
                                                   win, tile_end);
  stage<float, 16, kFwdThreads>(vals, s_val, sp.lo, win, row0, c, c, ch0, vec,
                                neg);
  stage<float, 16, kFwdThreads>(vals, s_val, tile_end, sp.hi + 1, row0, c, c,
                                ch0, vec, neg);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int e = sp.lo + threadIdx.x; e <= sp.hi; e += kFwdThreads) {
    const int r = reach_of(s_key, e, sp, win);
    const int reach = max(r & 0xff, r >> 8);
    // the steps d = 1, 2, 4, ... <= reach, where the row has a candidate
    const int live = reach == 0 ? 0 : min(steps, 32 - __clz(reach));
    s_info[e] = r | (live << 16);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // eight threads a row, four channels each
  const int q = (threadIdx.x & 7) * 4;
  const int slot = threadIdx.x >> 3;
  constexpr int kStride = kFwdThreads / 8;
  const char4 zero = make_char4(0, 0, 0, 0);
  for (int s = 0; s < steps; ++s) {
    const int d = 1 << s;
    const float* a_val = s_val + (s & 1) * len * kCh;
    const signed char* a_off = s_off + (s & 1) * len * kCh;
    float* b_val = s_val + ((s & 1) ^ 1) * len * kCh;
    signed char* b_off = s_off + ((s & 1) ^ 1) * len * kCh;
    for (int e = sp.lo + slot; e <= sp.hi; e += kStride) {
      const int info = s_info[e];
      const bool has_dn = (info & 0xff) >= d;
      const bool has_up = ((info >> 8) & 0xff) >= d;
      if (!has_dn && !has_up) continue;     // final: no candidate from here
      float4 best = *reinterpret_cast<const float4*>(a_val + e * kCh + q);
      char4 o = s == 0 ? zero
                       : *reinterpret_cast<const char4*>(a_off + e * kCh + q);
      if (has_dn) {
        const int at = (e - d) * kCh + q;
        const float4 cv = *reinterpret_cast<const float4*>(a_val + at);
        const char4 co =
            s == 0 ? zero : *reinterpret_cast<const char4*>(a_off + at);
        take(best.x, o.x, cv.x, co.x - d);
        take(best.y, o.y, cv.y, co.y - d);
        take(best.z, o.z, cv.z, co.z - d);
        take(best.w, o.w, cv.w, co.w - d);
      }
      if (has_up) {
        const int at = (e + d) * kCh + q;
        const float4 cv = *reinterpret_cast<const float4*>(a_val + at);
        const char4 co =
            s == 0 ? zero : *reinterpret_cast<const char4*>(a_off + at);
        take(best.x, o.x, cv.x, co.x + d);
        take(best.y, o.y, cv.y, co.y + d);
        take(best.z, o.z, cv.z, co.z + d);
        take(best.w, o.w, cv.w, co.w + d);
      }
      *reinterpret_cast<float4*>(b_val + e * kCh + q) = best;
      *reinterpret_cast<char4*>(b_off + e * kCh + q) = o;
    }
    __syncthreads();
  }

  const int ch = ch0 + q;
  if (ch >= c) return;
  for (int e = win + slot; e < tile_end; e += kStride) {
    const int live = s_info[e] >> 16;
    const int at = (live & 1) * len * kCh + e * kCh + q;
    const float4 v = *reinterpret_cast<const float4*>(s_val + at);
    const char4 o =
        live == 0 ? zero : *reinterpret_cast<const char4*>(s_off + at);
    const long long g = (row0 + e) * c + ch;
    if (vec) {
      *reinterpret_cast<float4*>(out + g) = v;
      *reinterpret_cast<char4*>(off + g) = o;
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
      const signed char os[4] = {o.x, o.y, o.z, o.w};
      for (int k = 0; k < 4 && ch + k < c; ++k) {
        out[g + k] = vs[k];
        off[g + k] = os[k];
      }
    }
  }
}

__device__ __forceinline__ void route(float& acc, float g, int o, int want) {
  acc = __fadd_rn(acc, o == want ? g : 0.f);
}

__global__ void __launch_bounds__(kBwdThreads)
seg_window_bwd_kernel(const signed char* __restrict__ off,
                      const float* __restrict__ g,
                      const int* __restrict__ keys, float* __restrict__ gin,
                      int n, int c, int ldg, int win, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int len = kBwdRows + 2 * win;
  float* s_g = reinterpret_cast<float*>(smem);                  // [len][kCh]
  signed char* s_off = reinterpret_cast<signed char*>(s_g + len * kCh);
  int* s_key = reinterpret_cast<int*>(s_off + len * kCh);
  int* s_info = s_key + len;        // the tile rows' reach: dn | up << 8

  const int b = blockIdx.z;
  const int t0 = blockIdx.x * kBwdRows;
  const int ch0 = blockIdx.y * kCh;

  const int tile_end = win + min(kBwdRows, n - t0);
  const long long row0 = static_cast<long long>(b) * n + t0 - win;
  const signed char zero = 0;
  stage<float, 16, kBwdThreads>(g, s_g, win, tile_end, row0, ldg, c, ch0, vec,
                                0.f);
  stage<signed char, 4, kBwdThreads>(off, s_off, win, tile_end, row0, c, c,
                                     ch0, vec, zero);
  const Span sp = load_keys<kBwdRows, kBwdThreads>(keys, s_key, b, n, t0,
                                                   win, tile_end);
  stage<float, 16, kBwdThreads>(g, s_g, sp.lo, win, row0, ldg, c, ch0, vec,
                                0.f);
  stage<float, 16, kBwdThreads>(g, s_g, tile_end, sp.hi + 1, row0, ldg, c, ch0,
                                vec, 0.f);
  stage<signed char, 4, kBwdThreads>(off, s_off, sp.lo, win, row0, c, c, ch0,
                                     vec, zero);
  stage<signed char, 4, kBwdThreads>(off, s_off, tile_end, sp.hi + 1, row0, c,
                                     c, ch0, vec, zero);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int e = win + threadIdx.x; e < tile_end; e += kBwdThreads) {
    s_info[e] = reach_of(s_key, e, sp, win);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // eight threads a row, four channels each
  const int q = (threadIdx.x & 7) * 4;
  const int ch = ch0 + q;
  if (ch >= c) return;
  for (int e = win + (threadIdx.x >> 3); e < tile_end;
       e += kBwdThreads / 8) {
    const int info = s_info[e];
    const int sd = info & 0xff;
    const int su = info >> 8;
    const float4 gv = *reinterpret_cast<const float4*>(s_g + e * kCh + q);
    const char4 ov = *reinterpret_cast<const char4*>(s_off + e * kCh + q);
    float a0 = ov.x == 0 ? gv.x : 0.f;
    float a1 = ov.y == 0 ? gv.y : 0.f;
    float a2 = ov.z == 0 ? gv.z : 0.f;
    float a3 = ov.w == 0 ? gv.w : 0.f;
    for (int s = 1; s <= max(su, sd); ++s) {
      if (s <= su) {
        const float4 gu =
            *reinterpret_cast<const float4*>(s_g + (e + s) * kCh + q);
        const char4 ou =
            *reinterpret_cast<const char4*>(s_off + (e + s) * kCh + q);
        route(a0, gu.x, ou.x, -s);
        route(a1, gu.y, ou.y, -s);
        route(a2, gu.z, ou.z, -s);
        route(a3, gu.w, ou.w, -s);
      }
      if (s <= sd) {
        const float4 gd =
            *reinterpret_cast<const float4*>(s_g + (e - s) * kCh + q);
        const char4 od =
            *reinterpret_cast<const char4*>(s_off + (e - s) * kCh + q);
        route(a0, gd.x, od.x, s);
        route(a1, gd.y, od.y, s);
        route(a2, gd.z, od.z, s);
        route(a3, gd.w, od.w, s);
      }
    }
    if (su + sd < 2 * win) {   // a skipped probe: the plain version's +0
      a0 = __fadd_rn(a0, 0.f);
      a1 = __fadd_rn(a1, 0.f);
      a2 = __fadd_rn(a2, 0.f);
      a3 = __fadd_rn(a3, 0.f);
    }
    float* dst = gin + (row0 + e) * c + ch;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(a0, a1, a2, a3);
    } else {
      const float a[4] = {a0, a1, a2, a3};
      for (int k = 0; k < 4 && ch + k < c; ++k) dst[k] = a[k];
    }
  }
}

dim3 grid_for(int rows, int b, int n, int c) {
  return dim3((n + rows - 1) / rows, (c + kCh - 1) / kCh, b);
}

bool aligned(const void* p, size_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

}  // namespace

// vals [b, n, c] f32 and keys [b, n] int32 (sorted per batch row, >= -2),
// contiguous; out [b, n, c] f32 and off [b, n, c] int8, every element
// written. steps = ceil(log2 max_len), at most 7 (int8 offsets). Returns
// cudaGetLastError().
extern "C" int p3d_seg_window_max(const float* vals, const int* keys,
                                  float* out, signed char* off, int b, int n,
                                  int c, int steps, void* stream) {
  if (steps < 0 || steps > 7 || n < 0 || c < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0 || c == 0) return static_cast<int>(cudaSuccess);
  if (b > 65535 || (c + kCh - 1) / kCh > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int win = (1 << steps) - 1;
  const size_t smem = fwd_smem(win);
  cudaError_t err = cudaFuncSetAttribute(
      seg_window_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = c % 4 == 0 && aligned(vals, 16) && aligned(out, 16) &&
                   aligned(off, 4);
  seg_window_fwd_kernel<<<grid_for(kFwdRows, b, n, c), kFwdThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      vals, keys, out, off, n, c, steps, win, vec);
  return static_cast<int>(cudaGetLastError());
}

// off [b, n, c] int8 from p3d_seg_window_max on the same keys and keys
// [b, n] int32, contiguous; g [b, n, c] f32 with its rows ldg >= c elements
// apart (channels contiguous, batch rows n * ldg apart); gin [b, n, c] f32,
// contiguous, every element written. win = 2^steps - 1 of the forward, at
// most 127. Returns cudaGetLastError().
extern "C" int p3d_seg_window_max_bwd(const signed char* off, const float* g,
                                      const int* keys, float* gin, int b,
                                      int n, int c, int ldg, int win,
                                      void* stream) {
  if (win < 0 || win > 127 || n < 0 || c < 0 || ldg < c) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0 || c == 0) return static_cast<int>(cudaSuccess);
  if (b > 65535 || (c + kCh - 1) / kCh > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = bwd_smem(win);
  cudaError_t err = cudaFuncSetAttribute(
      seg_window_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = c % 4 == 0 && ldg % 4 == 0 && aligned(off, 4) &&
                   aligned(g, 16) && aligned(gin, 16);
  seg_window_bwd_kernel<<<grid_for(kBwdRows, b, n, c), kBwdThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      off, g, keys, gin, n, c, ldg, win, vec);
  return static_cast<int>(cudaGetLastError());
}
