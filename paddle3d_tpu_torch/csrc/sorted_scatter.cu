// Sorted-key segment sum for sparse (K2) and dense (K7) scans, its VJP, the
// sorted table gather (K5), its channel-major twin (K6), and the row-window
// channel-major sum (K13).
//
// K2: out[b, cell] = sum of rows[b, i] over the rows with keys[b, i] ==
// cell. Replaces the TPU kernel paddle3d_tpu/ops/pallas/sorted_scatter.py
// :_kernel (entry _sorted_segment_sum_pallas), reached there through
// sorted_segment_sum and sorted_segment_sum_split.
//
// What bounds it on the H100: bytes. On the PointPillars-KITTI canvas
// (8 scans x 20,000 rows -> 214,272 cells x 65 channels, f32) the rows read
// are ~42 MB but the dense table written is ~446 MB, and only ~4 % of its
// cells are occupied, so the table is zeroed with cudaMemsetAsync, which
// streams at the card's fill rate, and the kernel touches only the rows.
//
// Design: because the keys are sorted, a cell's rows are one contiguous
// segment. The thread of a segment's head row (key differs from the row
// before) finds the segment's end, sums it in row order and writes its
// cell: one writer per cell, no atomics, a deterministic order. A long
// segment is still one thread's serial sum (PERF.md: the bench scans'
// corner pillars hold ~1,000 rows). Threads walk (row, channel) with
// the channel fastest, so row reads and table writes are coalesced. Keys
// outside [0, num_cells) (the sentinel) are dropped. With `extra` set
// (split form), the last channel goes to its own [B, cells] buffer, the
// pillar canvas's occupancy side channel. The TPU kernel's one-hot MXU
// products, cap-aligned DMA windows and prefetch slots are TPU workarounds
// and have no counterpart here.
//
// K5: grad_rows[b, i] = g[b, keys[b, i]], zero where the key lies outside
// [0, num_cells) (the sentinel 2^31-1 included). Replaces
// sorted_scatter.py:_kernel_tg (entry _sorted_table_gather_tg): the TPU
// kernel's one-hot window matmuls and serial chunk walks exist because a
// row gather is slow there; here it is a gather. Bandwidth-bound: at KITTI
// it reads ~42 MB of table rows (of a 446 MB table) and writes ~42 MB. The
// cotangent g [B, cells, c_main] is read through its strides (autograd
// hands the canvas cotangent over channel-major, a view of the backbone's
// NCHW gradient), so a block stages 32 rows x all channels in shared
// memory: the table is read along the sorted keys, row fastest, and the
// [B, N, C] rows are written channel fastest. In the split form the last
// channel comes from g_extra [B, cells] (strided alike), or is zero when
// the occupancy had no cotangent (g_extra null).
//
// K6: the channel-major twin of K2, out[b, cell, ch] = sum of
// rows_cm[b, ch, i] over i < N with keys[b, i] == cell. Replaces the TPU
// kernels sorted_scatter.py:_kernel_cm (entry _sorted_segment_sum_cm) and
// :_kernel_cmg (entry _sorted_segment_sum_cmg, its grouped variant), both
// reached through sorted_segment_sum_cm on dense scans: the fused PFN's
// native [B, C, N] rows go to the canvas with no transpose copy. rows_cm
// may be a strided view wider than needed ([B, C', N'], C' >= c, N' >= N):
// only the first c channels and N columns are read.
//
// What bounds it on the H100: bytes. At CenterPoint-nuScenes (8 scans x
// 250,000 rows x 64 channels onto 512 x 512 cells) ~512 MB of rows are read
// and ~537 MB of table written, the table dense (most cells near the
// sensor are occupied), so every cell is written once by the kernel, empty
// ones as zero, and no memset runs before it.
//
// Design: a block owns a tile of consecutive cells (64 at c = 64) and all
// channels. Because the keys are sorted, the tile's rows are one contiguous
// range and each cell's rows a contiguous segment of it; tile + 1 threads
// find the segment bounds by binary search at once. The range is staged
// through shared memory in chunks of 64 rows x c channels (reads coalesced
// along the rows of a channel; the stride padded to 65 against bank
// conflicts), and each thread keeps up to 16 (cell, channel) sums in
// registers, channel fastest, adding its cell's rows of each chunk in row
// order: deterministic, one writer per output, no atomics, and the
// [B, cells, c] writes coalesced straight from the registers. A long
// segment costs one chunk loop per 64 rows, with the cell's c threads busy.
// With `extra` set (split form), the last channel goes to its own
// [B, cells] buffer. The TPU kernels' one-hot MXU products, view windows,
// cell-block groups and serial chunk DMAs are TPU workarounds and have no
// counterpart here.
//
// K7: the same function as K2 for dense scans, out[b, cell] = sum of
// rows[b, i] over the rows with keys[b, i] == cell, rows row-major.
// Replaces the TPU kernel sorted_scatter.py:_kernel_bs (entry
// _sorted_segment_sum_bs), which the JAX package picks when a scan averages
// more than 2 x 128 rows per cell block (ops/sorted_scatter.is_dense_scan):
// the dense BEV of the sparse-voxel middle encoders (4 scans x 20,000 rows
// x 128 channels onto 2 x 180 x 180 cells at CenterPoint-voxels nuScenes)
// and, later, dense pooling.
//
// What bounds it on the H100: bytes. There the rows read are ~41 MB and
// the table written ~133 MB, so every cell is written once by the kernel,
// empty ones as zero, and no memset runs before it.
//
// Design: a block owns a tile of consecutive cells (2,048 / c of them) and
// all channels. tile + 1 threads find the cells' segment bounds by binary
// search at once (keys sorted); then threads run over (cell, channel) with
// the channel fastest, so a warp reads 32 channels of one row and writes 32
// channels of one cell, coalesced, and each thread sums its cell's rows in
// row order in a register: deterministic, one writer per output, no
// atomics. Unlike K2 (one thread per segment), a cell's channels spread
// over threads, so a long segment costs a row loop per thread, not per
// segment. Keys outside [0, num_cells) are dropped; the split form writes
// channel c - 1 to its own [B, cells] buffer. The TPU kernel's one-hot MXU
// products over two abutting row views and its serial chunk DMAs are TPU
// workarounds and have no counterpart here.
//
// K13: the function of K6 restricted to c | 128, out[b, cell, ch] = sum of
// rows_cm[b, ch, i] over i < N with keys[b, i] == cell. Replaces the TPU
// kernel sorted_scatter.py:_kernel_rw (entry _sorted_segment_sum_rw), whose
// grid walks fixed windows of sorted rows rather than cell blocks, so that
// its load does not depend on how the rows spread over the cells. No path
// of the JAX package reaches it (its tests and tools/bench_scatter_rw.py
// do); the port carries it as an op, ops/sorted_scatter.sorted_segment_sum_rw.
//
// What bounds it on the H100: bytes. At tools/bench_scatter_rw.py's shape
// (8 scans x 250,000 channel-major rows of 64 channels onto 512 x 512 cells,
// 60 % of the rows in a quarter of the cells) ~512 MB of rows are read and
// ~537 MB of table written; every cell is written once by the kernel, empty
// ones as zero, and no memset runs before it.
//
// Design: as on the TPU, the unit of work is a window of sorted rows: a
// block owns 8,192 / c rows (at most 1,024) and all channels. It finds the
// segment heads in its window (rows whose key differs from the row
// before), compacted in order with a ballot, and owns the contiguous cells
// from just past the key before its first head to its last head's key
// (to the table's end if that segment is the last): the blocks' cell
// ranges tile the table, so each cell is written by one block, a head's
// cell as its sum and a cell between heads as zero. The window's rows are
// staged through shared memory (reads coalesced along the rows of a
// channel, the stride padded against bank conflicts); threads run over
// (cell, channel) with the channel fastest (coalesced writes), find the
// cell's head by binary search in shared memory and add the segment's rows
// in row order, reading on from device memory where a segment runs past the
// window's end (the block of a segment's head walks it to its end):
// deterministic, bit-equal to the row-order sum, no atomics. The TPU
// kernel's one-hot MXU products over the flat 128-lane chunk layout, its
// chunk carry and its write-slot DMAs are TPU workarounds and have no
// counterpart here.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

// first index in [lo, hi) whose key is >= value (keys sorted)
__device__ __forceinline__ int lower_bound(const int* keys, int lo, int hi,
                                           int value) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < value) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
    sorted_segment_sum_kernel(const int* __restrict__ keys,
                              const float* __restrict__ rows,
                              float* __restrict__ out,
                              float* __restrict__ extra, int n, int c,
                              int num_cells) {
  const int b = blockIdx.y;
  const size_t f = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (f >= static_cast<size_t>(n) * c) return;
  const int i = static_cast<int>(f / c);
  const int ch = static_cast<int>(f - static_cast<size_t>(i) * c);
  const int* kb = keys + static_cast<size_t>(b) * n;
  const int k = kb[i];
  if (k < 0 || k >= num_cells || (i > 0 && kb[i - 1] == k)) return;
  // segment end: gallop, then bisect; a loop that tests each row's key
  // before loading it is a chain of dependent loads, and a scan clipped to
  // its range piles ~1,000 rows into a corner cell
  int lo = i + 1, hi = i + 1, step = 1;  // kb[lo - 1] == k throughout
  while (hi < n && kb[hi] == k) {
    lo = hi + 1;
    hi = min(n, hi + step);
    step *= 2;
  }
  const int end = lower_bound(kb, lo, hi, k + 1);
  const float* rb = rows + static_cast<size_t>(b) * n * c + ch;
  float acc = 0.f;
#pragma unroll 8
  for (int j = i; j < end; ++j) {
    acc += rb[static_cast<size_t>(j) * c];  // independent loads, row order
  }
  const size_t cell = static_cast<size_t>(b) * num_cells + k;
  const int c_main = extra != nullptr ? c - 1 : c;
  if (ch < c_main) {
    out[cell * c_main + ch] = acc;
  } else {
    extra[cell] = acc;
  }
}

constexpr int kTileRows = 32;

__global__ void __launch_bounds__(kThreads)
    sorted_table_gather_kernel(const int* __restrict__ keys,
                               const float* __restrict__ g, long long gsb,
                               long long gsk, long long gsc,
                               const float* __restrict__ g_extra,
                               long long esb, long long esk,
                               float* __restrict__ out, int n, int c,
                               int c_main, int num_cells) {
  extern __shared__ float s_tile[];  // [c][kTileRows + 1]
  __shared__ int s_key[kTileRows];
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kTileRows;
  const int* kb = keys + static_cast<size_t>(b) * n;
  for (int r = threadIdx.x; r < kTileRows; r += blockDim.x) {
    s_key[r] = i0 + r < n ? kb[i0 + r] : -1;
  }
  __syncthreads();
  for (int f = threadIdx.x; f < c * kTileRows; f += blockDim.x) {
    const int ch = f / kTileRows;
    const int r = f - ch * kTileRows;
    const int k = s_key[r];
    float v = 0.f;
    if (k >= 0 && k < num_cells) {
      if (ch < c_main) {
        v = g[b * gsb + k * gsk + ch * gsc];
      } else if (g_extra != nullptr) {
        v = g_extra[b * esb + k * esk];
      }
    }
    s_tile[ch * (kTileRows + 1) + r] = v;
  }
  __syncthreads();
  float* ob = out + (static_cast<size_t>(b) * n + i0) * c;
  for (int f = threadIdx.x; f < kTileRows * c; f += blockDim.x) {
    const int r = f / c;
    const int ch = f - r * c;
    if (i0 + r < n) ob[f] = s_tile[ch * (kTileRows + 1) + r];
  }
}

constexpr int kCmRows = 64;        // rows staged per chunk
constexpr int kCmRowsPad = kCmRows + 1;
constexpr int kCmPairs = 16;       // (cell, channel) sums a thread holds
constexpr int kCmMaxTile = 64;     // cells per block
constexpr int kCmMaxC = 256;

__host__ __device__ constexpr int cm_tile(int c) {
  return kThreads * kCmPairs / c < kCmMaxTile ? kThreads * kCmPairs / c
                                              : kCmMaxTile;
}

__global__ void __launch_bounds__(kThreads)
    sorted_segment_sum_cm_kernel(const int* __restrict__ keys,
                                 const float* __restrict__ rows,
                                 long long rsb, long long rsc, long long rsi,
                                 float* __restrict__ out,
                                 float* __restrict__ extra, int n, int c,
                                 int num_cells) {
  extern __shared__ float s_rows[];  // [c][kCmRowsPad]
  __shared__ int s_start[kCmMaxTile + 1];
  const int tile = cm_tile(c);
  const int b = blockIdx.y;
  const int cell0 = blockIdx.x * tile;
  const int ncell = min(tile, num_cells - cell0);
  const int* kb = keys + static_cast<size_t>(b) * n;
  // s_start[t]: first row of cell cell0 + t; s_start[ncell]: the tile's end
  for (int t = threadIdx.x; t <= ncell; t += blockDim.x) {
    s_start[t] = lower_bound(kb, 0, n, cell0 + t);
  }
  __syncthreads();
  const int npairs = ncell * c;
  const int s = s_start[0];
  const int e = s_start[ncell];
  const float* rb = rows + b * rsb;
  float acc[kCmPairs];
#pragma unroll
  for (int k = 0; k < kCmPairs; ++k) acc[k] = 0.f;

  for (int r0 = s; r0 < e; r0 += kCmRows) {
    const int len = min(kCmRows, e - r0);
    __syncthreads();  // the previous chunk's readers are done
    for (int t = threadIdx.x; t < c * kCmRows; t += blockDim.x) {
      const int ch = t / kCmRows;
      const int r = t - ch * kCmRows;
      if (r < len) s_rows[ch * kCmRowsPad + r] = rb[ch * rsc + (r0 + r) * rsi];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kCmPairs; ++k) {
      const int f = threadIdx.x + k * kThreads;
      if (f < npairs) {
        const int cell = f / c;
        const int ch = f - cell * c;
        const int lo = max(s_start[cell], r0) - r0;
        const int hi = min(s_start[cell + 1], r0 + len) - r0;
        const float* sr = s_rows + ch * kCmRowsPad;
        for (int j = lo; j < hi; ++j) acc[k] += sr[j];  // row order
      }
    }
  }

  const int c_main = extra != nullptr ? c - 1 : c;
#pragma unroll
  for (int k = 0; k < kCmPairs; ++k) {
    const int f = threadIdx.x + k * kThreads;
    if (f < npairs) {
      const int cell = f / c;
      const int ch = f - cell * c;
      const size_t g = static_cast<size_t>(b) * num_cells + cell0 + cell;
      if (ch < c_main) {
        out[g * c_main + ch] = acc[k];
      } else {
        extra[g] = acc[k];
      }
    }
  }
}

constexpr int kDenseWork = 2048;   // (cell, channel) pairs per block
constexpr int kDenseMaxTile = 256;

__host__ __device__ constexpr int dense_tile(int c) {
  return kDenseWork / c < 1               ? 1
         : kDenseWork / c > kDenseMaxTile ? kDenseMaxTile
                                          : kDenseWork / c;
}

__global__ void __launch_bounds__(kThreads)
    sorted_segment_sum_dense_kernel(const int* __restrict__ keys,
                                    const float* __restrict__ rows,
                                    float* __restrict__ out,
                                    float* __restrict__ extra, int n, int c,
                                    int num_cells) {
  __shared__ int s_start[kDenseMaxTile + 1];
  const int tile = dense_tile(c);
  const int b = blockIdx.y;
  const int cell0 = blockIdx.x * tile;
  const int ncell = min(tile, num_cells - cell0);
  const int* kb = keys + static_cast<size_t>(b) * n;
  // s_start[t]: first row of cell cell0 + t; s_start[ncell]: the tile's end
  for (int t = threadIdx.x; t <= ncell; t += blockDim.x) {
    s_start[t] = lower_bound(kb, 0, n, cell0 + t);
  }
  __syncthreads();
  const float* rb = rows + static_cast<size_t>(b) * n * c;
  const int c_main = extra != nullptr ? c - 1 : c;
  for (int f = threadIdx.x; f < ncell * c; f += kThreads) {
    const int cell = f / c;
    const int ch = f - cell * c;
    const int end = s_start[cell + 1];
    float acc = 0.f;
    for (int j = s_start[cell]; j < end; ++j) {
      acc += rb[static_cast<size_t>(j) * c + ch];  // row order
    }
    const size_t g = static_cast<size_t>(b) * num_cells + cell0 + cell;
    if (ch < c_main) {
      out[g * c_main + ch] = acc;
    } else {
      extra[g] = acc;
    }
  }
}

constexpr int kRwTile = 8192;      // floats of the staged row window
constexpr int kRwMaxRows = 1024;

__host__ __device__ constexpr int rw_rows(int c) {
  return kRwTile / c < kRwMaxRows ? kRwTile / c : kRwMaxRows;
}

__global__ void __launch_bounds__(kThreads)
    sorted_segment_sum_rw_kernel(const int* __restrict__ keys,
                                 const float* __restrict__ rows,
                                 long long rsb, long long rsc, long long rsi,
                                 float* __restrict__ out, int n, int c,
                                 int num_cells) {
  extern __shared__ float s_win[];           // [c][w + 1]
  // rows of the window's segment heads, then the last segment's end
  __shared__ int s_head[kRwMaxRows + 1];
  __shared__ int s_hkey[kRwMaxRows];         // their keys, ascending
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_nh, s_lo, s_hi;
  const int w = rw_rows(c);
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * w;
  const int rend = min(r0 + w, n);
  const int* kb = keys + static_cast<size_t>(b) * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_nh = 0;
  __syncthreads();
  // compact the heads in row order, kThreads rows a pass
  for (int p0 = r0; p0 < rend; p0 += kThreads) {
    const int r = p0 + threadIdx.x;
    bool head = false;
    int k = 0;
    if (r < rend) {
      k = kb[r];
      head = k >= 0 && k < num_cells && (r == 0 || kb[r - 1] != k);
    }
    const unsigned mask = __ballot_sync(0xffffffffu, head);
    if (lane == 0) s_warp[warp] = __popc(mask);
    __syncthreads();
    int base = s_nh;
    for (int i = 0; i < warp; ++i) base += s_warp[i];
    if (head) {
      const int pos = base + __popc(mask & ((1u << lane) - 1u));
      s_head[pos] = r;
      s_hkey[pos] = k;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int total = 0;
      for (int i = 0; i < kThreads / 32; ++i) total += s_warp[i];
      s_nh += total;
    }
    __syncthreads();
  }
  const int nh = s_nh;
  if (threadIdx.x == 0) {
    int lo = 0, hi = 0;
    if (nh > 0) {
      const int h0 = s_head[0];
      lo = h0 > 0 ? max(kb[h0 - 1], -1) + 1 : 0;
      // the last segment's end: gallop, then bisect (it may run past the
      // window, through any number of windows)
      const int kl = s_hkey[nh - 1];
      int a = s_head[nh - 1] + 1, z = a, step = 1;  // kb[a - 1] == kl
      while (z < n && kb[z] == kl) {
        a = z + 1;
        z = min(n, z + step);
        step *= 2;
      }
      const int end = lower_bound(kb, a, z, kl + 1);
      s_head[nh] = end;
      hi = (end == n || kb[end] >= num_cells) ? num_cells : kl + 1;
    } else if (blockIdx.x == 0) {
      // no head in the first window: the row holds no valid key at all
      // exactly when none lies in [0, num_cells); then this block zeroes
      // the whole table
      const int s = lower_bound(kb, 0, n, 0);
      if (s == n || kb[s] >= num_cells) hi = num_cells;
    }
    s_lo = lo;
    s_hi = hi;
  }
  __syncthreads();
  const int cell_lo = s_lo;
  const long long total = static_cast<long long>(s_hi - cell_lo) * c;
  if (total == 0) return;
  const float* rb = rows + b * rsb;
  if (nh > 0) {
    // stage the rows from the first head to the window's (or the last
    // segment's) end; rows before the first head belong to an earlier
    // block's segment
    const int s0 = s_head[0] - r0;
    const int s1 = min(rend, s_head[nh]) - r0;
    for (int t = threadIdx.x; t < c * w; t += kThreads) {
      const int ch = t / w;
      const int r = t - ch * w;
      if (r >= s0 && r < s1) {
        s_win[ch * (w + 1) + r] = rb[ch * rsc + (r0 + r) * rsi];
      }
    }
    __syncthreads();
  }
  float* ob = out + (static_cast<size_t>(b) * num_cells + cell_lo) * c;
  for (long long f = threadIdx.x; f < total; f += kThreads) {
    const int cell = cell_lo + static_cast<int>(f / c);
    const int ch = static_cast<int>(f % c);
    const int h = lower_bound(s_hkey, 0, nh, cell);
    float acc = 0.f;
    if (h < nh && s_hkey[h] == cell) {
      const int j0 = s_head[h];
      const int j1 = s_head[h + 1];
      const int jw = min(j1, r0 + w);
      const float* sr = s_win + ch * (w + 1);
      for (int j = j0; j < jw; ++j) acc += sr[j - r0];  // row order
      const float* gr = rb + ch * rsc;
#pragma unroll 8
      for (int j = jw; j < j1; ++j) acc += gr[j * rsi];
    }
    ob[f] = acc;
  }
}

}  // namespace

// K13. keys [b, n] int32 sorted ascending per batch row; rows: element
// (b, ch, i) at rows[b*rsb + ch*rsc + i*rsi], ch < c, i < n, 128 % c == 0;
// out [b, num_cells, c], every cell written. Returns cudaGetLastError().
extern "C" int p3d_sorted_segment_sum_rw(const int* keys, const float* rows,
                                         long long rsb, long long rsc,
                                         long long rsi, float* out, int b,
                                         int n, int c, int num_cells,
                                         void* stream) {
  if (c < 1 || 128 % c != 0 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || num_cells == 0) return static_cast<int>(cudaSuccess);
  const int w = rw_rows(c);
  const size_t smem = static_cast<size_t>(c) * (w + 1) * sizeof(float);
  const dim3 grid(n > 0 ? (n + w - 1) / w : 1, b);
  sorted_segment_sum_rw_kernel<<<grid, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      keys, rows, rsb, rsc, rsi, out, n, c, num_cells);
  return static_cast<int>(cudaGetLastError());
}

// K7. keys [b, n] int32 sorted ascending per batch row; rows [b, n, c]
// f32; out [b, num_cells, c] (or [b, num_cells, c - 1] plus extra
// [b, num_cells] when extra is not null), every cell written. Returns
// cudaGetLastError().
extern "C" int p3d_sorted_segment_sum_dense(const int* keys,
                                            const float* rows, float* out,
                                            float* extra, int b, int n,
                                            int c, int num_cells,
                                            void* stream) {
  if (c < 1 || (extra != nullptr && c < 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || num_cells == 0) return static_cast<int>(cudaSuccess);
  const int tile = dense_tile(c);
  const dim3 grid((num_cells + tile - 1) / tile, b);
  sorted_segment_sum_dense_kernel<<<grid, kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      keys, rows, out, extra, n, c, num_cells);
  return static_cast<int>(cudaGetLastError());
}

// K2. keys [b, n] int32 sorted ascending per batch row; rows [b, n, c] f32;
// out [b, num_cells, c] (or [b, num_cells, c - 1] plus extra [b, num_cells]
// when extra is not null). Returns the first CUDA error of the zero-fill or
// the launch.
extern "C" int p3d_sorted_segment_sum(const int* keys, const float* rows,
                                      float* out, float* extra, int b, int n,
                                      int c, int num_cells, void* stream) {
  if (b == 0 || num_cells == 0 || c == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int c_main = extra != nullptr ? c - 1 : c;
  const size_t cells = static_cast<size_t>(b) * num_cells;
  cudaError_t err = cudaMemsetAsync(out, 0, cells * c_main * sizeof(float), s);
  if (err == cudaSuccess && extra != nullptr) {
    err = cudaMemsetAsync(extra, 0, cells * sizeof(float), s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const size_t elems = static_cast<size_t>(n) * c;
  const dim3 grid(static_cast<unsigned>((elems + kThreads - 1) / kThreads), b);
  sorted_segment_sum_kernel<<<grid, kThreads, 0, s>>>(keys, rows, out, extra,
                                                      n, c, num_cells);
  return static_cast<int>(cudaGetLastError());
}

// keys [b, n] int32; g: element (b, cell, ch) at g[b*gsb + cell*gsk +
// ch*gsc], ch < c_main; g_extra (nullable): element (b, cell) at
// g_extra[b*esb + cell*esk], the channel c_main when c > c_main; out
// [b, n, c] contiguous. Returns cudaGetLastError().
extern "C" int p3d_sorted_table_gather(const int* keys, const float* g,
                                       long long gsb, long long gsk,
                                       long long gsc, const float* g_extra,
                                       long long esb, long long esk,
                                       float* out, int b, int n, int c,
                                       int c_main, int num_cells,
                                       void* stream) {
  if (c_main > c || c_main < c - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0 || c == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(c) * (kTileRows + 1) *
                      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sorted_table_gather_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + kTileRows - 1) / kTileRows, b);
  sorted_table_gather_kernel<<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      keys, g, gsb, gsk, gsc, g_extra, esb, esk, out, n, c, c_main,
      num_cells);
  return static_cast<int>(cudaGetLastError());
}

// keys [b, n] int32 sorted ascending per batch row; rows: element
// (b, ch, i) at rows[b*rsb + ch*rsc + i*rsi], ch < c, i < n; out
// [b, num_cells, c] (or [b, num_cells, c - 1] plus extra [b, num_cells]
// when extra is not null), every cell written. Returns cudaGetLastError().
extern "C" int p3d_sorted_segment_sum_cm(const int* keys, const float* rows,
                                         long long rsb, long long rsc,
                                         long long rsi, float* out,
                                         float* extra, int b, int n, int c,
                                         int num_cells, void* stream) {
  if (c < 1 || c > kCmMaxC || (extra != nullptr && c < 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || num_cells == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(c) * kCmRowsPad * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sorted_segment_sum_cm_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tile = cm_tile(c);
  const dim3 grid((num_cells + tile - 1) / tile, b);
  sorted_segment_sum_cm_kernel<<<grid, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      keys, rows, rsb, rsc, rsi, out, extra, n, c, num_cells);
  return static_cast<int>(cudaGetLastError());
}
