// Sorted-key segment sum (K2) and its VJP, the sorted table gather (K5).
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

}  // namespace

// keys [b, n] int32 sorted ascending per batch row; rows [b, n, c] f32;
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
