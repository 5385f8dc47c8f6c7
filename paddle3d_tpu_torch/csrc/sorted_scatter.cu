// Sorted-key segment sum: out[b, cell] = sum of rows[b, i] over the rows
// with keys[b, i] == cell.
//
// Replaces the TPU kernel paddle3d_tpu/ops/pallas/sorted_scatter.py:_kernel
// (entry _sorted_segment_sum_pallas), reached there through
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
