// Sorted-key segment sum for sparse (K2) and dense (K7) scans, its VJP, the
// sorted table gather (K5), and its channel-major twin (K6), which also
// serves the row-window channel-major sum (K13).
//
// K2: out[b, cell] = sum of rows[b, i] over the rows with keys[b, i] ==
// cell. Replaces the TPU kernel paddle3d_tpu/ops/pallas/sorted_scatter.py
// :_kernel (entry _sorted_segment_sum_pallas), reached there through
// sorted_segment_sum and sorted_segment_sum_split.
//
// What bounds it on the H100: bytes. On the PointPillars-KITTI canvas
// (8 scans x 20,000 rows -> 214,272 cells x 65 channels, f32, split) the
// rows read are ~42 MB and the dense table written ~446 MB, of which ~96 %
// of the cells are empty. The least the card can do is write every cell
// once, zeros included, as one stream, and read the rows once.
//
// Design: one kernel writes every cell of the table (and of `extra`)
// exactly once, and nothing else touches it: no memset runs before it. A
// block of 512 threads owns a tile of kK2Tile = 128 consecutive cells.
// Because the keys are sorted, the tile's rows are one range [r0, r1); two
// warps find its bounds at once, each by a 32-way search (a ballot over 32
// probes a round: three dependent L2 loads at 20,000 rows, where a binary
// search would chain fifteen). A tile-start array filled by a first pass
// over the keys (O(rows + tiles), one load a block in place of the search)
// measured 1.3 % slower at KITTI: its pass and launch cost more than the
// search, whose latency the other blocks of an SM hide. A tile with no row
// streams its zeros with 16-byte streaming stores (__stcs of float4; a
// scalar head and tail where the span is not 16-byte aligned, as when
// c_main is not a multiple of 4).
// Clustered scans occupy most tiles (at KITTI ~94 % of the 128-cell tiles
// hold a row, though ~96 % of the cells are empty), so the occupied tile
// is the main path. It marks each cell's first row in shared memory (each
// row writes the starts of the cells its key step crosses: O(rows +
// cells), no search) and lists its occupied cells. Its empty cells get
// their zeros as the same 16-byte streaming stores where c_main % 4 == 0
// (each store tests its cell in shared memory), scalar ones otherwise. The
// occupied cells are summed by a lane group a cell, a lane a channel, so
// row reads and table writes coalesce along the channel (the split form's
// rows are 65 floats, not 16-byte aligned, so they are read as scalars).
// Every table store is a streaming one: mixing them with plain stores on
// the same lines measured slower. The row reads are what the write stream
// would stall: a tile whose rows fit the 32 KB shared-memory stage (at
// most 126 rows of 65 floats) copies them there with cp.async as soon as
// its range is known, so that they land while the block marks the starts
// and streams the zeros; its cells are then summed from shared memory.
// A larger tile's cells read their rows from device memory, eight rows'
// loads issued before their adds; a segment of 64 rows or more (a clipped
// scan piles ~1,000 rows into each of the grid's first and last cells)
// is copied 16 KB at a time into one half of the stage while thread ch
// adds channel ch of the other half. The blocks take the tiles from both
// ends of the grid inward, every scan's tile together, so that those
// corner segments start first instead of ending the kernel late. More
// threads a tile and 128-cell tiles measured fastest: a block's time is
// mostly the latency of its few dependent steps (search, starts, sums).
// Each lane adds its cell's rows in row order starting from +0: the plain
// row-order sum, bit for bit, whatever order the cells are listed in. One
// writer a cell, no atomics on the table. Keys outside [0, num_cells) (the
// sentinel) lie outside every tile's range and are dropped. With `extra`
// set (split form), the last channel goes to its own [B, cells] buffer,
// the pillar canvas's occupancy side channel. The TPU kernel's one-hot
// MXU products, cap-aligned DMA windows and prefetch slots are TPU
// workarounds and have no counterpart here.
//
// K5: grad_rows[b, i] = [g | g_extra][b, keys[b, i]], zero where the key
// lies outside [0, num_cells) (the sentinel 2^31-1 included). Replaces
// sorted_scatter.py:_kernel_tg (entry _sorted_table_gather_tg): the TPU
// kernel's one-hot window matmuls and serial chunk walks exist because a
// row gather is slow there; here it is a gather. It runs once a train step
// after K2 or K7: the KITTI pillar canvas (8 x 20,000 rows x 65 channels,
// split, the occupancy with no cotangent), the CenterPoint-pillars canvas
// (8 x 250,000 x 64), and the dense BEVs of the voxel and two-stage
// trainings.
//
// What bounds it on the H100: bytes. The rows written ([B, N, c], ~42 MB
// at KITTI, ~512 MB at CenterPoint-pillars) and each distinct cell's c
// values read once. The cotangent g [B, cells, c_main] comes through its
// strides: autograd hands the pillar canvases' over channel-major (a view
// of the backbone's NCHW gradient), the dense BEVs' row-major. Read
// channel-major, a cell's channel is 4 bytes of a 32-byte sector that only
// occupied neighbours share: at KITTI (~4 % of the cells occupied) the
// values needed lie in ~97 MB of sectors, more than the 42 MB written, and
// that, not the count of distinct values, is the floor there. The first
// design staged 32 rows a block and read a value per (row, channel), once
// per row that names the cell, one load at a time a thread.
//
// Design: a block of 256 threads owns R consecutive rows of one scan (R =
// 8,192 / c rounded down to a multiple of 4, within [4, 1024]: 128 at
// c = 64, 124 at 65; halved, to at least 16, while the grid would give the
// card fewer than 12 blocks an SM, since a block's phases run one after
// another and only overlapping blocks keep the memory busy). It loads its
// keys, marks the run heads (an in-range key that differs from the row
// before; the block's first row heads its run) with a ballot a 32-row
// chunk, numbers them by a scan of the chunks' counts and lists the
// distinct cells. It reads each listed cell's c values once into a shared
// table [D][c | 1], eight loads in flight a thread: for a row-major
// cotangent (gsc == 1) lanes run along the channels, 16 bytes a load where
// aligned; otherwise (channel-major) along the listed cells, a channel at
// a time, so that neighbouring occupied cells share sectors. g_extra, or
// zero where it is null, fills channel c - 1 in the split form. The
// block's output out[b, r0:r0 + R, :] is R * c contiguous floats, written
// as one stream of 16-byte streaming stores (__stcs of float4) between a
// scalar head and tail; each element comes from the table through its
// row's index into the list, or is 0 for an out-of-range key. A run longer
// than R is read again by each block it reaches (the ~1,000-row corner
// cells of a clipped scan: a few reads of one cell). It is a copy, so it
// equals the plain torch.gather version bit for bit, whatever the keys'
// order.
//
// K6 and K13: out[b, cell, ch] = sum of rows_cm[b, ch, i] over i < N with
// keys[b, i] == cell, from channel-major rows. One kernel replaces three TPU
// kernels: sorted_scatter.py:_kernel_cm (entry _sorted_segment_sum_cm) and
// :_kernel_cmg (entry _sorted_segment_sum_cmg, its grouped variant), both
// reached through sorted_segment_sum_cm on dense scans, where the fused
// PFN's native [B, C, N] rows go to the canvas with no transpose copy (K6);
// and :_kernel_rw (entry _sorted_segment_sum_rw, K13), the same function for
// c | 128 over fixed windows of sorted rows, so that the TPU's load did not
// depend on how the rows spread over the cells. No path of the JAX package
// reaches K13 (its tests and tools/bench_scatter_rw.py do); the port carries
// it as an op, ops/sorted_scatter.sorted_segment_sum_rw. The TPU's row
// windows served its DMA windows; here a block owns cells, so that it
// writes every one of them once, and splits each chunk of its rows among
// its threads: both entries launch this kernel (K13 without the split
// form). rows_cm may be a strided view wider than needed ([B, C', N'],
// C' >= c, N' >= N): only the first c channels and N columns are used.
//
// What bounds it on the H100: bytes. At CenterPoint-nuScenes (8 scans x
// 250,000 rows x 64 channels onto 512 x 512 cells, ~42 % of the cells
// occupied) and at tools/bench_scatter_rw.py's shape (the same sizes, 60 %
// of the rows in a quarter of the cells) ~512 MB of rows are read and
// ~537 MB of table written; every cell is written once by the kernel, empty
// ones as zero, and no memset runs before it.
//
// Design: a block of 512 threads owns a span of consecutive cells (512 at
// c = 64: 32,768 / c, at most 512, halved up to twice where the grid would
// give the card fewer than two blocks an SM) and all channels. Because the
// keys are sorted, the span's rows are one range [r0, r1); two warps find
// its bounds at once by 32-way searches (warp_lower_bound). The range is
// streamed through shared memory in chunks of 8,192 / c rows (128 at
// c = 64, 32 KB) through two buffers: chunk i + 1 is in flight while the
// block adds chunk i. Where a channel's rows are contiguous (rsi == 1), one
// thread a channel copies the channel's span with one bulk copy (TMA,
// cp.async.bulk), completing on the buffer's mbarrier; the span is widened
// to whole 16-byte units, which reads at most 12 bytes either side that lie
// in the 16-byte granules of its first and last rows (never another page),
// and each channel's rows keep their 16-byte phase in shared memory,
// channels an odd number of 16-byte units apart. Other strides take 4-byte
// cp.async copies. Each chunk's keys (and one on either side) are staged
// beside it. Before the first chunk is added, every row marks its cell
// occupied, and the empty cells get their zeros as 16-byte streaming stores
// where c_main % 4 == 0 (each store tests its cell in shared memory), scalar
// ones otherwise. The work is split by rows, not by cells, so that every
// thread has the same share whatever the segments' lengths: thread (g, ch)
// takes channel ch of the g-th of 512 / c slices of a chunk's rows (16 rows
// at c = 64), skips the rows of a segment headed in an earlier slice, and
// adds each segment headed in its slice in row order from +0, on past its
// slice to the segment's end; a segment that runs on into the next chunk
// leaves its partial sum in shared memory for thread (0, ch) to go on with.
// So each (cell, channel) is its rows added one at a time in row order from
// +0: bit-equal to the row-order sum, one writer a cell, no atomics. A warp
// reads one staged row of 32 channels and writes 32 channels of one cell
// (one 128-byte line) with a streaming store (__stcs); the row read meets a
// 4-way bank conflict, the price of copying whole 16-byte units. Keys
// outside [0, num_cells) (the sentinel) lie outside every span's range and
// are dropped. With `extra` set (split form), channel c - 1 goes to its own
// [B, cells] buffer, the pillar canvas's occupancy side channel. The TPU
// kernels' one-hot MXU products, view windows, cell-block groups, chunk
// carries, write slots and serial chunk DMAs are TPU workarounds and have no
// counterpart here.
//
// K7: the same function as K2 for dense scans, out[b, cell] = sum of
// rows[b, i] over the rows with keys[b, i] == cell, rows row-major.
// Replaces the TPU kernel sorted_scatter.py:_kernel_bs (entry
// _sorted_segment_sum_bs), which the JAX package picks when a scan averages
// more than 2 x 128 rows per cell block (ops/sorted_scatter.is_dense_scan):
// the dense BEV of the sparse-voxel middle encoders (4 scans x 20,000 rows
// x 128 channels onto 2 x 180 x 180 cells at CenterPoint-voxels nuScenes)
// and the multi-layer pillar train canvas (8 x 250,000 rows x 64 channels
// onto 512 x 512 cells at CenterPoint-pillars nuScenes).
//
// What bounds it on the H100: bytes. There the rows read are ~41 MB and
// the table written ~133 MB (voxels), ~512 MB and ~537 MB (pillars); every
// cell is written once by the kernel, empty ones as zero, and no memset
// runs before it.
//
// Design: K6's (above; sorted_segment_sum_rm_kernel): blocks own spans of
// cells, find their row range by two searches, stream it through two
// buffers and split each chunk's rows among their threads, a segment's
// partial carried across chunks in shared memory. Row-major rows [B, N, c]
// differ in the staging: a chunk of them is one contiguous byte range, so
// one thread copies it with one bulk copy (TMA), widened to whole 16-byte
// units as K6's channel copies are, into one of the two buffers as
// [rows][c]. Thread (g, ch) reads staged row r at r * c + ch: a warp reads
// 32 consecutive floats, with no bank conflict. Rows wider than 256
// channels take groups of 256 channels, a grid row a group, each row's
// group staged by 4-byte copies (no model path has such rows). One writer a
// (cell, channel), each cell's rows added in row order from +0: bit-equal
// to the row-order sum. The split form writes channel c - 1 to its own
// [B, cells] buffer. The TPU kernel's one-hot MXU products over two
// abutting row views and its serial chunk DMAs are TPU workarounds and have
// no counterpart here.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kThreads = 256;

// first index in [0, n) whose key is >= value (keys sorted), found by the
// whole warp: each round 32 probes split the interval and a ballot keeps
// the one part that holds the answer. Every lane returns it.
__device__ __forceinline__ int warp_lower_bound(const int* keys, int n,
                                                int value, int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + lane * step;
    const unsigned less =
        __ballot_sync(0xffffffffu, p < hi && keys[p] < value);
    if (less == 0u) return lo;
    const int cnt = __popc(less);  // the probes below value are a prefix
    hi = min(hi, lo + cnt * step);
    lo += (cnt - 1) * step + 1;
  }
  return lo;
}

// zero p[0, len) with the block's threads: streaming stores, 16 bytes a
// store between a scalar head and tail
__device__ __forceinline__ void zero_fill(float* p, int len) {
  const int mis = static_cast<int>(reinterpret_cast<size_t>(p) & 15) >> 2;
  const int head = min(len, (4 - mis) & 3);
  const int n4 = (len - head) >> 2;
  for (int i = threadIdx.x; i < head; i += blockDim.x) __stcs(p + i, 0.f);
  float4* q = reinterpret_cast<float4*>(p + head);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    __stcs(q + i, make_float4(0.f, 0.f, 0.f, 0.f));
  }
  for (int i = head + 4 * n4 + threadIdx.x; i < len; i += blockDim.x) {
    __stcs(p + i, 0.f);
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src) : "memory");
}

constexpr int kK2Tile = 128;       // cells a block owns
constexpr int kK2Threads = 512;
constexpr int kLongRows = 64;      // a segment at least this long is staged
constexpr int kStageFloats = 8192; // the stage: two halves of 16 KB

// rows of c floats in each half of K2's stage (0: long segments are not
// staged, when a block has fewer threads than channels)
__host__ __device__ constexpr int stage_rows(int c) {
  return c > kK2Threads ? 0 : kStageFloats / 2 / c;
}

__global__ void __launch_bounds__(kK2Threads)
    sorted_segment_sum_kernel(const int* __restrict__ keys,
                              const float* __restrict__ rows,
                              float* __restrict__ out,
                              float* __restrict__ extra, int n, int c,
                              int num_cells) {
  extern __shared__ float s_stage[];  // [2 * stage_rows(c)][c]
  // s_start[t]: first row of cell cell0 + t; s_start[ncell]: the tile's end
  __shared__ int s_start[kK2Tile + 1];
  __shared__ int s_occ[kK2Tile];   // the tile's occupied cells, any order
  __shared__ int s_range[2];
  __shared__ int s_nocc;
  // the tiles from both ends of the grid inward, every scan's tile t
  // together: a scan clipped to its range piles its far points into the
  // first and last cells, and those long segments start first rather than
  // end the kernel late
  const int tiles = (num_cells + kK2Tile - 1) / kK2Tile;
  const int batch = gridDim.x / tiles;
  const int b = blockIdx.x % batch;
  const int pos = blockIdx.x / batch;
  const int tile = (pos & 1) ? tiles - 1 - (pos >> 1) : pos >> 1;
  const int cell0 = tile * kK2Tile;
  const int ncell = min(kK2Tile, num_cells - cell0);
  const int* kb = keys + static_cast<size_t>(b) * n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < 2) {   // the tile's rows: [r0, r1)
    const int r = warp_lower_bound(kb, n, cell0 + (warp == 0 ? 0 : ncell),
                                   lane);
    if (lane == 0) s_range[warp] = r;
  }
  if (threadIdx.x == 0) s_nocc = 0;
  __syncthreads();
  const int r0 = s_range[0];
  const int r1 = s_range[1];
  const int c_main = extra != nullptr ? c - 1 : c;
  const size_t g0 = static_cast<size_t>(b) * num_cells + cell0;
  float* ob = out + g0 * c_main;
  float* eb = extra != nullptr ? extra + g0 : nullptr;
  if (r0 == r1) {  // no row in the tile
    zero_fill(ob, ncell * c_main);
    if (eb != nullptr) zero_fill(eb, ncell);
    return;
  }
  // a tile whose rows fit the stage copies them there now, so that their
  // loads are in flight while the block marks the starts and streams zeros
  const float* rb = rows + static_cast<size_t>(b) * n * c;
  const int stage = stage_rows(c);
  const bool prefetched = r1 - r0 <= 2 * stage;   // both halves
  if (prefetched) {
    const float* src = rb + static_cast<size_t>(r0) * c;
    for (int q = threadIdx.x; q < (r1 - r0) * c; q += kK2Threads) {
      cp_async4(s_stage + q, src + q);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  // each row starts the cells from just past its predecessor's key to its
  // own (keys in [cell0, cell0 + ncell) here); the cells past the last key
  // start at r1
  for (int j = r0 + threadIdx.x; j < r1; j += kK2Threads) {
    const int k = kb[j] - cell0;
    for (int t = j > r0 ? kb[j - 1] - cell0 + 1 : 0; t <= k; ++t) {
      s_start[t] = j;
    }
  }
  const int last = kb[r1 - 1] - cell0;
  for (int t = last + 1 + threadIdx.x; t <= ncell; t += kK2Threads) {
    s_start[t] = r1;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < ncell; t += kK2Threads) {
    if (s_start[t] < s_start[t + 1]) s_occ[atomicAdd(&s_nocc, 1)] = t;
  }
  __syncthreads();
  const int nocc = s_nocc;
  // the empty cells' zeros: 16 bytes a store where the tile's span allows
  if ((c_main & 3) == 0 && (reinterpret_cast<size_t>(ob) & 15) == 0) {
    const int q4 = c_main >> 2;
    const int shift = (q4 & (q4 - 1)) == 0 ? __ffs(q4) - 1 : -1;
    float4* o4 = reinterpret_cast<float4*>(ob);
    for (int q = threadIdx.x; q < ncell * q4; q += kK2Threads) {
      const int t = shift >= 0 ? q >> shift : q / q4;
      if (s_start[t] == s_start[t + 1]) {
        __stcs(o4 + q, make_float4(0.f, 0.f, 0.f, 0.f));
      }
    }
  } else {
    for (int f = threadIdx.x; f < ncell * c_main; f += kK2Threads) {
      const int t = f / c_main;
      if (s_start[t] == s_start[t + 1]) __stcs(ob + f, 0.f);
    }
  }
  if (eb != nullptr) {
    for (int t = threadIdx.x; t < ncell; t += kK2Threads) {
      if (s_start[t] == s_start[t + 1]) __stcs(eb + t, 0.f);
    }
  }
  if (prefetched) {   // the occupied cells summed from the stage
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    for (int f = threadIdx.x; f < nocc * c; f += kK2Threads) {
      const int o = f / c;
      const int ch = f - o * c;
      const int cell = s_occ[o];
      const int end = s_start[cell + 1] - r0;
      float acc = 0.f;
      for (int j = s_start[cell] - r0; j < end; ++j) {
        acc += s_stage[j * c + ch];  // row order
      }
      if (ch < c_main) {
        __stcs(ob + cell * c_main + ch, acc);
      } else {
        __stcs(eb + cell, acc);
      }
    }
    return;
  }
  const int longest = stage > 0 ? kLongRows : INT_MAX;
  // the occupied cells: a lane group a cell, a lane a channel
  for (int f = threadIdx.x; f < nocc * c; f += kK2Threads) {
    const int o = f / c;
    const int ch = f - o * c;
    const int cell = s_occ[o];
    const int end = s_start[cell + 1];
    if (end - s_start[cell] >= longest) continue;
    // eight rows' loads issued before their adds (a loop of unknown length
    // would wait a memory latency a row), then added in row order
    float acc = 0.f;
    for (int j = s_start[cell]; j < end; j += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        v[u] = j + u < end ? rb[static_cast<size_t>(j + u) * c + ch] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (j + u < end) acc += v[u];
      }
    }
    if (ch < c_main) {
      __stcs(ob + cell * c_main + ch, acc);
    } else {
      __stcs(eb + cell, acc);
    }
  }
  // long segments: the block copies `stage` rows at a time into one half
  // of the stage (one contiguous span, all of its loads in flight) while
  // thread ch adds channel ch of the other half's rows in row order
  for (int o = 0; o < nocc; ++o) {
    const int cell = s_occ[o];
    const int s0 = s_start[cell];
    const int end = s_start[cell + 1];
    if (end - s0 < longest) continue;
    const int chunks = (end - s0 + stage - 1) / stage;
    auto fetch = [&](int chunk) {
      const int j0 = s0 + chunk * stage;
      const int len = min(stage, end - j0) * c;
      const float* src = rb + static_cast<size_t>(j0) * c;
      float* dst = s_stage + (chunk & 1) * stage * c;
      for (int q = threadIdx.x; q < len; q += kK2Threads) {
        cp_async4(dst + q, src + q);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    float acc = 0.f;
    fetch(0);
    for (int i = 0; i < chunks; ++i) {
      if (i + 1 < chunks) {
        fetch(i + 1);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncthreads();
      if (threadIdx.x < c) {
        const float* src = s_stage + (i & 1) * stage * c;
        const int len = min(stage, end - s0 - i * stage) * c;
        for (int q = threadIdx.x; q < len; q += c) acc += src[q];
      }
      __syncthreads();   // the half is read before chunk i + 2 lands in it
    }
    if (threadIdx.x < c_main) {
      __stcs(ob + cell * c_main + threadIdx.x, acc);
    } else if (threadIdx.x < c) {
      __stcs(eb + cell, acc);
    }
  }
}

// K5: a block owns rows of one scan (tg_rows), as many as keep its table
// of distinct cells (at most one a row) within kTgTableFloats
constexpr int kTgThreads = 256;
constexpr int kTgTableFloats = 8192;
constexpr int kTgMaxRows = 1024;
constexpr int kTgMinRows = 16;
constexpr int kTgDepth = 8;   // table loads in flight a thread

__host__ __device__ constexpr int tg_rows(int c) {
  const int r = (kTgTableFloats / c) & ~3;
  return r < 4 ? 4 : (r > kTgMaxRows ? kTgMaxRows : r);
}

// bytes of dynamic shared memory for rows r at c channels: the table
// [r][c | 1], the keys [r], each row's distinct index [r], the distinct
// cells [r], the heads a 32-row chunk [32] and their count
constexpr size_t tg_smem(int r, int c) {
  return (static_cast<size_t>(r) * (c | 1) + 3 * static_cast<size_t>(r) +
          33) * sizeof(float);
}

__global__ void __launch_bounds__(kTgThreads)
    sorted_table_gather_kernel(const int* __restrict__ keys,
                               const float* __restrict__ g, long long gsb,
                               long long gsk, long long gsc,
                               const float* __restrict__ g_extra,
                               long long esb, long long esk,
                               float* __restrict__ out, int n, int c,
                               int c_main, int num_cells, int rows_a_block) {
  extern __shared__ float s_tg[];
  const int cp = c | 1;  // odd pitch: a warp along cells hits 32 banks
  const int R = rows_a_block;
  float* s_tab = s_tg;
  int* s_key = reinterpret_cast<int*>(s_tab + static_cast<size_t>(R) * cp);
  int* s_idx = s_key + R;
  int* s_cell = s_idx + R;
  int* s_chunk = s_cell + R;  // [32], then the distinct count
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * R;
  const int rows = min(R, n - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int* kb = keys + static_cast<size_t>(b) * n + r0;
  for (int r = tid; r < rows; r += kTgThreads) s_key[r] = kb[r];
  __syncthreads();

  // run heads: an in-range key that differs from the row before (the
  // block's first row always heads); each row's running head count within
  // its 32-row chunk, the chunk's count
  const int chunks = (rows + 31) >> 5;
  for (int ch = tid >> 5; ch < chunks; ch += kTgThreads / 32) {
    const int r = (ch << 5) + lane;
    const int k = r < rows ? s_key[r] : -1;
    const bool in = r < rows && k >= 0 && k < num_cells;
    const bool head = in && (r == 0 || s_key[r - 1] != k);
    const unsigned ballot = __ballot_sync(0xffffffffu, head);
    if (r < rows) s_idx[r] = __popc(ballot & (0xffffffffu >> (31 - lane)));
    if (lane == 0) s_chunk[ch] = __popc(ballot);
  }
  __syncthreads();
  if (tid < 32) {
    const int v = tid < chunks ? s_chunk[tid] : 0;
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += u;
    }
    if (tid < chunks) s_chunk[tid] = incl - v;
    if (tid == 31) s_chunk[32] = incl;
  }
  __syncthreads();
  // each row's index into the distinct list (-1 out of range); the heads
  // list their cells
  for (int r = tid; r < rows; r += kTgThreads) {
    const int k = s_key[r];
    const bool in = k >= 0 && k < num_cells;
    const int idx = in ? s_chunk[r >> 5] + s_idx[r] - 1 : -1;
    if (in && (r == 0 || s_key[r - 1] != k)) s_cell[idx] = k;
    s_idx[r] = idx;
  }
  __syncthreads();

  // each distinct cell's c values, read once, kTgDepth loads in flight a
  // thread (one at a time left each thread a chain of device-memory waits)
  const int D = s_chunk[32];
  const float* gb = g + b * gsb;
  if (gsc == 1 && (c_main & 3) == 0 && (gsk & 3) == 0 && (gsb & 3) == 0 &&
      (reinterpret_cast<size_t>(g) & 15) == 0) {
    // row-major and aligned: lanes along the channels, 16 bytes a load
    const int q4 = c_main >> 2;
    const int total = D * q4;
    for (int f0 = tid; f0 < total; f0 += kTgDepth * kTgThreads) {
      float4 v[kTgDepth];
      int to[kTgDepth];
#pragma unroll
      for (int u = 0; u < kTgDepth; ++u) {
        const int f = f0 + u * kTgThreads;
        to[u] = -1;
        if (f < total) {
          const int d = f / q4;
          const int ch = (f - d * q4) << 2;
          to[u] = d * cp + ch;
          v[u] = __ldg(reinterpret_cast<const float4*>(gb + s_cell[d] * gsk +
                                                       ch));
        }
      }
#pragma unroll
      for (int u = 0; u < kTgDepth; ++u) {
        if (to[u] >= 0) {
          float* t = s_tab + to[u];
          t[0] = v[u].x;
          t[1] = v[u].y;
          t[2] = v[u].z;
          t[3] = v[u].w;
        }
      }
    }
  } else {
    // row-major unaligned: lanes along the channels; channel-major (or any
    // other strides): lanes along the distinct cells, which sorted keys
    // make ascending, a channel at a time
    const bool rm = gsc == 1;
    const int total = D * c_main;
    for (int f0 = tid; f0 < total; f0 += kTgDepth * kTgThreads) {
      float v[kTgDepth];
      int to[kTgDepth];
#pragma unroll
      for (int u = 0; u < kTgDepth; ++u) {
        const int f = f0 + u * kTgThreads;
        to[u] = -1;
        if (f < total) {
          const int d = rm ? f / c_main : f % D;
          const int ch = rm ? f - d * c_main : f / D;
          to[u] = d * cp + ch;
          v[u] = __ldg(gb + s_cell[d] * gsk + ch * gsc);
        }
      }
#pragma unroll
      for (int u = 0; u < kTgDepth; ++u) {
        if (to[u] >= 0) s_tab[to[u]] = v[u];
      }
    }
  }
  if (c > c_main) {
    for (int d = tid; d < D; d += kTgThreads) {
      s_tab[d * cp + c_main] =
          g_extra != nullptr ? __ldg(g_extra + b * esb + s_cell[d] * esk)
                             : 0.f;
    }
  }
  __syncthreads();

  // the block's rows, out[b, r0:r0 + rows, :], as one stream: 16-byte
  // streaming stores between a scalar head and tail
  float* ob = out + (static_cast<size_t>(b) * n + r0) * c;
  const int len = rows * c;
  const int head = min(
      len, static_cast<int>((16 - (reinterpret_cast<size_t>(ob) & 15)) & 15) >>
               2);
  auto value = [&](int e) {
    const int r = e / c;
    const int idx = s_idx[r];
    return idx >= 0 ? s_tab[idx * cp + (e - r * c)] : 0.f;
  };
  if (tid < head) __stcs(ob + tid, value(tid));
  const int body = (len - head) >> 2;
  float4* o4 = reinterpret_cast<float4*>(ob + head);
  for (int q = tid; q < body; q += kTgThreads) {
    const int e = head + (q << 2);
    int r = e / c;
    int ch = e - r * c;
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = s_idx[r];
      v[u] = idx >= 0 ? s_tab[idx * cp + ch] : 0.f;
      if (++ch == c) {
        ch = 0;
        ++r;
      }
    }
    __stcs(o4 + q, make_float4(v[0], v[1], v[2], v[3]));
  }
  const int tail = head + (body << 2);
  if (tail + tid < len) __stcs(ob + tail + tid, value(tail + tid));
}

// K5 on `stream` with `rows` rows a block
int launch_table_gather(const int* keys, const float* g, long long gsb,
                        long long gsk, long long gsc, const float* g_extra,
                        long long esb, long long esk, float* out, int b,
                        int n, int c, int c_main, int num_cells, int rows,
                        void* stream) {
  if (c_main > c || c_main < c - 1 || b < 0 || n < 0 || c < 0 || rows < 4 ||
      rows > kTgMaxRows || (rows & 3) != 0 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0 || c == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = tg_smem(rows, c);
  static size_t smem_set = 48 * 1024;  // the most the kernel may take so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        sorted_table_gather_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  const dim3 grid((n + rows - 1) / rows, b);
  sorted_table_gather_kernel<<<grid, kTgThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      keys, g, gsb, gsk, gsc, g_extra, esb, esk, out, n, c, c_main,
      num_cells, rows);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kCmThreads = 512;
constexpr int kCmCells = 512;       // cells a block owns, at most
constexpr int kCmMaxC = 256;
constexpr int kCmBufFloats = 8192;  // floats of each of the two row buffers

// rows of a chunk: a multiple of 4, so that a channel's rows keep their
// 16-byte phase from chunk to chunk
__host__ __device__ constexpr int cm_rows(int c) {
  return (kCmBufFloats / c) & ~3;
}

// floats from one channel's staged rows to the next: the rows, room for
// their 16-byte phase, and an odd number of 16-byte units
__host__ __device__ constexpr int cm_pitch(int c) {
  return (cm_rows(c) >> 2) % 2 == 0 ? cm_rows(c) + 4 : cm_rows(c) + 8;
}

// floats of dynamic shared memory: two row buffers [c][cm_pitch(c)], two
// key buffers [cm_rows(c) + 2], two carry rows [c]
constexpr size_t cm_smem_floats(int c) {
  return static_cast<size_t>(2) * c * cm_pitch(c) + 2 * (cm_rows(c) + 2) +
         2 * c;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(kCmThreads, 3)
    sorted_segment_sum_cm_kernel(const int* __restrict__ keys,
                                 const float* __restrict__ rows,
                                 long long rsb, long long rsc, long long rsi,
                                 float* __restrict__ out,
                                 float* __restrict__ extra, int n, int c,
                                 int num_cells, int span) {
  extern __shared__ __align__(16) float s_buf[];
  __shared__ int s_occ[kCmCells];   // cell cell0 + t holds a row
  __shared__ int s_range[2];
  // chunk i's rows have landed in buffer i & 1 (the copies with rsi == 1)
  __shared__ __align__(8) unsigned long long s_bar[2];
  const int tiles = (num_cells + span - 1) / span;
  const int batch = gridDim.x / tiles;
  const int b = blockIdx.x % batch;
  const int cell0 = blockIdx.x / batch * span;
  const int ncell = min(span, num_cells - cell0);
  const int* kb = keys + static_cast<size_t>(b) * n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < 2) {   // the block's rows: [r0, r1)
    const int r = warp_lower_bound(kb, n, cell0 + (warp == 0 ? 0 : ncell),
                                   lane);
    if (lane == 0) s_range[warp] = r;
  }
  for (int t = threadIdx.x; t < ncell; t += kCmThreads) s_occ[t] = 0;
  if (threadIdx.x == 0) {   // c copies arrive on a barrier each chunk
    for (int s = 0; s < 2; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(smem_u32(&s_bar[s])), "r"(c) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int r0 = s_range[0];
  const int r1 = s_range[1];
  const int c_main = extra != nullptr ? c - 1 : c;
  const size_t g0 = static_cast<size_t>(b) * num_cells + cell0;
  float* ob = out + g0 * c_main;
  float* eb = extra != nullptr ? extra + g0 : nullptr;
  if (r0 == r1) {  // no row in the block's cells
    zero_fill(ob, ncell * c_main);
    if (eb != nullptr) zero_fill(eb, ncell);
    return;
  }
  const float* rb = rows + b * rsb;
  const int rows_buf = cm_rows(c);
  const int pitch = cm_pitch(c);
  const int chunks = (r1 - r0 + rows_buf - 1) / rows_buf;
  int* s_keys = reinterpret_cast<int*>(s_buf + 2 * c * pitch);
  float* s_carry = reinterpret_cast<float*>(s_keys + 2 * (rows_buf + 2));
  // the 16-byte phase of channel ch's row r0, which its staged rows keep
  auto phase = [&](int ch) {
    return rsi == 1 ? static_cast<int>(
                          reinterpret_cast<size_t>(rb + ch * rsc + r0) >> 2) &
                          3
                    : 0;
  };
  // chunk i, rows [j0, j0 + len): every channel's rows into row buffer
  // i & 1 at their 16-byte phase, and keys j0 - 1 .. j0 + len into key
  // buffer i & 1
  auto fetch = [&](int i) {
    const int j0 = r0 + i * rows_buf;
    const int len = min(rows_buf, r1 - j0);
    float* buf = s_buf + (i & 1) * c * pitch;
    if (rsi == 1) {
      // thread ch copies channel ch's span, widened to whole 16-byte units
      // (at most 12 bytes either side, in the 16-byte granules of the
      // span's first and last rows), in one bulk copy
      if (threadIdx.x < c) {
        const int ch = threadIdx.x;
        const int ph = phase(ch);
        const unsigned bytes =
            static_cast<unsigned>((ph + len + 3) >> 2) * 16u;
        const unsigned bar = smem_u32(&s_bar[i & 1]);
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
            :: "r"(bar), "r"(bytes) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n"
            :: "r"(smem_u32(buf + ch * pitch)), "l"(rb + ch * rsc + j0 - ph),
            "r"(bytes), "r"(bar) : "memory");
      }
    } else {
      for (int ch = warp; ch < c; ch += kCmThreads / 32) {
        const float* src = rb + ch * rsc + j0 * rsi;
        for (int e = lane; e < len; e += 32) {
          cp_async4(buf + ch * pitch + e, src + e * rsi);
        }
      }
    }
    int* sk = s_keys + (i & 1) * (rows_buf + 2);
    for (int e = threadIdx.x; e < len + 2; e += kCmThreads) {
      const int j = j0 - 1 + e;
      if (j < 0) {
        sk[e] = INT_MIN;
      } else if (j >= n) {
        sk[e] = INT_MAX;
      } else {
        cp_async4(reinterpret_cast<float*>(sk + e),
                  reinterpret_cast<const float*>(kb + j));
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  fetch(0);
  for (int j = r0 + threadIdx.x; j < r1; j += kCmThreads) {
    s_occ[kb[j] - cell0] = 1;
  }
  // thread (g, ch): channel ch of the rows [j0 + g * sub, ...) of a chunk
  const int groups = kCmThreads / c;
  const bool active = threadIdx.x < groups * c;
  const int g = threadIdx.x / c;
  const int ch = threadIdx.x - g * c;
  const int ph = phase(ch);
  const int sub = (rows_buf + groups - 1) / groups;
  auto emit = [&](int cell, float v) {
    if (ch < c_main) {
      __stcs(ob + static_cast<size_t>(cell - cell0) * c_main + ch, v);
    } else {
      __stcs(eb + (cell - cell0), v);
    }
  };
  for (int i = 0; i < chunks; ++i) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    if (rsi == 1) {
      const unsigned bar = smem_u32(&s_bar[i & 1]);
      const unsigned parity = (i >> 1) & 1;
      unsigned done = 0;
      do {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
      } while (!done);
    }
    // chunk i has landed; chunk i - 1's buffers are read (and, at i = 0,
    // the occupied cells marked)
    __syncthreads();
    if (i + 1 < chunks) fetch(i + 1);
    if (i == 0) {   // the empty cells' zeros, 16 bytes a store where it can
      if ((c_main & 3) == 0 && (reinterpret_cast<size_t>(ob) & 15) == 0) {
        const int q4 = c_main >> 2;
        float4* o4 = reinterpret_cast<float4*>(ob);
        for (int q = threadIdx.x; q < ncell * q4; q += kCmThreads) {
          if (!s_occ[q / q4]) __stcs(o4 + q, make_float4(0.f, 0.f, 0.f, 0.f));
        }
      } else {
        for (int f = threadIdx.x; f < ncell * c_main; f += kCmThreads) {
          if (!s_occ[f / c_main]) __stcs(ob + f, 0.f);
        }
      }
      if (eb != nullptr) {
        for (int t = threadIdx.x; t < ncell; t += kCmThreads) {
          if (!s_occ[t]) __stcs(eb + t, 0.f);
        }
      }
    }
    if (!active) continue;
    const int j0 = r0 + i * rows_buf;
    const int j1 = min(j0 + rows_buf, r1);
    const int* sk = s_keys + (i & 1) * (rows_buf + 2) + 1 - j0;  // key j
    const float* sr = s_buf + (i & 1) * c * pitch + ch * pitch + ph - j0;
    const float* carry_in = s_carry + ((i + 1) & 1) * c;
    float* carry_out = s_carry + (i & 1) * c;
    int j = j0 + g * sub;
    const int e = min(j + sub, j1);
    if (j >= e) continue;
    // a segment's rows are added in row order from +0 by the thread whose
    // rows hold its head, on past its own rows; one that runs on into the
    // next chunk leaves its sum in carry_out for thread (0, ch)
    if (g == 0 && sk[j0] == sk[j0 - 1]) {   // a segment open since chunk i - 1
      const int k = sk[j];
      float acc = carry_in[ch];
      do {
        acc += sr[j];
      } while (++j < j1 && sk[j] == k);
      if (j == j1 && sk[j1] == k) {
        carry_out[ch] = acc;
      } else {
        emit(k, acc);
      }
    } else {
      while (j < e && sk[j] == sk[j - 1]) ++j;   // an earlier thread's
    }
    while (j < e) {   // row j heads a segment
      const int k = sk[j];
      float acc = 0.f;
      do {
        acc += sr[j];
      } while (++j < j1 && sk[j] == k);
      if (j == j1 && sk[j1] == k) {
        carry_out[ch] = acc;
      } else {
        emit(k, acc);
      }
    }
  }
}

// The cells a block of the span kernels owns: 32,768 / c, at most 512 (512
// at c = 64), halved up to twice while the grid would give the card fewer
// than two blocks an SM.
cudaError_t span_cells(int b, int c, int num_cells, int* span) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  int s = kCmCells * 64 / c < kCmCells ? kCmCells * 64 / c : kCmCells;
  for (int k = 0; k < 2 && static_cast<long long>(b) *
                               ((num_cells + s - 1) / s) < 2LL * sms;
       ++k) {
    s = (s + 1) / 2;
  }
  *span = s;
  return cudaSuccess;
}

// K6 and K13 on `stream`; `extra` null but for K6's split form
int launch_segment_sum_cm(const int* keys, const float* rows, long long rsb,
                          long long rsc, long long rsi, float* out,
                          float* extra, int b, int n, int c, int num_cells,
                          void* stream) {
  int span = 0;
  cudaError_t err = span_cells(b, c, num_cells, &span);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = cm_smem_floats(c) * sizeof(float);
  err = cudaFuncSetAttribute(sorted_segment_sum_cm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (num_cells + span - 1) / span;
  sorted_segment_sum_cm_kernel<<<static_cast<unsigned>(tiles) * b,
                                 kCmThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      keys, rows, rsb, rsc, rsi, out, extra, n, c, num_cells, span);
  return static_cast<int>(cudaGetLastError());
}

// Zeros into the cells t < ncell for which skip(t) is false: columns
// [0, w) of rows `stride` floats apart from p (kContig: w == stride, one
// range), 16 bytes a store where w, stride and p allow, streaming.
template <bool kContig, typename Skip>
__device__ __forceinline__ void zero_cells(float* p, int ncell, int stride,
                                           int w, Skip skip) {
  if (((stride | w) & 3) == 0 && (reinterpret_cast<size_t>(p) & 15) == 0) {
    const int q4 = w >> 2;
    float4* p4 = reinterpret_cast<float4*>(p);
    for (int q = threadIdx.x; q < ncell * q4; q += blockDim.x) {
      const int t = q / q4;
      if (!skip(t)) {
        __stcs(kContig ? p4 + q
                       : p4 + static_cast<size_t>(t) * (stride >> 2) +
                             (q - t * q4),
               make_float4(0.f, 0.f, 0.f, 0.f));
      }
    }
  } else {
    for (int f = threadIdx.x; f < ncell * w; f += blockDim.x) {
      const int t = f / w;
      if (!skip(t)) {
        __stcs(kContig ? p + f
                       : p + static_cast<size_t>(t) * stride + (f - t * w),
               0.f);
      }
    }
  }
}

// K7: K6's span design for contiguous row-major rows [B, N, c], staged
// row-major: a chunk of rows is one byte range, copied by one bulk copy
// (16-byte ends widened, as K6's channel copies), and thread (g, ch) reads
// staged row r at r * c + ch. kGroups: c > kCmMaxC, a grid row a group of
// kCmMaxC channels, each row's group staged by 4-byte copies kCmMaxC floats
// apart. A kernel of its own: one template for both layouts made K6's
// instantiation spill more registers and run 2-4 % slower on the card.
template <bool kGroups>
__global__ void __launch_bounds__(kCmThreads, 3)
    sorted_segment_sum_rm_kernel(const int* __restrict__ keys,
                                 const float* __restrict__ rows,
                                 float* __restrict__ out,
                                 float* __restrict__ extra, int n, int c,
                                 int num_cells, int span) {
  extern __shared__ __align__(16) float s_buf[];
  __shared__ int s_occ[kCmCells];   // cell cell0 + t holds a row
  __shared__ int s_range[2];
  // chunk i's rows have landed in buffer i & 1 (the bulk copy)
  __shared__ __align__(8) unsigned long long s_bar[2];
  const int tiles = (num_cells + span - 1) / span;
  const int batch = gridDim.x / tiles;
  const int b = blockIdx.x % batch;
  const int cell0 = blockIdx.x / batch * span;
  const int ncell = min(span, num_cells - cell0);
  // the block's channels [cg, cg + cw), staged rows cs floats apart
  const int cs = kGroups ? kCmMaxC : c;
  const int cg = kGroups ? blockIdx.y * kCmMaxC : 0;
  const int cw = kGroups ? min(kCmMaxC, c - cg) : c;
  const int* kb = keys + static_cast<size_t>(b) * n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < 2) {   // the block's rows: [r0, r1)
    const int r = warp_lower_bound(kb, n, cell0 + (warp == 0 ? 0 : ncell),
                                   lane);
    if (lane == 0) s_range[warp] = r;
  }
  for (int t = threadIdx.x; t < ncell; t += kCmThreads) s_occ[t] = 0;
  if (!kGroups && threadIdx.x == 0) {   // one copy a chunk on a barrier
    for (int s = 0; s < 2; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(smem_u32(&s_bar[s])), "r"(1) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int r0 = s_range[0];
  const int r1 = s_range[1];
  const int c_main = extra != nullptr ? c - 1 : c;
  const int cw_main = kGroups ? min(cw, c_main - cg) : c_main;
  const size_t g0 = static_cast<size_t>(b) * num_cells + cell0;
  float* ob = out + g0 * c_main + cg;
  // channel c - 1 of the split form: the last group's
  float* eb = extra != nullptr && (!kGroups || cg + cw == c) ? extra + g0
                                                             : nullptr;
  if (r0 == r1) {  // no row in the block's cells
    if (kGroups) {
      zero_cells<false>(ob, ncell, c_main, cw_main,
                        [](int) { return false; });
    } else {
      zero_fill(ob, ncell * c_main);
    }
    if (eb != nullptr) zero_fill(eb, ncell);
    return;
  }
  const float* rb = rows + static_cast<size_t>(b) * n * c;
  const int rows_buf = cm_rows(cs);
  const int pitch = cm_pitch(cs);
  const int chunks = (r1 - r0 + rows_buf - 1) / rows_buf;
  int* s_keys = reinterpret_cast<int*>(s_buf + 2 * cs * pitch);
  float* s_carry = reinterpret_cast<float*>(s_keys + 2 * (rows_buf + 2));
  // the 16-byte phase of chunk i's first float, which its staged rows keep
  auto phase = [&](int i) {
    return kGroups ? 0
                   : static_cast<int>(reinterpret_cast<size_t>(
                         rb + static_cast<size_t>(r0 + i * rows_buf) * c) >>
                         2) & 3;
  };
  // chunk i, rows [j0, j0 + len): its rows into row buffer i & 1 (from
  // their 16-byte phase), and keys j0 - 1 .. j0 + len into key buffer i & 1
  auto fetch = [&](int i) {
    const int j0 = r0 + i * rows_buf;
    const int len = min(rows_buf, r1 - j0);
    float* buf = s_buf + (i & 1) * cs * pitch;
    if (!kGroups) {
      // one bulk copy, widened to whole 16-byte units (at most 12 bytes
      // either side, in the 16-byte granules of its first and last floats;
      // a buffer holds them: cm_pitch(c) >= cm_rows(c) + 4)
      if (threadIdx.x == 0) {
        const int ph = phase(i);
        const unsigned bytes =
            static_cast<unsigned>((ph + len * c + 3) >> 2) * 16u;
        const unsigned bar = smem_u32(&s_bar[i & 1]);
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
            :: "r"(bar), "r"(bytes) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n"
            :: "r"(smem_u32(buf)), "l"(rb + static_cast<size_t>(j0) * c - ph),
            "r"(bytes), "r"(bar) : "memory");
      }
    } else {
      for (int e = threadIdx.x; e < len * cw; e += kCmThreads) {
        const int r = e / cw;
        const int ch = e - r * cw;
        cp_async4(buf + r * cs + ch,
                  rb + static_cast<size_t>(j0 + r) * c + cg + ch);
      }
    }
    int* sk = s_keys + (i & 1) * (rows_buf + 2);
    for (int e = threadIdx.x; e < len + 2; e += kCmThreads) {
      const int j = j0 - 1 + e;
      if (j < 0) {
        sk[e] = INT_MIN;
      } else if (j >= n) {
        sk[e] = INT_MAX;
      } else {
        cp_async4(reinterpret_cast<float*>(sk + e),
                  reinterpret_cast<const float*>(kb + j));
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  fetch(0);
  for (int j = r0 + threadIdx.x; j < r1; j += kCmThreads) {
    s_occ[kb[j] - cell0] = 1;
  }
  // thread (g, ch): channel ch of the rows [j0 + g * sub, ...) of a chunk
  const int groups = kCmThreads / cs;
  const int g = threadIdx.x / cs;
  const int ch = threadIdx.x - g * cs;
  const bool active = threadIdx.x < groups * cs && (!kGroups || ch < cw);
  const int sub = (rows_buf + groups - 1) / groups;
  auto emit = [&](int cell, float v) {
    if (cg + ch < c_main) {
      __stcs(ob + static_cast<size_t>(cell - cell0) * c_main + ch, v);
    } else {
      __stcs(eb + (cell - cell0), v);
    }
  };
  for (int i = 0; i < chunks; ++i) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    if (!kGroups) {
      const unsigned bar = smem_u32(&s_bar[i & 1]);
      const unsigned parity = (i >> 1) & 1;
      unsigned done = 0;
      do {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
      } while (!done);
    }
    // chunk i has landed; chunk i - 1's buffers are read (and, at i = 0,
    // the occupied cells marked)
    __syncthreads();
    if (i + 1 < chunks) fetch(i + 1);
    if (i == 0) {   // the empty cells' zeros, 16 bytes a store where it can
      zero_cells<!kGroups>(ob, ncell, c_main, cw_main,
                           [&](int t) { return s_occ[t] != 0; });
      if (eb != nullptr) {
        for (int t = threadIdx.x; t < ncell; t += kCmThreads) {
          if (!s_occ[t]) __stcs(eb + t, 0.f);
        }
      }
    }
    if (!active) continue;
    const int j0 = r0 + i * rows_buf;
    const int j1 = min(j0 + rows_buf, r1);
    const int* sk = s_keys + (i & 1) * (rows_buf + 2) + 1 - j0;  // key j
    // row j's value of channel ch at sr[(j - j0) * cs]
    const float* sr = s_buf + (i & 1) * cs * pitch + phase(i) + ch;
    const float* carry_in = s_carry + ((i + 1) & 1) * cs;
    float* carry_out = s_carry + (i & 1) * cs;
    int j = j0 + g * sub;
    const int e = min(j + sub, j1);
    if (j >= e) continue;
    // a segment's rows are added in row order from +0 by the thread whose
    // rows hold its head, on past its own rows; one that runs on into the
    // next chunk leaves its sum in carry_out for thread (0, ch)
    if (g == 0 && sk[j0] == sk[j0 - 1]) {   // a segment open since chunk i - 1
      const int k = sk[j];
      float acc = carry_in[ch];
      do {
        acc += sr[(j - j0) * cs];
      } while (++j < j1 && sk[j] == k);
      if (j == j1 && sk[j1] == k) {
        carry_out[ch] = acc;
      } else {
        emit(k, acc);
      }
    } else {
      while (j < e && sk[j] == sk[j - 1]) ++j;   // an earlier thread's
    }
    while (j < e) {   // row j heads a segment
      const int k = sk[j];
      float acc = 0.f;
      do {
        acc += sr[(j - j0) * cs];
      } while (++j < j1 && sk[j] == k);
      if (j == j1 && sk[j1] == k) {
        carry_out[ch] = acc;
      } else {
        emit(k, acc);
      }
    }
  }
}

// K7 on `stream`; `extra` null but for the split form
int launch_segment_sum_rm(const int* keys, const float* rows, float* out,
                          float* extra, int b, int n, int c, int num_cells,
                          void* stream) {
  const int cs = c < kCmMaxC ? c : kCmMaxC;
  int span = 0;
  cudaError_t err = span_cells(b, cs, num_cells, &span);
  if (err != cudaSuccess) return static_cast<int>(err);
  void (*kernel)(const int*, const float*, float*, float*, int, int, int,
                 int) = c > kCmMaxC ? sorted_segment_sum_rm_kernel<true>
                                    : sorted_segment_sum_rm_kernel<false>;
  const size_t smem = cm_smem_floats(cs) * sizeof(float);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (num_cells + span - 1) / span;
  const dim3 grid(static_cast<unsigned>(tiles) * b,
                  (c + kCmMaxC - 1) / kCmMaxC);
  kernel<<<grid, kCmThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      keys, rows, out, extra, n, c, num_cells, span);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K13: K6's kernel without the split form. keys [b, n] int32 sorted
// ascending per batch row; rows: element (b, ch, i) at rows[b*rsb + ch*rsc +
// i*rsi], ch < c, i < n, 128 % c == 0; out [b, num_cells, c], every cell
// written once (no memset). Returns cudaGetLastError().
extern "C" int p3d_sorted_segment_sum_rw(const int* keys, const float* rows,
                                         long long rsb, long long rsc,
                                         long long rsi, float* out, int b,
                                         int n, int c, int num_cells,
                                         void* stream) {
  if (c < 1 || 128 % c != 0 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || num_cells == 0) return static_cast<int>(cudaSuccess);
  return launch_segment_sum_cm(keys, rows, rsb, rsc, rsi, out, nullptr, b, n,
                               c, num_cells, stream);
}

// K7. keys [b, n] int32 sorted ascending per batch row; rows [b, n, c]
// f32 contiguous, any c >= 1; out [b, num_cells, c] (or [b, num_cells,
// c - 1] plus extra [b, num_cells] when extra is not null), every cell
// written once (no memset). Launches sorted_segment_sum_rm_kernel, a kernel
// of its own on K6's span design with row-major staging. Returns
// cudaGetLastError().
extern "C" int p3d_sorted_segment_sum_dense(const int* keys,
                                            const float* rows, float* out,
                                            float* extra, int b, int n,
                                            int c, int num_cells,
                                            void* stream) {
  if (c < 1 || n < 0 || (extra != nullptr && c < 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || num_cells == 0) return static_cast<int>(cudaSuccess);
  return launch_segment_sum_rm(keys, rows, out, extra, b, n, c, num_cells,
                               stream);
}

// K2. keys [b, n] int32 sorted ascending per batch row; rows [b, n, c] f32;
// out [b, num_cells, c] (or [b, num_cells, c - 1] plus extra [b, num_cells]
// when extra is not null), every cell written once by one kernel (no
// memset). Returns cudaGetLastError().
extern "C" int p3d_sorted_segment_sum(const int* keys, const float* rows,
                                      float* out, float* extra, int b, int n,
                                      int c, int num_cells, void* stream) {
  if (c < 0 || n < 0 || (extra != nullptr && c < 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || num_cells == 0 || c == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const int tiles = (num_cells + kK2Tile - 1) / kK2Tile;
  const size_t smem =
      static_cast<size_t>(2) * stage_rows(c) * c * sizeof(float);
  sorted_segment_sum_kernel<<<static_cast<unsigned>(tiles) * b, kK2Threads,
                              smem, static_cast<cudaStream_t>(stream)>>>(
      keys, rows, out, extra, n, c, num_cells);
  return static_cast<int>(cudaGetLastError());
}

// K5. keys [b, n] int32 (sorted ascending per batch row for the path's
// speed; any order gives the same result); g: element (b, cell, ch) at
// g[b*gsb + cell*gsk + ch*gsc], ch < c_main; g_extra (nullable): element
// (b, cell) at g_extra[b*esb + cell*esk], the channel c_main when c >
// c_main; out [b, n, c] contiguous, every element written; b <= 65,535.
// Returns cudaGetLastError().
extern "C" int p3d_sorted_table_gather(const int* keys, const float* g,
                                       long long gsb, long long gsk,
                                       long long gsc, const float* g_extra,
                                       long long esb, long long esk,
                                       float* out, int b, int n, int c,
                                       int c_main, int num_cells,
                                       void* stream) {
  // tg_rows(c), halved (to at least kTgMinRows) while the grid would give
  // the card fewer than 12 blocks an SM: a block's phases (keys, table
  // reads, row writes) run one after another, so the memory stays busy
  // only where several blocks an SM overlap theirs
  int rows = c > 0 ? tg_rows(c) : 4;
  if (rows > kTgMinRows && b > 0 && n > 0) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    while (rows > kTgMinRows &&
           static_cast<long long>(b) * ((n + rows - 1) / rows) < 12LL * sms) {
      rows = ((rows >> 1) & ~3) < kTgMinRows ? kTgMinRows
                                             : ((rows >> 1) & ~3);
    }
  }
  return launch_table_gather(keys, g, gsb, gsk, gsc, g_extra, esb, esk, out,
                             b, n, c, c_main, num_cells, rows, stream);
}

// K6. keys [b, n] int32 sorted ascending per batch row; rows: element
// (b, ch, i) at rows[b*rsb + ch*rsc + i*rsi], ch < c, i < n; out
// [b, num_cells, c] (or [b, num_cells, c - 1] plus extra [b, num_cells]
// when extra is not null), every cell written once (no memset). Returns
// cudaGetLastError().
extern "C" int p3d_sorted_segment_sum_cm(const int* keys, const float* rows,
                                         long long rsb, long long rsc,
                                         long long rsi, float* out,
                                         float* extra, int b, int n, int c,
                                         int num_cells, void* stream) {
  if (c < 1 || c > kCmMaxC || n < 0 || (extra != nullptr && c < 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || num_cells == 0) return static_cast<int>(cudaSuccess);
  return launch_segment_sum_cm(keys, rows, rsb, rsc, rsi, out, extra, b, n,
                               c, num_cells, stream);
}
