// Sorted-key sparse 3-D convolution (K8), submanifold or strided, kernel
// size 1 or 3, with the fused eval-BatchNorm epilogue, as two kernels: the
// neighbour map (p3d_sparse_conv_map), built once per key set, and the
// conv over it (p3d_sparse_conv3d), which multiplies only where a tap hits.
//
// nbr[b, i, k] is the row of in_keys[b] that holds the key of
// (z, y, x)(qbase[b, i]) + offset(k), if that coordinate lies in the grid and
// the key is present, else -1 (also for padding queries, qbase outside
// [0, D*H*W)); offsets run over (dz, dy, dx) in {-1, 0, 1}^3 with tap
// k = (dz+1)*9 + (dy+1)*3 + (dx+1) (K = 1: the centre only). A submanifold
// conv passes its own keys as qbase; a strided conv passes the input-grid
// key of out_coord * stride.
//
// out[b, i, :] = sum over taps k and input channels c of
//   feats[b, nbr[b, i, k], c] * weights[k * cin + c, :]
// over the taps that hit, then, on valid query rows, + shift and an optional
// relu; every other row is written as zero. The caller folds the BatchNorm
// scale into the weights and bias * scale into the shift.
//
// Replaces the TPU kernels paddle3d_tpu/ops/pallas/sparse_conv.py:_kernel
// (entry sparse_conv3d_win) and :_kernel_packed (entry
// _sparse_conv3d_packed). Their one-hot MXU matching, 8-bit bf16 key parts,
// lane packing and precomputed boundary bitmask are TPU workarounds.
//
// What bounds it on the H100: operations, 2 * cin * cout a neighbour hit,
// on the wide stages (40k / 20k voxels a scan at 64 / 128 channels on the
// CenterPoint-voxels path); bytes (features, the map, the output) on the
// 16- and 32-channel stages. Products and sums are separate roundings
// (__fmul_rn, __fadd_rn, no fused multiply-add), two instructions a
// multiply-add, so the kernel's own ceiling is half the f32 peak the bound
// assumes.
//
// Design:
//  * the map kernel: a block owns 64 query rows. The keys are sorted, so
//    for each z-offset group the tile's neighbours lie in one span of
//    in_keys; two binary searches find it, and the span's keys are staged
//    in shared memory when it holds at most 1,024 keys (else the searches
//    read device memory). Each (row, tap) is resolved by a binary search in
//    its span, after an integer div/mod boundary test of the query key,
//    which keeps x and y from wrapping across rows (the test of the JAX
//    package's lookup_coords). The map is written row-major [B, Vq, K^3],
//    coalesced. The model layers build it once per key set and hand it to
//    every submanifold conv on that set (models/layers/sparse_layers.py);
//  * the conv kernel: a block owns a tile of 64 to 256 query rows (fewer
//    as cout grows), reads the tile's slice of the map into shared memory
//    and, per tap, compacts the rows that hit with __ballot_sync. Per tap,
//    in tap order, passes of up to 64 hit rows gather those input rows
//    (float4 loads where cin allows) into shared memory, transposed to
//    [channel][row], with the tap's weights, 32 input channels at a time;
//    each thread owns 4 hit rows x cout/16 output channels and multiplies
//    them in registers, input channel by input channel (float4 shared
//    loads of the rows and, for cout a multiple of 64, of the weights). A
//    warp owns 8 consecutive hit rows of a pass and sits out when it has
//    none, so the products computed follow the hits, rounded up to 8 rows
//    a (tile, tap). Between taps the sums wait in shared memory
//    [row][cout]: within a tap each (row, channel) has one owner, so the
//    order tap, then input channel is kept without atomics and the plain
//    version (ops/sparse_conv.py:sparse_conv3d_plain) reproduces the
//    kernel bit for bit. Every output row is written; no memset, no
//    atomics.
// Alternatives tried on the CenterPoint-voxels shapes that were no faster
// (PERF.md, section 6): staging whole taps a round for cin <= 32, a lane
// group a row with no shared memory for cin, cout <= 32, and cp.async
// double buffers. The 16- and 32-channel convs wait on device memory a tap
// at a time; the wide ones stay short of the separate-rounding ceiling.
// Tensor cores (wgmma, under a stated tolerance) and TMA are later speed
// work (ROADMAP item 17).
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMapTile = 64;       // query rows per block of the map kernel
constexpr int kSpan = 1024;        // keys of one z-group staged in smem
constexpr int kMaxTaps = 27;
constexpr int kPass = 64;          // hit rows a pass: 16 row groups x 4
constexpr int kChunk = 32;         // input channels staged per step
constexpr int kInStride = kPass + 4;  // s_in [channel][slot], float4 rows

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
    sparse_conv_map_kernel(const int* __restrict__ qbase,
                           const int* __restrict__ in_keys,
                           int* __restrict__ nbr, int vq, int vin, int D,
                           int H, int W, int ksize) {
  __shared__ int s_keys[3 * kSpan];
  __shared__ int s_lo[3], s_hi[3];
  __shared__ int s_qmin, s_qmax;

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kMapTile;
  const int nrows = min(kMapTile, vq - row0);
  const int hw = H * W;
  const int dhw = D * hw;
  const int ntaps = ksize == 3 ? 27 : 1;
  const int nz = ksize == 3 ? 3 : 1;
  const int* qb = qbase + static_cast<size_t>(b) * vq + row0;
  const int* kb = in_keys + static_cast<size_t>(b) * vin;
  int* nb = nbr + (static_cast<size_t>(b) * vq + row0) * ntaps;

  if (tid == 0) {
    s_qmin = INT_MAX;
    s_qmax = -1;
  }
  __syncthreads();
  if (tid < nrows) {
    const int q = qb[tid];
    if (q >= 0 && q < dhw) {
      atomicMin(&s_qmin, q);
      atomicMax(&s_qmax, q);
    }
  }
  __syncthreads();
  if (s_qmax < 0) {  // all padding: no neighbours
    for (int p = tid; p < nrows * ntaps; p += kThreads) nb[p] = -1;
    return;
  }

  // the span of in_keys that can hold the tile's neighbours, per z-group
  const int margin = ksize == 3 ? W + 1 : 0;
  if (tid < nz) {
    const int dz = ksize == 3 ? tid - 1 : 0;
    const int s = lower_bound(kb, 0, vin, s_qmin + dz * hw - margin);
    s_lo[tid] = s;
    s_hi[tid] = lower_bound(kb, s, vin, s_qmax + dz * hw + margin + 1);
  }
  __syncthreads();
  for (int g = 0; g < nz; ++g) {
    const int len = s_hi[g] - s_lo[g];
    if (len <= kSpan) {
      for (int i = tid; i < len; i += kThreads) {
        s_keys[g * kSpan + i] = kb[s_lo[g] + i];
      }
    }
  }
  __syncthreads();

  // (row, tap) pairs in the map's row-major order: coalesced writes
  for (int p = tid; p < nrows * ntaps; p += kThreads) {
    const int r = p / ntaps;
    const int t = p - r * ntaps;
    int found = -1;
    const int q = qb[r];
    if (q >= 0 && q < dhw) {
      const int dz = ksize == 3 ? t / 9 - 1 : 0;
      const int dy = ksize == 3 ? (t / 3) % 3 - 1 : 0;
      const int dx = ksize == 3 ? t % 3 - 1 : 0;
      const int z = q / hw;
      const int rem = q - z * hw;
      const int y = rem / W;
      const int x = rem - y * W;
      if (z + dz >= 0 && z + dz < D && y + dy >= 0 && y + dy < H &&
          x + dx >= 0 && x + dx < W) {
        const int target = q + dz * hw + dy * W + dx;
        const int g = ksize == 3 ? dz + 1 : 0;
        const int lo = s_lo[g];
        const int len = s_hi[g] - lo;
        if (len <= kSpan) {
          const int* sk = s_keys + g * kSpan;
          const int pos = lower_bound(sk, 0, len, target);
          if (pos < len && sk[pos] == target) found = lo + pos;
        } else {
          const int pos = lower_bound(kb, lo, lo + len, target);
          if (pos < lo + len && kb[pos] == target) found = pos;
        }
      }
    }
    nb[p] = found;
  }
}

// the conv kernel's tile height: 256 query rows at 16 output channels, 128
// up to 64, 64 above (the [rows][cout] sums stay within 32 KB of shared
// memory); at 128 output channels three blocks an SM, each thread unrolling
// two input channels, at the others two blocks and four (measured on the
// CenterPoint-voxels shapes, PERF.md, section 6)
template <int CN>
__host__ __device__ constexpr int tile_rows() {
  return CN == 1 ? 256 : CN <= 4 ? 128 : 64;
}

template <int CN>
size_t conv_smem_bytes(int ntaps) {
  constexpr int kRows = tile_rows<CN>();
  const size_t floats = static_cast<size_t>(kRows) * 16 * CN +
                        kChunk * kInStride + kChunk * 16 * CN;
  return 4 * floats + 4 * static_cast<size_t>(kRows) * ntaps +
         2 * static_cast<size_t>(ntaps) * kRows;
}

// output channel j of thread column tc: for cout a multiple of 64, runs of
// four (float4 shared loads); else interleaved by 16 (conflict-free scalars)
template <int CN>
__device__ __forceinline__ int channel(int tc, int j) {
  return CN % 4 == 0 ? (j >> 2) * 64 + 4 * tc + (j & 3) : tc + 16 * j;
}

// CN = cout / 16 output channels per thread
template <int CN>
__global__ void __launch_bounds__(kThreads, CN == 8 ? 3 : 2)
    sparse_conv3d_kernel(const int* __restrict__ qbase,
                         const int* __restrict__ nbr,
                         const float* __restrict__ feats,
                         const float* __restrict__ weights,
                         const float* __restrict__ shift,
                         float* __restrict__ out, int vq, int vin, int cin,
                         int dhw, int ntaps, int relu, int vec_in) {
  constexpr int kCout = 16 * CN;
  constexpr int kCout4 = kCout / 4;
  constexpr int kRows = tile_rows<CN>();
  static_assert(kRows <= kThreads, "one thread a tile row for the flags");
  extern __shared__ float4 s_dyn[];
  float* s_acc = reinterpret_cast<float*>(s_dyn);   // [kRows][kCout]
  float* s_in = s_acc + kRows * kCout;              // [kChunk][kInStride]
  float* s_w = s_in + kChunk * kInStride;           // [kChunk][kCout]
  int* s_map = reinterpret_cast<int*>(s_w + kChunk * kCout);  // [row][tap]
  short* s_list = reinterpret_cast<short*>(s_map + kRows * ntaps);
  __shared__ int s_cnt[kMaxTaps];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, vq - row0);
  const int* qb = qbase + static_cast<size_t>(b) * vq + row0;
  float4* ob = reinterpret_cast<float4*>(
      out + (static_cast<size_t>(b) * vq + row0) * kCout);

  int q = -1;
  if (tid < nrows) q = qb[tid];
  if (!__syncthreads_or(q >= 0 && q < dhw)) {  // all padding: zero rows
    for (int f = tid; f < nrows * kCout4; f += kThreads) {
      ob[f] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  // the tile's slice of the map, and zeroed sums
  const int* mb = nbr + (static_cast<size_t>(b) * vq + row0) * ntaps;
  for (int p = tid; p < nrows * ntaps; p += kThreads) s_map[p] = mb[p];
  for (int f = tid; f < kRows * kCout4; f += kThreads) {
    s_dyn[f] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // per tap, the tile rows that hit it, in row order (a warp a tap)
  for (int t = warp; t < ntaps; t += kWarps) {
    int cnt = 0;
    for (int r0 = 0; r0 < nrows; r0 += 32) {
      const int r = r0 + lane;
      const bool hit = r < nrows && s_map[r * ntaps + t] >= 0;
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (hit) {
        s_list[t * kRows + cnt + __popc(m & ((1u << lane) - 1u))] =
            static_cast<short>(r);
      }
      cnt += __popc(m);
    }
    if (lane == 0) s_cnt[t] = cnt;
  }
  __syncthreads();

  const int tr = tid >> 4;  // hit-row slots 4 tr .. 4 tr + 3 of a pass
  const int tc = tid & 15;  // output channels channel<CN>(tc, j)
  const float* fb = feats + static_cast<size_t>(b) * vin * cin;
  float4* sw4 = reinterpret_cast<float4*>(s_w);
  float acc[4][CN];

  for (int t = 0; t < ntaps; ++t) {
    const int h = s_cnt[t];  // block-uniform: a tap with no hit is skipped
    const short* lst = s_list + t * kRows;
    for (int p0 = 0; p0 < h; p0 += kPass) {
      const int np = min(kPass, h - p0);
      const bool active = 8 * warp < np;  // warp-uniform: slots 8 w .. 8 w + 7
      for (int c0 = 0; c0 < cin; c0 += kChunk) {
        const int cw = min(kChunk, cin - c0);
        __syncthreads();  // the previous step's readers (and sums) are done
        // the pass's gathered rows, transposed to [channel][slot]
        if (vec_in) {
          const int cw4 = cw >> 2;
          for (int f = tid; f < np * cw4; f += kThreads) {
            const int s = f / cw4;
            const int c4 = f - s * cw4;
            const int idx = s_map[lst[p0 + s] * ntaps + t];
            const float4 v = __ldg(reinterpret_cast<const float4*>(
                                       fb + static_cast<size_t>(idx) * cin +
                                       c0) +
                                   c4);
            float* dst = s_in + 4 * c4 * kInStride + s;
            dst[0] = v.x;
            dst[kInStride] = v.y;
            dst[2 * kInStride] = v.z;
            dst[3 * kInStride] = v.w;
          }
        } else {
          for (int f = tid; f < np * cw; f += kThreads) {
            const int s = f / cw;
            const int c = f - s * cw;
            const int idx = s_map[lst[p0 + s] * ntaps + t];
            s_in[c * kInStride + s] =
                fb[static_cast<size_t>(idx) * cin + c0 + c];
          }
        }
        // the tap's weights, rows c0 .. c0 + cw
        const float4* wk = reinterpret_cast<const float4*>(
            weights + (static_cast<size_t>(t) * cin + c0) * kCout);
        for (int f = tid; f < cw * kCout4; f += kThreads) {
          sw4[f] = __ldg(wk + f);
        }
        __syncthreads();
        if (!active) continue;
        if (c0 == 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int s = 4 * tr + i;
            const int row = s < np ? lst[p0 + s] : 0;
#pragma unroll
            for (int j = 0; j < CN; ++j) {
              acc[i][j] = s < np ? s_acc[row * kCout + channel<CN>(tc, j)]
                                 : 0.f;
            }
          }
        }
#pragma unroll(CN == 8 ? 2 : 4)
        for (int c = 0; c < cw; ++c) {
          const float4 a4 =
              *reinterpret_cast<const float4*>(s_in + c * kInStride + 4 * tr);
          const float a[4] = {a4.x, a4.y, a4.z, a4.w};
          float w[CN];
          if (CN % 4 == 0) {
#pragma unroll
            for (int g = 0; g < CN / 4; ++g) {
              const float4 w4 = *reinterpret_cast<const float4*>(
                  s_w + c * kCout + g * 64 + 4 * tc);
              w[4 * g] = w4.x;
              w[4 * g + 1] = w4.y;
              w[4 * g + 2] = w4.z;
              w[4 * g + 3] = w4.w;
            }
          } else {
#pragma unroll
            for (int j = 0; j < CN; ++j) w[j] = s_w[c * kCout + tc + 16 * j];
          }
#pragma unroll
          for (int j = 0; j < CN; ++j) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(a[i], w[j]));
            }
          }
        }
        if (c0 + kChunk >= cin) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int s = 4 * tr + i;
            if (s < np) {
              const int row = lst[p0 + s];
#pragma unroll
              for (int j = 0; j < CN; ++j) {
                s_acc[row * kCout + channel<CN>(tc, j)] = acc[i][j];
              }
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // epilogue: shift, relu, padding rows zero; float4 rows out
  for (int f = tid; f < nrows * kCout4; f += kThreads) {
    const int r = f / kCout4;
    const int o = 4 * (f - r * kCout4);
    const int qr = qb[r];
    float4 v = s_dyn[f];
    if (shift != nullptr) {
      v.x = __fadd_rn(v.x, shift[o]);
      v.y = __fadd_rn(v.y, shift[o + 1]);
      v.z = __fadd_rn(v.z, shift[o + 2]);
      v.w = __fadd_rn(v.w, shift[o + 3]);
    }
    if (relu) {
      v.x = fmaxf(v.x, 0.f);
      v.y = fmaxf(v.y, 0.f);
      v.z = fmaxf(v.z, 0.f);
      v.w = fmaxf(v.w, 0.f);
    }
    ob[f] = qr >= 0 && qr < dhw ? v : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int CN>
cudaError_t launch(const int* qbase, const int* nbr, const float* feats,
                   const float* weights, const float* shift, float* out,
                   int b, int vq, int vin, int cin, int dhw, int ntaps,
                   int relu, int vec_in, cudaStream_t stream) {
  constexpr int kRows = tile_rows<CN>();
  static bool attr_set = false;  // the opt-in above 48 KB, once a width
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        sparse_conv3d_kernel<CN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(conv_smem_bytes<CN>(kMaxTaps)));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((vq + kRows - 1) / kRows, b);
  sparse_conv3d_kernel<CN>
      <<<grid, kThreads, conv_smem_bytes<CN>(ntaps), stream>>>(
          qbase, nbr, feats, weights, shift, out, vq, vin, cin, dhw, ntaps,
          relu, vec_in);
  return cudaGetLastError();
}

}  // namespace

// qbase [b, vq] int32 sorted ascending per row (padding >= D*H*W);
// in_keys [b, vin] int32 sorted ascending per row, distinct (padding keys
// >= D*H*W); nbr [b, vq, ksize^3] int32, every entry written. ksize 1 or 3.
// Returns cudaGetLastError() of the launch.
extern "C" int p3d_sparse_conv_map(const int* qbase, const int* in_keys,
                                   int* nbr, int b, int vq, int vin, int D,
                                   int H, int W, int ksize, void* stream) {
  if ((ksize != 1 && ksize != 3) || vin < 1 || D < 1 || H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || vq == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((vq + kMapTile - 1) / kMapTile, b);
  sparse_conv_map_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      qbase, in_keys, nbr, vq, vin, D, H, W, ksize);
  return static_cast<int>(cudaGetLastError());
}

// qbase [b, vq] int32 (valid rows in [0, dhw)); nbr [b, vq, ksize^3] int32
// from p3d_sparse_conv_map (or its plain version) for these query keys and
// the input's keys; feats [b, vin, cin] f32; weights [ksize^3 * cin, cout]
// f32, 16-byte aligned; shift [cout] f32 or null; out [b, vq, cout] f32,
// 16-byte aligned, every row written. cout must be a multiple of 16 up to
// 128, ksize 1 or 3. Returns cudaGetLastError() of the launch.
extern "C" int p3d_sparse_conv3d(const int* qbase, const int* nbr,
                                 const float* feats, const float* weights,
                                 const float* shift, float* out, int b,
                                 int vq, int vin, int cin, int cout, int dhw,
                                 int ksize, int relu, void* stream) {
  if ((ksize != 1 && ksize != 3) || cout % 16 != 0 || cout < 16 ||
      cout > 128 || cin < 1 || vin < 1 ||
      reinterpret_cast<size_t>(weights) % 16 != 0 ||
      reinterpret_cast<size_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || vq == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntaps = ksize == 3 ? 27 : 1;
  const int vec_in =
      cin % 4 == 0 && reinterpret_cast<size_t>(feats) % 16 == 0;
  cudaError_t err = cudaErrorInvalidValue;
#define P3D_CONV_CASE(CN)                                                   \
  case CN:                                                                  \
    err = launch<CN>(qbase, nbr, feats, weights, shift, out, b, vq, vin,    \
                     cin, dhw, ntaps, relu, vec_in, s);                     \
    break;
  switch (cout / 16) {
    P3D_CONV_CASE(1)
    P3D_CONV_CASE(2)
    P3D_CONV_CASE(3)
    P3D_CONV_CASE(4)
    P3D_CONV_CASE(5)
    P3D_CONV_CASE(6)
    P3D_CONV_CASE(7)
    P3D_CONV_CASE(8)
    default:
      break;
  }
#undef P3D_CONV_CASE
  return static_cast<int>(err);
}
