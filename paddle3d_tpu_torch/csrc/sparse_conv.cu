// Sorted-key sparse 3-D convolution (K8), submanifold or strided, kernel
// size 1 or 3, with the fused eval-BatchNorm epilogue.
//
// out[b, i, :] = sum over taps k and input channels c of
//   feats[b, nbr(i, k), c] * weights[k * cin + c, :]
// then, on valid query rows (0 <= qbase[b, i] < D*H*W), + shift and an
// optional relu; every other row is written as zero. nbr(i, k) is the row
// of in_keys[b] that holds the key of (z, y, x)(qbase[b, i]) + offset(k),
// if that coordinate lies in the grid and the key is present; offsets run
// over (dz, dy, dx) in {-1, 0, 1}^3 with tap k = (dz+1)*9 + (dy+1)*3 +
// (dx+1) (K = 1: the centre only). A submanifold conv passes its own keys
// as qbase; a strided conv passes the input-grid key of out_coord * stride.
// The caller folds the BatchNorm scale into the weights and bias * scale
// into the shift.
//
// Replaces the TPU kernels paddle3d_tpu/ops/pallas/sparse_conv.py:_kernel
// (entry sparse_conv3d_win) and :_kernel_packed (entry
// _sparse_conv3d_packed). Their one-hot MXU matching, 8-bit bf16 key parts,
// lane packing and precomputed boundary bitmask are TPU workarounds; the
// two variants are one kernel here.
//
// What bounds it on the H100: operations, when only the taps that hit are
// counted (2 * cin * cout per hit), against a few tens of MB of keys,
// features, weights and output per call on the CenterPoint-voxels path
// (4 scans, 160k / 80k / 40k / 20k voxels at 16 / 32 / 64 / 128 channels).
//
// Design, simple and deterministic:
//  * a block owns 64 consecutive query rows. The keys are sorted, so for
//    each z-offset group the tile's neighbours lie in one span of in_keys;
//    two binary searches find it, and the span's keys are staged in shared
//    memory when it holds at most 1,024 keys (else the searches read
//    device memory). Each (row, tap) is resolved by a binary search in its
//    span, after an integer div/mod boundary test of the query key, which
//    keeps x and y from wrapping across rows (the test of the JAX
//    package's lookup_coords);
//  * for each tap that hits anywhere in the tile, in tap order, the
//    tile's gathered input rows (zero for misses) and the tap's weights are
//    staged 32 input channels at a time in shared memory, and each thread
//    accumulates 4 rows x cout/16 output channels in registers, input
//    channel by input channel. A tap with no hit in the tile is skipped:
//    that is what makes the conv sparse;
//  * products and sums are separate roundings (__fmul_rn, __fadd_rn, no
//    fused multiply-add), in the order tap, then input channel, so the
//    plain version (ops/sparse_conv.py:sparse_conv3d_plain) reproduces the
//    kernel bit for bit. Every output row is written; no memset, no
//    atomics.
// Tensor cores (wgmma), TMA and a reused neighbour map are later speed
// work (PERF.md, open questions).
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;          // query rows per block
constexpr int kRowsPerThread = 4;  // kTile / 16 thread rows
constexpr int kChunk = 32;         // input channels staged per step
constexpr int kChunkPad = kChunk + 1;
constexpr int kSpan = 1024;        // keys of one z-group staged in smem
constexpr int kMaxTaps = 27;

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

// CN = cout / 16 output channels per thread
template <int CN>
__global__ void __launch_bounds__(kThreads)
    sparse_conv3d_kernel(const int* __restrict__ qbase,
                         const int* __restrict__ in_keys,
                         const float* __restrict__ feats,
                         const float* __restrict__ weights,
                         const float* __restrict__ shift,
                         float* __restrict__ out, int vq, int vin, int cin,
                         int D, int H, int W, int ksize, int relu) {
  constexpr int kCout = 16 * CN;
  __shared__ int s_keys[3 * kSpan];
  __shared__ int s_nbr[kMaxTaps * kTile];     // [tap][row]
  __shared__ float s_in[kTile * kChunkPad];   // [row][channel]
  __shared__ float s_w[kChunk * kCout];       // [channel][out channel]
  __shared__ int s_lo[3], s_hi[3];
  __shared__ int s_hit[kMaxTaps];
  __shared__ int s_qmin, s_qmax, s_nvalid;

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kTile;
  const int nrows = min(kTile, vq - row0);
  const int hw = H * W;
  const int dhw = D * hw;
  const int ntaps = ksize == 3 ? 27 : 1;
  const int nz = ksize == 3 ? 3 : 1;
  const int* qb = qbase + static_cast<size_t>(b) * vq + row0;
  const int* kb = in_keys + static_cast<size_t>(b) * vin;
  float* ob = out + (static_cast<size_t>(b) * vq + row0) * kCout;

  if (tid == 0) {
    s_qmin = INT_MAX;
    s_qmax = -1;
    s_nvalid = 0;
  }
  if (tid < kMaxTaps) s_hit[tid] = 0;
  __syncthreads();
  if (tid < nrows) {
    const int q = qb[tid];
    if (q >= 0 && q < dhw) {
      atomicMin(&s_qmin, q);
      atomicMax(&s_qmax, q);
      atomicAdd(&s_nvalid, 1);
    }
  }
  __syncthreads();
  if (s_nvalid == 0) {  // all padding: zero rows
    for (int f = tid; f < nrows * kCout; f += kThreads) ob[f] = 0.f;
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

  // neighbour map: s_nbr[tap][row] = row of in_keys, or -1
  for (int p = tid; p < ntaps * kTile; p += kThreads) {
    const int t = p / kTile;
    const int r = p - t * kTile;
    int nbr = -1;
    const int q = r < nrows ? qb[r] : -1;
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
          if (pos < len && sk[pos] == target) nbr = lo + pos;
        } else {
          const int pos = lower_bound(kb, lo, lo + len, target);
          if (pos < lo + len && kb[pos] == target) nbr = pos;
        }
      }
    }
    s_nbr[t * kTile + r] = nbr;
    if (nbr >= 0) s_hit[t] = 1;
  }
  __syncthreads();

  const int tr = tid / 16;  // rows tr + 16 i
  const int tc = tid % 16;  // output channels tc + 16 j
  float acc[kRowsPerThread][CN];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;
  }
  const float* fb = feats + static_cast<size_t>(b) * vin * cin;

  for (int t = 0; t < ntaps; ++t) {
    if (!s_hit[t]) continue;  // block-uniform
    const int* nb = s_nbr + t * kTile;
    for (int c0 = 0; c0 < cin; c0 += kChunk) {
      const int cw = min(kChunk, cin - c0);
      __syncthreads();  // the previous chunk's readers are done
      for (int f = tid; f < kTile * cw; f += kThreads) {
        const int r = f / cw;
        const int c = f - r * cw;
        const int idx = nb[r];
        s_in[r * kChunkPad + c] =
            idx >= 0 ? fb[static_cast<size_t>(idx) * cin + c0 + c] : 0.f;
      }
      const float* wk = weights + (static_cast<size_t>(t) * cin + c0) * kCout;
      for (int f = tid; f < cw * kCout; f += kThreads) s_w[f] = wk[f];
      __syncthreads();
      for (int c = 0; c < cw; ++c) {
        float a[kRowsPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          a[i] = s_in[(tr + 16 * i) * kChunkPad + c];
        }
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const float w = s_w[c * kCout + tc + 16 * j];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(a[i], w));
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = tr + 16 * i;
    if (r >= nrows) continue;
    const int q = qb[r];
    const bool valid = q >= 0 && q < dhw;
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int o = tc + 16 * j;
      float v = acc[i][j];
      if (shift != nullptr) v = __fadd_rn(v, shift[o]);
      if (relu) v = fmaxf(v, 0.f);
      ob[r * kCout + o] = valid ? v : 0.f;
    }
  }
}

template <int CN>
cudaError_t launch(const int* qbase, const int* in_keys, const float* feats,
                   const float* weights, const float* shift, float* out,
                   int b, int vq, int vin, int cin, int D, int H, int W,
                   int ksize, int relu, cudaStream_t stream) {
  const dim3 grid((vq + kTile - 1) / kTile, b);
  sparse_conv3d_kernel<CN><<<grid, kThreads, 0, stream>>>(
      qbase, in_keys, feats, weights, shift, out, vq, vin, cin, D, H, W,
      ksize, relu);
  return cudaGetLastError();
}

}  // namespace

// qbase [b, vq] int32 sorted ascending per row (padding >= D*H*W);
// in_keys [b, vin] int32 sorted ascending per row, distinct (padding keys
// >= D*H*W); feats [b, vin, cin] f32; weights [ksize^3 * cin, cout] f32;
// shift [cout] f32 or null; out [b, vq, cout] f32, every row written.
// cout must be a multiple of 16 up to 128, ksize 1 or 3. Returns
// cudaGetLastError() of the launch.
extern "C" int p3d_sparse_conv3d(const int* qbase, const int* in_keys,
                                 const float* feats, const float* weights,
                                 const float* shift, float* out, int b,
                                 int vq, int vin, int cin, int cout, int D,
                                 int H, int W, int ksize, int relu,
                                 void* stream) {
  if ((ksize != 1 && ksize != 3) || cout % 16 != 0 || cout < 16 ||
      cout > 128 || cin < 1 || vin < 1 || D < 1 || H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || vq == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define P3D_CONV_CASE(CN)                                                   \
  case CN:                                                                  \
    err = launch<CN>(qbase, in_keys, feats, weights, shift, out, b, vq, vin, \
                     cin, D, H, W, ksize, relu, s);                         \
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
