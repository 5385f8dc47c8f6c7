// All-pairs intersection area of convex quadrilaterals (K11).
//
//   area[b, i, j] = area(A[b, i] ∩ B[b, j]),  A [b, n, 4, 2], B [b, m, 4, 2]
//                   (CCW corners, f32), 0 where the pair provably does not
//                   overlap (circumscribed-circle guard)
//
// Replaces the TPU kernel paddle3d_tpu/ops/pallas/iou_clip.py:
// _clip_area_kernel (entry pairwise_intersection_area_pallas), which computes
// the XLA slot-list clip of paddle3d_tpu/ops/iou3d_nms.py:
// _pairwise_intersection_area. The TPU body tiles (8, 128) pairs on the
// vector unit and ping-pongs the growing polygon through 2 x 128 rows of VMEM
// scratch because an unrolled SSA form spilled. None of that is carried over.
//
// The function: a no-compaction Sutherland-Hodgman clip of A by B's four
// edges. A stage emits exactly two slots per input slot (4 -> 8 -> 16 -> 32
// -> 64): the start vertex, or its orthogonal projection onto the clip line
// when it lies outside, and the edge's crossing with the line when there is
// one (else the first slot again). Collinear excursions telescope in the
// shoelace sum, which runs over the 64 final slots; the area is 0.5 |sum|.
//
// What bounds it on the H100: operations. A pair reads 64 bytes of corners
// (staged once per block) and writes 4; the clip is about 30 f32 operations
// a slot over 60 slots plus a 64-term shoelace, some 2,150 a pair with the
// guard's 71. Pairs the guard rules out need only the guard, and the kernel
// leaves right after it: in an NMS-sized all-pairs call most pairs are far
// apart.
//
// Design, the simple form first: one thread per (i, j) pair, a block of
// 32 B boxes x 4 A boxes whose corners are staged in shared memory, the
// polygon slots in two halves of 128 floats per coordinate (ping-pong, as
// the TPU scratch), the batch on the grid's z axis. The slot loops have
// constant trip counts, so once they unroll every slot index is a constant
// and ptxas keeps the slots in registers (154 a thread on sm_90a, no local
// memory, no spills).
//
// Rounding: the result feeds IoU thresholds (fg >= 0.55, hard bg in
// [0.1, 0.55), soft labels), where a last bit decides which RoI is sampled.
// So every sum, difference, product, quotient and square root is rounded on
// its own (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn: nvcc may
// not contract them into fused multiply-adds) in the order of the plain
// PyTorch version, ops/iou_clip.pairwise_intersection_area_plain, whose
// results this kernel equals bit for bit. Maxima propagate NaN as
// torch.maximum does; selects and the < eps branches follow its where()s.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileM = 32;    // B boxes a block (threadIdx.x)
constexpr int kTileN = 4;     // A boxes a block (threadIdx.y)
constexpr int kSlots = 64;    // polygon slots after the fourth clip
constexpr float kEps = 1e-7f;

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
// torch.maximum: NaN if either operand is NaN
__device__ __forceinline__ float maxn(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// centre ((x0 + x1) + x2) + x3) * 0.25 and circumradius max_j |c_j - centre|
__device__ __forceinline__ void circle(const float* q, float& cx, float& cy,
                                       float& r) {
  cx = mul(add(add(add(q[0], q[2]), q[4]), q[6]), 0.25f);
  cy = mul(add(add(add(q[1], q[3]), q[5]), q[7]), 0.25f);
  r = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float dx = sub(q[2 * j], cx);
    const float dy = sub(q[2 * j + 1], cy);
    r = maxn(r, __fsqrt_rn(add(mul(dx, dx), mul(dy, dy))));
  }
}

__device__ float clip_area(const float* a, const float* b) {
  float ax, ay, ra, bx, by, rb;
  circle(a, ax, ay, ra);
  circle(b, bx, by, rb);
  const float cdx = sub(ax, bx);
  const float cdy = sub(ay, by);
  const float dist = __fsqrt_rn(add(mul(cdx, cdx), mul(cdy, cdy)));
  if (!(dist <= add(ra, rb))) return 0.f;

  float px[2 * kSlots], py[2 * kSlots];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    px[j] = a[2 * j];
    py[j] = a[2 * j + 1];
  }
  int base_in = 0;
  for (int e = 0; e < 4; ++e) {
    const float lx = b[2 * e];
    const float ly = b[2 * e + 1];
    const int e1 = (e + 1) & 3;
    const float dxe = sub(b[2 * e1], lx);
    const float dye = sub(b[2 * e1 + 1], ly);
    const float inv_d2 =
        __fdiv_rn(1.f, maxn(add(mul(dxe, dxe), mul(dye, dye)), kEps));
    const int k = 4 << e;
    const int base_out = kSlots - base_in;
    for (int i = 0; i < k; ++i) {
      const int nx = (i + 1 == k) ? 0 : i + 1;
      const float sx = px[base_in + i];
      const float sy = py[base_in + i];
      const float ex = px[base_in + nx];
      const float ey = py[base_in + nx];
      const float ds = sub(mul(dxe, sub(sy, ly)), mul(dye, sub(sx, lx)));
      const float de = sub(mul(dxe, sub(ey, ly)), mul(dye, sub(ex, lx)));
      const bool s_in = ds >= 0.f;
      const float denom = sub(ds, de);
      const float t = __fdiv_rn(ds, fabsf(denom) < kEps ? 1.f : denom);
      const float ix = add(sx, mul(t, sub(ex, sx)));
      const float iy = add(sy, mul(t, sub(ey, sy)));
      const bool crossing = (s_in != (de >= 0.f)) && (fabsf(denom) >= kEps);
      // orthogonal projection of the start vertex onto the clip line
      const float tp =
          mul(add(mul(sub(sx, lx), dxe), mul(sub(sy, ly), dye)), inv_d2);
      const float sax = s_in ? sx : add(lx, mul(tp, dxe));
      const float say = s_in ? sy : add(ly, mul(tp, dye));
      px[base_out + 2 * i] = sax;
      py[base_out + 2 * i] = say;
      px[base_out + 2 * i + 1] = crossing ? ix : sax;
      py[base_out + 2 * i + 1] = crossing ? iy : say;
    }
    base_in = base_out;
  }
  float acc = 0.f;
  for (int i = 0; i < kSlots; ++i) {
    const int nx = (i + 1) & (kSlots - 1);
    acc = add(acc, sub(mul(px[base_in + i], py[base_in + nx]),
                       mul(px[base_in + nx], py[base_in + i])));
  }
  return mul(0.5f, fabsf(acc));
}

__global__ void __launch_bounds__(kTileM * kTileN)
pairwise_area_kernel(const float* __restrict__ ca,
                     const float* __restrict__ cb, float* __restrict__ out,
                     int n, int m) {
  __shared__ float s_a[kTileN][8];
  __shared__ float s_b[kTileM][8];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kTileN;
  const int j0 = blockIdx.x * kTileM;
  const int tid = threadIdx.y * kTileM + threadIdx.x;
  const float* qa = ca + (static_cast<size_t>(b) * n + i0) * 8;
  const float* qb = cb + (static_cast<size_t>(b) * m + j0) * 8;
  for (int t = tid; t < kTileM * 8; t += kTileM * kTileN) {
    if (j0 + t / 8 < m) s_b[t / 8][t % 8] = qb[t];
  }
  if (tid < kTileN * 8 && i0 + tid / 8 < n) s_a[tid / 8][tid % 8] = qa[tid];
  __syncthreads();
  const int i = i0 + threadIdx.y;
  const int j = j0 + threadIdx.x;
  if (i >= n || j >= m) return;
  float a[8], q[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    a[c] = s_a[threadIdx.y][c];
    q[c] = s_b[threadIdx.x][c];
  }
  out[(static_cast<size_t>(b) * n + i) * m + j] = clip_area(a, q);
}

}  // namespace

// ca [b, n, 4, 2] and cb [b, m, 4, 2] f32 contiguous (CCW corners); out
// [b, n, m] f32, every element written. Returns cudaGetLastError().
extern "C" int p3d_pairwise_intersection_area(const float* ca, const float* cb,
                                              float* out, int b, int n, int m,
                                              void* stream) {
  if (b < 0 || n < 0 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || n == 0 || m == 0) return static_cast<int>(cudaSuccess);
  if (b > 65535 || (n + kTileN - 1) / kTileN > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((m + kTileM - 1) / kTileM, (n + kTileN - 1) / kTileN, b);
  const dim3 block(kTileM, kTileN);
  pairwise_area_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      ca, cb, out, n, m);
  return static_cast<int>(cudaGetLastError());
}
