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
// What bounds it on the H100: latency, not work. A pair reads 64 bytes of
// corners and writes 4; the clip is some 1,580 f32 operations, and only the
// pairs that pass the guard need it (a fifth at a train step's 2 x 128 x 24
// call, 1 % at 8 x 1,000 x 1,000 clustered boxes). The card has far more
// lanes than such a call has clipped pairs, so the time is the longest
// chain a lane runs. The first design ran one pair's whole clip in one
// thread (60 dependent slots of ~22 rounded operations, an IEEE division
// among them, then a 64-add shoelace), in warps of 32 second-set boxes
// where a single pair past the guard held the other 31 lanes.
//
// Design: a block of 256 threads owns a tile of tile_n A boxes x tile_m B
// boxes (tile_m = min(m, 128), tile_n from the grid size: as many rows as
// keep at least four blocks an SM, at most 2,048 pairs). It stages the
// tile's boxes once: circles of both sets, B's four clip edges (start,
// direction, 1 / |d|^2). Then the guard runs over every pair of the tile,
// a thread a pair; a pair that fails it gets its 0 at once, and the pairs
// that pass are packed into a shared list (a ballot and a popcount a warp,
// one shared atomic a warp). The clips then go to groups of 16 lanes, two
// pairs a warp (a warp a pair was 18-22 % slower at 8 x 1,000 x 1,000 and
// no faster elsewhere), a group a listed pair at a time, so no lane waits
// on a clip that is not its own. A
// stage's slots are independent (slot i of stage e reads slots i and i + 1
// of the stage before), so they spread across the group's lanes through a
// ping-pong buffer in shared memory: the chain is four stages deep instead
// of 60 slots. The 64 shoelace terms are computed across the lanes too;
// their sum stays the plain left fold in slot order, t0 + t1 + ... + t63,
// by the group's first lane (no term is dropped).
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

constexpr int kThreads = 256;
constexpr int kMaxTileM = 128;   // B boxes a block, at most
constexpr int kMaxTileN = 64;    // A boxes a block, at most
constexpr int kMaxPairs = 2048;  // pairs a block, at most
constexpr int kSlots = 64;       // polygon slots after the fourth clip
constexpr int kMaxGrid = 65535;  // batch rows (the grid's y extent)
constexpr int kLanes = 16;      // lanes a pair's clip (two pairs a warp)
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
__device__ __forceinline__ void circle(const float* q, float* c) {
  const float cx = mul(add(add(add(q[0], q[2]), q[4]), q[6]), 0.25f);
  const float cy = mul(add(add(add(q[1], q[3]), q[5]), q[7]), 0.25f);
  float r = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float dx = sub(q[2 * j], cx);
    const float dy = sub(q[2 * j + 1], cy);
    r = maxn(r, __fsqrt_rn(add(mul(dx, dx), mul(dy, dy))));
  }
  c[0] = cx;
  c[1] = cy;
  c[2] = r;
}

// a clip edge of a B box: its start, its direction and 1 / max(|d|^2, eps)
struct Edge {
  float lx, ly, dx, dy, inv_d2;
};

// One input slot (start s, end e: the next slot) against one clip edge:
// its two output slots.
__device__ __forceinline__ void clip_slot(float sx, float sy, float ex,
                                          float ey, const Edge& l,
                                          float* ox, float* oy) {
  const float ds = sub(mul(l.dx, sub(sy, l.ly)), mul(l.dy, sub(sx, l.lx)));
  const float de = sub(mul(l.dx, sub(ey, l.ly)), mul(l.dy, sub(ex, l.lx)));
  const bool s_in = ds >= 0.f;
  const float denom = sub(ds, de);
  const float t = __fdiv_rn(ds, fabsf(denom) < kEps ? 1.f : denom);
  const float ix = add(sx, mul(t, sub(ex, sx)));
  const float iy = add(sy, mul(t, sub(ey, sy)));
  const bool crossing = (s_in != (de >= 0.f)) && (fabsf(denom) >= kEps);
  // orthogonal projection of the start vertex onto the clip line
  const float tp = mul(add(mul(sub(sx, l.lx), l.dx), mul(sub(sy, l.ly), l.dy)),
                       l.inv_d2);
  const float sax = s_in ? sx : add(l.lx, mul(tp, l.dx));
  const float say = s_in ? sy : add(l.ly, mul(tp, l.dy));
  ox[0] = sax;
  oy[0] = say;
  ox[1] = crossing ? ix : sax;
  oy[1] = crossing ? iy : say;
}

// One pair's clip by a group of kLanes lanes (`lane` in [0, kLanes),
// `mask` the group's lanes). a: A's corners (x0, y0, ..., x3, y3); l: B's four edges;
// buf: the group's 5 x 64 floats (two ping-pong slot buffers, x then y,
// and the shoelace terms). -> the area, in lane 0.
__device__ float clip_area(const float* a, const Edge* l, float* buf,
                           int lane, unsigned mask) {
  float* terms = buf + 4 * kSlots;
  // stage 0: the four corners -> buffer 0
  if (lane < 4) {
    const int nx = (lane + 1) & 3;
    clip_slot(a[2 * lane], a[2 * lane + 1], a[2 * nx], a[2 * nx + 1], l[0],
              buf + 2 * lane, buf + kSlots + 2 * lane);
  }
  __syncwarp(mask);
#pragma unroll
  for (int e = 1; e < 4; ++e) {
    const int k = 4 << e;
    const float* ix = buf + ((e - 1) & 1) * 2 * kSlots;
    const float* iy = ix + kSlots;
    float* ox = buf + (e & 1) * 2 * kSlots;
    float* oy = ox + kSlots;
    const Edge edge = l[e];
#pragma unroll
    for (int i = lane; i < k; i += kLanes) {
      const int nx = (i + 1) & (k - 1);
      clip_slot(ix[i], iy[i], ix[nx], iy[nx], edge, ox + 2 * i, oy + 2 * i);
    }
    __syncwarp(mask);
  }
  // the 64 final slots lie in buffer 1
  const float* px = buf + 2 * kSlots;
  const float* py = px + kSlots;
#pragma unroll
  for (int i = lane; i < kSlots; i += kLanes) {
    const int nx = (i + 1) & (kSlots - 1);
    terms[i] = sub(mul(px[i], py[nx]), mul(px[nx], py[i]));
  }
  __syncwarp(mask);
  float area = 0.f;
  if (lane == 0) {
    // the plain version's fold: acc = t0, then acc + t1, ..., acc + t63
    const float4* t4 = reinterpret_cast<const float4*>(terms);
    float4 q = t4[0];
    float acc = add(add(add(q.x, q.y), q.z), q.w);
#pragma unroll
    for (int i = 1; i < kSlots / 4; ++i) {
      q = t4[i];
      acc = add(add(add(add(acc, q.x), q.y), q.z), q.w);
    }
    area = mul(0.5f, fabsf(acc));
  }
  // buffers 0 and 1 are rewritten by the next pair's first stages only
  // after every lane has passed this pair's last barrier; the terms are
  // rewritten after three more barriers lane 0 takes part in
  return area;
}

__global__ void __launch_bounds__(kThreads)
pairwise_area_kernel(const float* __restrict__ ca,
                     const float* __restrict__ cb, float* __restrict__ out,
                     int n, int m, int tile_n, int tile_m, int tiles_m) {
  constexpr int kGroups = kThreads / kLanes;
  __shared__ float s_a[kMaxTileN][8];       // A corners
  __shared__ float s_ac[kMaxTileN][3];      // A circles
  __shared__ float s_bc[kMaxTileM][3];      // B circles
  __shared__ Edge s_edge[kMaxTileM][4];     // B clip edges
  __shared__ unsigned short s_list[kMaxPairs];
  __shared__ __align__(16) float s_buf[kGroups][5 * kSlots];
  __shared__ int s_count;

  const int b = blockIdx.y;
  const int i0 = (blockIdx.x / tiles_m) * tile_n;
  const int j0 = (blockIdx.x % tiles_m) * tile_m;
  const int nn = min(tile_n, n - i0);
  const int mm = min(tile_m, m - j0);
  const int tid = threadIdx.x;
  const float* qa = ca + (static_cast<size_t>(b) * n + i0) * 8;
  const float* qb = cb + (static_cast<size_t>(b) * m + j0) * 8;
  for (int t = tid; t < nn; t += kThreads) {
    float q[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) q[c] = qa[t * 8 + c];
#pragma unroll
    for (int c = 0; c < 8; ++c) s_a[t][c] = q[c];
    circle(q, s_ac[t]);
  }
  for (int t = tid; t < mm; t += kThreads) {
    float q[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) q[c] = qb[t * 8 + c];
    circle(q, s_bc[t]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int e1 = (e + 1) & 3;
      Edge l;
      l.lx = q[2 * e];
      l.ly = q[2 * e + 1];
      l.dx = sub(q[2 * e1], l.lx);
      l.dy = sub(q[2 * e1 + 1], l.ly);
      l.inv_d2 = __fdiv_rn(1.f, maxn(add(mul(l.dx, l.dx), mul(l.dy, l.dy)),
                                     kEps));
      s_edge[t][e] = l;
    }
  }
  if (tid == 0) s_count = 0;
  __syncthreads();

  // the guard over every pair: 0 where it fails, the others listed
  float* ob = out + (static_cast<size_t>(b) * n + i0) * m + j0;
  const int pairs = nn * mm;
  const int lane32 = tid & 31;
  for (int p0 = 0; p0 < pairs; p0 += kThreads) {
    const int p = p0 + tid;
    bool pass = false;
    if (p < pairs) {
      const int ti = p / mm;
      const int tj = p - ti * mm;
      const float cdx = sub(s_ac[ti][0], s_bc[tj][0]);
      const float cdy = sub(s_ac[ti][1], s_bc[tj][1]);
      const float dist = __fsqrt_rn(add(mul(cdx, cdx), mul(cdy, cdy)));
      pass = dist <= add(s_ac[ti][2], s_bc[tj][2]);
      if (!pass) ob[static_cast<size_t>(ti) * m + tj] = 0.f;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, pass);
    if (ballot != 0u) {
      const int leader = __ffs(ballot) - 1;
      int base = 0;
      if (lane32 == leader) base = atomicAdd(&s_count, __popc(ballot));
      base = __shfl_sync(0xffffffffu, base, leader);
      if (pass) {
        s_list[base + __popc(ballot & ((1u << lane32) - 1u))] =
            static_cast<unsigned short>(p);
      }
    }
  }
  __syncthreads();

  // the listed pairs' clips, a group of kLanes lanes a pair
  const int count = s_count;
  const int group = tid / kLanes;
  const int lane = tid % kLanes;
  const unsigned mask = ((1u << kLanes) - 1u) << (lane32 / kLanes * kLanes);
  float* buf = s_buf[group];
  for (int q = group; q < count; q += kGroups) {
    const int p = s_list[q];
    const int ti = p / mm;
    const int tj = p - ti * mm;
    const float area = clip_area(s_a[ti], s_edge[tj], buf, lane, mask);
    if (lane == 0) ob[static_cast<size_t>(ti) * m + tj] = area;
  }
}

// The SM count of the current device (cached per device).
cudaError_t sm_count(int* sms) {
  static int cache[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cache[dev] > 0) {
    *sms = cache[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < 64) cache[dev] = *sms;
  return err;
}

}  // namespace

// ca [b, n, 4, 2] and cb [b, m, 4, 2] f32 contiguous (CCW corners); out
// [b, n, m] f32, every element written; b <= 65,535. Returns
// cudaGetLastError().
extern "C" int p3d_pairwise_intersection_area(const float* ca, const float* cb,
                                              float* out, int b, int n, int m,
                                              void* stream) {
  if (b < 0 || n < 0 || m < 0 || b > kMaxGrid) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || n == 0 || m == 0) return static_cast<int>(cudaSuccess);
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tile_m = m < kMaxTileM ? m : kMaxTileM;
  const int tiles_m = (m + tile_m - 1) / tile_m;
  // as many A rows a tile as keep at least four blocks an SM
  const int most = kMaxPairs / tile_m < kMaxTileN ? kMaxPairs / tile_m
                                                  : kMaxTileN;
  const long long rows =
      static_cast<long long>(b) * n * tiles_m / (4LL * sms);
  const int tile_n =
      rows < 1 ? 1 : (rows > most ? most : static_cast<int>(rows));
  const long long tiles =
      static_cast<long long>((n + tile_n - 1) / tile_n) * tiles_m;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), b);
  pairwise_area_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      ca, cb, out, n, m, tile_n, tile_m, tiles_m);
  return static_cast<int>(cudaGetLastError());
}

