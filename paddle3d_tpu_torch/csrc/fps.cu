// Masked farthest-point sampling (K10): idx[b, 0] is the first valid point
// of scan b (0 when it has none), and idx[b, k] the lowest index among the
// points whose squared distance to the picks idx[b, :k] is largest; an
// invalid point is never picked (its distance is pinned at -1).
//
// Replaces the TPU kernel paddle3d_tpu/ops/pallas/fps.py:_kernel (entry
// _fps_tpu, reached through farthest_point_sample_batched). That body keeps
// the scan in VMEM as (8, N/8) tiles, finds the last pick's coordinates by
// a masked sum (it cannot gather) and marks invalid points with a far-away
// coordinate; none of that is carried over.
//
// What bounds it on the H100: neither bytes nor operations but a chain of
// npoint - 1 dependent steps, each a sweep over the scan's points followed
// by an argmax over all of them. The bytes moved once are the scan and
// npoint ints; the operations 10 a point a step. A step's time is the
// sweep of one CTA's share of the points plus the latency of the argmax
// across the CTAs that share the scan: that latency, paid npoint - 1 times,
// is the floor (chip_smoke.py measures it with one point a thread).
//
// Design: one thread-block cluster of C CTAs (512 threads each) per scan,
// launched with cudaLaunchKernelEx and a cluster dimension, C in {1, 2, 4,
// 8, 16} (16 is a non-portable size). Each CTA owns a contiguous span of
// PPT * 512 points and loads them once, before the first pick: x / y / z
// and the running d2 in registers (PPT a template parameter, so that the
// arrays never leave the register file), and x / y / z again in shared
// memory, where the CTA's best point is looked up by index. No step reads
// device memory. A step:
//   1. each thread updates d2 = min(d2, |p - last|^2) for its valid points
//      and keeps its best (d2, index);
//   2. a warp reduces its 32 bests with two redux.sync (the largest
//      order-preserving key of the distance, then the lowest index among
//      the lanes that hold it); after one __syncthreads every warp reduces
//      the 16 warps' bests to the CTA's;
//   3. lane r of warp 0 pushes the CTA's record (key, index, x, y, z) into
//      slot [k & 1][rank] of CTA r with st.async, whose bytes complete the
//      transaction count of CTA r's mbarrier [k & 1];
//   4. every thread waits on its own CTA's mbarrier [k & 1] (phase parity
//      (k >> 1) & 1), which completes when the C records' bytes are in,
//      and thread 0 at once arms it (arrive.expect_tx of C records) for
//      step k + 2;
//   5. every warp reduces the C records from its own shared memory; the
//      winner's coordinates arrive with its record, so nothing is gathered
//      from device memory.
// No step waits on a cluster barrier or a fence: the first builds waited
// on barrier.cluster, then on an mbarrier arrival with release semantics,
// then polled tagged records (relaxed, or release / acquire), and each of
// those chains cost more than the asynchronous stores. With C = 1, steps
// 3 to 5 fall away: the step is one __syncthreads. The order "larger d2,
// then lower index" is associative and commutative, so any reduction order
// gives the plain version's pick.
//
// Invariants. One writer a slot: only CTA r writes slot [.][r] of another
// CTA. Slot reuse: CTA r writes slot [k & 1][r] of CTA q again at step
// k + 2 only after its own barrier completed step k + 1, which needs CTA
// q's record of step k + 1; CTA q's warp 0 pushes it after the
// __syncthreads of step k + 1, which none of CTA q's warps reaches before
// it has read the records of step k. The same chain keeps a barrier from
// running two phases ahead of a waiter, so waiting on the phase parity is
// exact, and the phase for step k + 2 can be armed as soon as step k's
// completes (bytes that land before the arming leave the count negative
// until then, which the barrier allows). Exit: a last cluster barrier after
// the last step keeps every CTA (and its shared memory) alive until no
// other CTA can push to it. A failed cluster launch
// (cudaErrorClusterOutOfResources, say) is returned as the error; there is
// no other kernel to fall back on.
//
// Cluster size (`choose`): one CTA when it holds the scan at 8 points a
// thread or fewer (its step has no hop between SMs); else the smallest C
// that holds it at 4 points a thread or fewer and whose B clusters can all
// be resident with an SM for each CTA (cudaOccupancyMaxActiveClusters,
// asked at a shared-memory size that leaves room for one CTA an SM: H100's
// GPCs do not hold many clusters of 16); else the fewest points a thread
// among the sizes that fit so; else the largest C that holds the scan on
// chip, its clusters in waves. The occupancy answers and the kernel's
// function attributes hold for one device: each device keeps its own,
// under one lock. Scans longer than 16 CTAs x 512 threads x
// 16 points, or with no cluster size resident, take the scratch path: one
// block of 1,024 threads per scan that keeps d2 in a [B, N] buffer in
// device memory and re-reads the coordinates each step.
//
// The squared distance is (dx*dx + dy*dy) + dz*dz with every product and
// sum rounded on its own (__fmul_rn, __fadd_rn: no fused multiply-add), the
// order of the plain PyTorch version: an index-valued function, so a last
// bit is a different answer.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <map>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;            // threads of a cluster CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kScratchThreads = 1024;    // threads of a scratch-path block
constexpr float kBig = 1e10f;
// points a thread holds, the instantiated register-array sizes
constexpr int kPpts[] = {1, 2, 3, 4, 5, 6, 8, 10, 12, 16};
constexpr int kNumPpts = sizeof(kPpts) / sizeof(kPpts[0]);

struct Best {
  float d;
  int i;
};

__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.d > a.d || (b.d == a.d && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ Best warp_best(Best v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    Best o;
    o.d = __shfl_xor_sync(0xffffffffu, v.d, s);
    o.i = __shfl_xor_sync(0xffffffffu, v.i, s);
    v = better(v, o);
  }
  return v;
}

__device__ __forceinline__ float dist2(float px, float py, float pz,
                                       float lx, float ly, float lz) {
  const float dx = px - lx;
  const float dy = py - ly;
  const float dz = pz - lz;
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the address of the same shared variable in CTA `rank` of the cluster
__device__ __forceinline__ unsigned remote(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// a distance as an unsigned key in the same order (d finite, >= -3)
__device__ __forceinline__ unsigned order_key(float d) {
  const unsigned u = __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the warp's best (key, index): the largest key, then the lowest index;
// every lane gets it
__device__ __forceinline__ void warp_best_key(unsigned& key, unsigned& i) {
  const unsigned m = __reduce_max_sync(0xffffffffu, key);
  i = __reduce_min_sync(0xffffffffu, key == m ? i : 0xffffffffu);
  key = m;
}

// Per-CTA state of the argmax, double-buffered by step parity: the warps'
// bests of a step, the records the cluster's CTAs push here (slot r: CTA
// r's best point of the step) and the barriers that count their bytes.
struct Exchange {
  unsigned wkey[2][kWarps];
  unsigned widx[2][kWarps];
  float4 rec[2][kMaxCluster];   // (key bits, index bits, x, y)
  float recz[2][kMaxCluster];
  unsigned long long bar[2];
};

// bytes a CTA's record puts into each CTA of the cluster
constexpr unsigned kRecordBytes = sizeof(float4) + sizeof(float);

// arm the barrier's current phase for the C records of a step
__device__ __forceinline__ void arm(unsigned long long* bar, int C) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(C * kRecordBytes) : "memory");
}

// The cluster's best of the threads' `mine` at step k: -> its index, and
// its coordinates in (lx, ly, lz). Every thread of every CTA of the cluster
// calls it, at every step.
__device__ __forceinline__ unsigned cluster_best(
    Best mine, int k, int span, const float* sx, const float* sy,
    const float* sz, Exchange& ex, int C, int rank, float& lx, float& ly,
    float& lz) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int buf = k & 1;
  unsigned key = order_key(mine.d);
  unsigned i = static_cast<unsigned>(mine.i);
  warp_best_key(key, i);
  if (lane == 0) {
    ex.wkey[buf][warp] = key;
    ex.widx[buf][warp] = i;
  }
  __syncthreads();
  // every warp takes the CTA's best itself
  key = lane < kWarps ? ex.wkey[buf][lane] : 0u;
  i = lane < kWarps ? ex.widx[buf][lane] : 0xffffffffu;
  warp_best_key(key, i);
  if (C == 1) {
    lx = sx[i];
    ly = sy[i];
    lz = sz[i];
    return i;
  }
  // lane r of warp 0 pushes the CTA's record to CTA r with asynchronous
  // stores that count their bytes on CTA r's barrier [k & 1]
  if (warp == 0 && lane < C) {
    const int l = static_cast<int>(i) - rank * span;
    const unsigned bar = remote(smem_addr(&ex.bar[buf]), lane);
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
        "[%0], {%1, %2, %3, %4}, [%5];\n"
        :: "r"(remote(smem_addr(&ex.rec[buf][rank]), lane)),
        "f"(__uint_as_float(key)), "f"(__uint_as_float(i)), "f"(sx[l]),
        "f"(sy[l]), "r"(bar) : "memory");
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 "
        "[%0], %1, [%2];\n"
        :: "r"(remote(smem_addr(&ex.recz[buf][rank]), lane)), "f"(sz[l]),
        "r"(bar) : "memory");
  }
  // the C records of step k are here once this CTA's barrier [k & 1]
  // completes its phase (k >> 1) & 1; then thread 0 arms the next phase
  // for step k + 2
  const unsigned bar = smem_addr(&ex.bar[buf]);
  const unsigned parity = (k >> 1) & 1;
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
  if (threadIdx.x == 0) arm(&ex.bar[buf], C);
  unsigned bk = 0u, bi = 0xffffffffu;
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  float rz = 0.f;
  if (lane < C) {
    r = ex.rec[buf][lane];
    rz = ex.recz[buf][lane];
    bk = __float_as_uint(r.x);
    bi = __float_as_uint(r.y);
  }
  const unsigned mine_i = bi;
  warp_best_key(bk, bi);
  const int src = __ffs(__ballot_sync(0xffffffffu, lane < C && mine_i == bi))
                  - 1;
  lx = __shfl_sync(0xffffffffu, r.z, src);
  ly = __shfl_sync(0xffffffffu, r.w, src);
  lz = __shfl_sync(0xffffffffu, rz, src);
  return bi;
}

// One cluster per scan (blocks [C * scan, C * scan + C)); CTA `rank` owns
// points [rank * PPT * kThreads, (rank + 1) * PPT * kThreads), point
// j * kThreads + tid of the span in registers px/py/pz/d2[j].
template <int PPT>
__global__ void __launch_bounds__(kThreads)
fps_cluster_kernel(const float* __restrict__ xyz,
                   const unsigned char* __restrict__ mask,
                   int* __restrict__ idx, int n, int npoint) {
  extern __shared__ float s_xyz[];   // [3][PPT * kThreads]
  __shared__ Exchange ex;
  const cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int scan = blockIdx.x / C;
  const int tid = threadIdx.x;
  constexpr int kSpan = PPT * kThreads;
  const int base = rank * kSpan;
  const float* pts = xyz + static_cast<size_t>(scan) * n * 3;
  const unsigned char* msk = mask + static_cast<size_t>(scan) * n;
  int* out = idx + static_cast<size_t>(scan) * npoint;
  float* sx = s_xyz;
  float* sy = sx + kSpan;
  float* sz = sy + kSpan;

  float px[PPT], py[PPT], pz[PPT], d2[PPT];
  // the first pick: the lowest valid index (d = 0), else the lowest index
  // (d = -1: no valid point); slots past the scan's end (-2) never win
  Best mine{-3.f, INT_MAX};
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int l = j * kThreads + tid;
    const int i = base + l;
    float x = 0.f, y = 0.f, z = 0.f;
    bool valid = false;
    if (i < n) {
      x = pts[3 * i];
      y = pts[3 * i + 1];
      z = pts[3 * i + 2];
      valid = msk[i] != 0;
    }
    px[j] = x;
    py[j] = y;
    pz[j] = z;
    sx[l] = x;
    sy[l] = y;
    sz[l] = z;
    d2[j] = valid ? kBig : (i < n ? -1.f : -2.f);
    mine = better(mine, Best{valid ? 0.f : (i < n ? -1.f : -2.f), i});
  }
  if (C > 1) {
    if (tid == 0) {
      for (int b = 0; b < 2; ++b) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                     :: "r"(smem_addr(&ex.bar[b])) : "memory");
        arm(&ex.bar[b], C);   // for steps 0 and 1
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // every CTA's barriers armed before any record arrives
    cluster_barrier();
  }
  float lx, ly, lz;
  // the picks are written by the CTA's last thread: no pusher waits on a
  // global store
  const bool writer = rank == 0 && tid == kThreads - 1;
  unsigned last = cluster_best(mine, 0, kSpan, sx, sy, sz, ex, C, rank, lx,
                               ly, lz);
  if (writer) out[0] = static_cast<int>(last);

  for (int k = 1; k < npoint; ++k) {
    mine = Best{-3.f, INT_MAX};
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      float d = d2[j];
      if (d >= 0.f) {     // valid: invalid (-1) and padding (-2) stay
        d = fminf(d, dist2(px[j], py[j], pz[j], lx, ly, lz));
        d2[j] = d;
      }
      if (d > mine.d) {   // ascending index: ties keep the lower one
        mine.d = d;
        mine.i = base + j * kThreads + tid;
      }
    }
    last = cluster_best(mine, k, kSpan, sx, sy, sz, ex, C, rank, lx, ly,
                        lz);
    if (writer) out[k] = static_cast<int>(last);
  }
  // no CTA leaves while another may still push to it or read it
  if (C > 1) cluster_barrier();
}

// The scratch path: one block per scan, d2 of point i in scratch[b * n + i]
__global__ void __launch_bounds__(kScratchThreads)
fps_scratch_kernel(const float* __restrict__ xyz,
                   const unsigned char* __restrict__ mask,
                   int* __restrict__ idx, float* __restrict__ scratch, int n,
                   int npoint) {
  constexpr int kW = kScratchThreads / 32;
  __shared__ float s_d[2][kW];
  __shared__ int s_i[2][kW];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float* pts = xyz + static_cast<size_t>(blockIdx.x) * n * 3;
  const unsigned char* msk = mask + static_cast<size_t>(blockIdx.x) * n;
  int* out = idx + static_cast<size_t>(blockIdx.x) * npoint;
  float* far = scratch + static_cast<size_t>(blockIdx.x) * n;

  Best mine{-1.f, n};   // d = 0 for "has a valid point"
  for (int i = tid; i < n; i += kScratchThreads) {
    const bool valid = msk[i];
    far[i] = valid ? kBig : -1.f;
    if (valid && mine.i == n) mine = Best{0.f, i};
  }
  int last = 0;
  for (int k = 0; k < npoint; ++k) {
    if (k > 0) {
      const float lx = pts[3 * last];
      const float ly = pts[3 * last + 1];
      const float lz = pts[3 * last + 2];
      mine = Best{-3.f, n};
      for (int i = tid; i < n; i += kScratchThreads) {
        float d = far[i];
        if (d >= 0.f) {
          d = fminf(d, dist2(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], lx,
                             ly, lz));
          far[i] = d;
        }
        if (d > mine.d) mine = Best{d, i};
      }
    }
    mine = warp_best(mine);
    const int buf = k & 1;
    if (lane == 0) {
      s_d[buf][warp] = mine.d;
      s_i[buf][warp] = mine.i;
    }
    __syncthreads();
    Best all{s_d[buf][lane], s_i[buf][lane]};
    all = warp_best(all);
    last = all.i < n ? all.i : 0;
    if (tid == 0) out[k] = last;
  }
}

using ClusterKernel = void (*)(const float*, const unsigned char*, int*, int,
                               int);

template <int P>
ClusterKernel instance() {
  return fps_cluster_kernel<P>;
}

ClusterKernel cluster_kernel(int slot) {
  switch (kPpts[slot]) {
    case 1: return instance<1>();
    case 2: return instance<2>();
    case 3: return instance<3>();
    case 4: return instance<4>();
    case 5: return instance<5>();
    case 6: return instance<6>();
    case 8: return instance<8>();
    case 10: return instance<10>();
    case 12: return instance<12>();
    default: return instance<16>();
  }
}

size_t smem_bytes(int slot) {
  return static_cast<size_t>(3) * kPpts[slot] * kThreads * sizeof(float);
}

// the slot of kPpts a C-CTA cluster needs for n points, or -1
int ppt_slot(int n, int cluster) {
  const long long per_thread =
      (static_cast<long long>(n) + static_cast<long long>(cluster) *
       kThreads - 1) / (static_cast<long long>(cluster) * kThreads);
  for (int s = 0; s < kNumPpts; ++s) {
    if (kPpts[s] >= per_thread) return s;
  }
  return -1;
}

cudaLaunchConfig_t config(int slot, int cluster, int b, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster) * b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(slot);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// shared memory that leaves room for one CTA on an SM: asked of the
// occupancy calculator, it counts the clusters whose CTAs each get an SM
constexpr int kAloneSmem = 120 * 1024;

// What `prepare` and `resident` learn of a device: whether the kernel's
// function attributes are set there, and its residency counts (-1: not
// asked yet). Function attributes and occupancy answer for the current
// device only, so each device keeps its own, filled under one lock.
struct DeviceState {
  bool prepared[kNumPpts] = {};
  int resident[2][kNumPpts][5];
  DeviceState() {
    for (auto& table : resident) {
      for (auto& row : table) {
        for (int& v : row) v = -1;
      }
    }
  }
};

std::mutex state_lock;

// the current device's state; call with state_lock held
DeviceState& device_state() {
  static std::map<int, DeviceState> states;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) cudaGetLastError();
  return states[dev];
}

// the kernel's function attributes, set once a device: dynamic shared
// memory past 48 KB and the non-portable cluster size 16. Call with
// state_lock held.
cudaError_t prepare(int slot) {
  bool& done = device_state().prepared[slot];
  if (done) return cudaSuccess;
  const ClusterKernel k = cluster_kernel(slot);
  const size_t smem = smem_bytes(slot);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem > kAloneSmem ? smem : kAloneSmem));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  done = err == cudaSuccess;
  return err;
}

// clusters of `cluster` CTAs that can be resident at once on the current
// device (0 when none can launch): as launched (alone false) or with one
// CTA an SM (alone true); cached per (points a thread, cluster size). Call
// with state_lock held.
int resident(int slot, int cluster, bool alone) {
  int& hit = device_state().resident[alone][slot]
                                    [__builtin_ctz(static_cast<unsigned>(
                                        cluster))];
  if (hit < 0) {
    int num = 0;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = config(slot, cluster, 1, nullptr, &attr);
    if (alone) cfg.dynamicSmemBytes = kAloneSmem;
    if (prepare(slot) != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&num, cluster_kernel(slot), &cfg) !=
            cudaSuccess) {
      cudaGetLastError();   // a size this card refuses: none resident
      num = 0;
    }
    hit = num;
  }
  return hit;
}

struct Plan {
  int cluster;   // CTAs a scan; 0: the scratch path
  int slot;      // into kPpts
};

// A step costs a sweep of a thread's points plus the argmax chain, and the
// chain across CTAs costs about as much as seven more points a thread than
// the chain inside one (chip_smoke.py logs both): one CTA when it holds
// the scan at kOnePpt points a thread; else the smallest cluster at
// kClusterPpt whose B clusters each get an SM a CTA; else the smallest
// points a thread among the clusters that do; else the largest cluster
// that holds the scan at all, in waves.
constexpr int kOnePpt = 8;
constexpr int kClusterPpt = 4;

Plan choose(int b, int n, int forced) {
  if (forced > 0) {
    const int s = ppt_slot(n, forced);
    return s < 0 ? Plan{0, -1} : Plan{forced, s};
  }
  const int one = ppt_slot(n, 1);
  if (one >= 0 && kPpts[one] <= kOnePpt && resident(one, 1, false) > 0) {
    return Plan{1, one};
  }
  for (int c = 2; c <= kMaxCluster; c *= 2) {
    const int s = ppt_slot(n, c);
    if (s >= 0 && kPpts[s] <= kClusterPpt && resident(s, c, true) >= b) {
      return Plan{c, s};
    }
  }
  for (int c = kMaxCluster; c >= 2; c /= 2) {
    const int s = ppt_slot(n, c);
    if (s >= 0 && resident(s, c, true) >= b) return Plan{c, s};
  }
  for (int c = kMaxCluster; c >= 1; c /= 2) {
    const int s = ppt_slot(n, c);
    if (s < 0) break;
    if (resident(s, c, false) > 0) return Plan{c, s};
  }
  return Plan{0, -1};
}

}  // namespace

// The plan the sampler takes for b scans of n points (cluster 0: its own
// choice, else that cluster size): plan[0] CTAs a scan (0: the scratch
// path), plan[1] points a thread, plan[2] threads a CTA, plan[3] clusters
// resident at once as launched, plan[4] clusters resident with an SM a
// CTA. Returns a CUDA error code.
extern "C" int p3d_farthest_point_sample_plan(int b, int n, int cluster,
                                              int* plan) {
  if (n < 1 || cluster < 0 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const std::lock_guard<std::mutex> hold(state_lock);
  const Plan p = choose(b, n, cluster);
  plan[0] = p.cluster;
  plan[1] = p.slot < 0 ? 0 : kPpts[p.slot];
  plan[2] = p.cluster > 0 ? kThreads : kScratchThreads;
  plan[3] = p.cluster > 0 ? resident(p.slot, p.cluster, false) : 0;
  plan[4] = p.cluster > 0 ? resident(p.slot, p.cluster, true) : 0;
  return static_cast<int>(cudaSuccess);
}

// p3d_farthest_point_sample with the cluster size given (1, 2, 4, 8 or 16;
// 0 for the sampler's own choice); a size that cannot hold the scan on
// chip is refused.
extern "C" int p3d_farthest_point_sample_cluster(
    const float* xyz, const unsigned char* mask, int* idx, float* scratch,
    int b, int n, int npoint, int cluster, void* stream) {
  if (n < 1 || npoint < 1 || cluster < 0 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Plan p;
  cudaError_t err = cudaSuccess;
  {
    const std::lock_guard<std::mutex> hold(state_lock);
    p = choose(b, n, cluster);
    if (p.cluster > 0) err = prepare(p.slot);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.cluster == 0) {
    if (cluster > 0 || scratch == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    fps_scratch_kernel<<<b, kScratchThreads, 0, s>>>(xyz, mask, idx,
                                                     scratch, n, npoint);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(p.slot, p.cluster, b, s, &attr);
  err = cudaLaunchKernelEx(&cfg, cluster_kernel(p.slot), xyz, mask, idx, n,
                           npoint);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// xyz [b, n, 3] f32, mask [b, n] bytes (0 / 1), both contiguous; idx
// [b, npoint] int32, every element written. scratch: [b, n] f32, needed
// (and touched) only on the scratch path, which scans of more than
// 8 x 512 x 16 = 65,536 points may take; else it may be null. Valid points
// must have finite coordinates. Returns the launch's CUDA error.
extern "C" int p3d_farthest_point_sample(const float* xyz,
                                         const unsigned char* mask, int* idx,
                                         float* scratch, int b, int n,
                                         int npoint, void* stream) {
  return p3d_farthest_point_sample_cluster(xyz, mask, idx, scratch, b, n,
                                           npoint, 0, stream);
}
