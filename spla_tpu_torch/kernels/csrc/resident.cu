// Kernel 6: a whole BFS, or a whole SSSP (Bellman-Ford with the reference's
// feedback rule, src/algorithm.cpp:158-229), in one persistent cooperative
// launch.
//
// Replaces spla_tpu/pallas/spmv.py _resident_call (:2659, pallas_call :2696,
// kernel _make_resident_kernel :2462), reached through bfs_resident (:2709)
// and sssp_resident (:2716).  The TPU kernel keeps packed pair tiles, the
// result, the frontier and a hit accumulator in VMEM and runs the level loop
// inside one grid step; its pattern pairs, S-tables, window bitmasks and
// 24-bit activity words exist because the TPU cannot gather.  Here the graph
// is plain CSR(A), walked in the push direction, and the frontier is a
// compacted queue.
//
// What a round computes.  Round r walks the queue of round r: for each
// queued vertex i and each entry (i, j) of its row,
//   * BFS claims j with atomicCAS(v[j], 0, r + 1), so the depths do not
//     depend on the order of the claims;
//   * SSSP lowers d[j] to d[i] + w with an integer atomic on the float bits,
//     split by sign as kernel 2 does (exact for negatives and +-inf; the
//     caller routes non-finite weights elsewhere, so no NaN reaches it).  A
//     vertex lowered in round r enters the round-(r + 1) queue once: the
//     first lowering of the round wins atomicMax(stamp[j], r + 1).  A stamp
//     needs no clearing, and a lowering that races with j's pop in round
//     r + 1 queues j again for round r + 2, so no decrease is lost.  A round
//     may see decreases made earlier in the same round, so the round count
//     can be below the level loop's; the distances are the same least
//     fixpoint of d[j] = min(d[j], d[i] + w) (IEEE addition is monotone),
//     bit for bit;
// and a claimed or lowered j is appended to the next queue.  Three tail
// counters rotate: in round r one is read (the size of the queue being
// walked), one is filled (the next queue) and one is zeroed (the queue
// after that), so no second barrier resets a tail.  Both kinds stop when
// the queue is empty or after n + 2 rounds, the counterpart of the TPU
// kernel's max_iters, which ends a negative cycle.
//
// Bound.  A road-class graph has ~2 * side rounds of at most a few thousand
// vertices of degree <= 4, and its CSR and state fit the 50 MB L2.  A round
// then costs its chain of dependent L2 accesses (the count, the queue slot,
// indptr, cols, the vertex word, its atomic, the tail's atomic) plus the
// barrier that ends it; the bytes (a few KB) do not matter.  The first
// design ended every round with a barrier of the whole grid, 1,056 CTAs of
// 256 threads, and paid ~4.5 us a round whatever its work (PERF.md).  This
// design keeps one cooperative launch and splits the rounds by width:
//   * a team of G lanes walks each queued vertex, G the least power of two
//     from 2 to 32 at or above half the mean out-degree (kernel 1's rule,
//     kernels/spmv.py team_size; an instance per G): 2 on the road grids,
//     where a warp per vertex left 28 of 32 lanes idle, 8 on degree-16
//     graphs.  Each lane issues kEntries column loads, then their atomics,
//     before the warp appends what it claimed with one atomicAdd on the
//     tail.  A wide round reads the vertex words between the two, so that
//     its ~10^6 atomics go only to vertices they may change; a narrow round
//     skips that link of its chain;
//   * narrow rounds, whose queue holds at most T vertices, run on the lead
//     group alone: the first thread block cluster of kLeadCtas CTAs, which
//     ends each such round at the hardware cluster barrier.  T is the
//     group's teams, kLeadCtas * kResidentThreads / G (kernels/resident.py
//     resident_plan), so a narrow round is one pass of the group.  The
//     queues and tails stay in global memory, since a wide round's CTAs
//     outside the cluster read them;
//   * the other CTAs wait on an epoch word in global memory, one thread a
//     CTA, with ld.acquire.gpu and a __nanosleep back-off, so that their
//     polling does not crowd the lead group's L2 traffic.  When a round's
//     count exceeds T, the lead group's first thread publishes the round
//     there (a fence, then st.release.gpu: the lead group's plain queue
//     stores, ordered by the cluster or grid barrier before it, are then
//     visible to every CTA); every CTA walks the queue, and a grid barrier
//     ends the round.  Every wide round is published, and a CTA outside the
//     lead cluster goes back to waiting after each grid barrier: it reads a
//     count only once the epoch names that count's round.  The lead zeroes
//     a tail in the round after the one that read it, which for a wide
//     round comes after the grid barrier the waiting CTA must join, so the
//     count it reads cannot be zeroed or refilled under it however late it
//     wakes.  (Reading the next count straight after a grid barrier would
//     race: a CTA more than one narrow round late reads a zeroed or later
//     tail, and then leaves early or meets a grid barrier alone.)  When the
//     lead group leaves, it publishes "done" (INT_MAX), and the waiting
//     CTAs leave too;
//   * the wide path exists for graphs under the byte budget whose frontiers
//     reach ~10^5 vertices, such as random_graph(2**18, 16), about 21 MB,
//     which the gate sends here: one group of 8 SMs would walk such a round
//     ~16 times slower than the grid;
//   * fewer, larger CTAs: 1024 threads, at the occupancy limit in whole
//     clusters (cudaOccupancyMaxActiveClusters), so a wide round's barrier
//     counts ~8x fewer arrivals than the first design's.  The grid is
//     asked once per instance and device;
//   * one thread a CTA reads each round's count and hands it on through
//     shared memory, so a round costs the L2 one read a CTA, not one a warp;
//     meanwhile every lead lane loads its first queue slot, whether or not
//     the count will reach it, which takes another link off a narrow
//     round's chain.
// Vertices, queue slots and counters that other SMs write during the launch
// are read through L2 (__ldcg); the CSR arrays are read-only (__ldg).
// stats[0] = the rounds run, stats[1] = 1 when the cap stopped a non-empty
// queue, stats[2] = the rounds that ran on the whole grid.
//
// The launch is cooperative (cudaLaunchAttributeCooperative) with clusters
// of kLeadCtas (cudaLaunchAttributeClusterDimension) through
// cudaLaunchKernelEx: a grid barrier, and CTAs that spin on the epoch word,
// are valid only when every CTA is resident, which the cooperative launch
// guarantees or refuses; a refused launch raises in the wrapper.

#include <climits>
#include <cooperative_groups.h>

#include "semiring.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kResidentThreads = 1024;  // kept equal to kernels/resident.py CTA_THREADS
constexpr int kLeadCtas = 8;            // kept equal to kernels/resident.py LEAD_CTAS
constexpr int kWarps = kResidentThreads / 32;
constexpr int kEntries = 4;  // entries of a row a lane issues before it uses any
constexpr int32_t kDone = INT_MAX;  // the epoch word once the run is over
constexpr unsigned kMaxSleepNs = 512;

struct ResidentArgs {
  int32_t n, source;
  int32_t wide_above;  // T: a round whose queue holds more runs on the whole grid
  const int32_t* indptr;
  const int32_t* cols;
  const float* values;  // SSSP only
  void* result;         // BFS: int32 depths, zero; SSSP: f32 distances, +inf
  int32_t* stamp;       // SSSP only: [n], zero
  int32_t* q0;          // [n]
  int32_t* q1;          // [n]
  int32_t* cnt;         // [4], zero: three tails, then the epoch word
  int32_t* stats;       // [3]
};

__device__ __forceinline__ int32_t ld_acquire(const int32_t* p) {
  int32_t v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int32_t* p, int32_t v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The epoch word once it reaches `at_least` (one thread of a waiting CTA).
__device__ int32_t wait_epoch(const int32_t* epoch, int32_t at_least) {
  unsigned ns = 32;
  int32_t e;
  while ((e = ld_acquire(epoch)) < at_least) {
    __nanosleep(ns);
    if (ns < kMaxSleepNs) ns *= 2;
  }
  return e;
}

// d = min(d, x) for a non-NaN x; returns the old value.
__device__ __forceinline__ float atomic_min_float(float* addr, float x) {
  if (!(__float_as_uint(x) >> 31))
    return __int_as_float(atomicMin(reinterpret_cast<int*>(addr), __float_as_int(x)));
  return __uint_as_float(atomicMax(reinterpret_cast<unsigned*>(addr), __float_as_uint(x)));
}

// Reserve this warp's slots in `next` for the entries its lanes want, with
// one atomicAdd, and store them.
__device__ __forceinline__ void append(const bool (&want)[kEntries], const int32_t (&j)[kEntries],
                                       int32_t* next, int32_t* tail, int lane) {
  unsigned m[kEntries];
  int total = 0;
#pragma unroll
  for (int u = 0; u < kEntries; ++u) {
    m[u] = __ballot_sync(kFullMask, want[u]);
    total += __popc(m[u]);
  }
  if (total == 0) return;
  int32_t base = 0;
  if (lane == 0) base = atomicAdd(tail, total);
  base = __shfl_sync(kFullMask, base, 0);
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int u = 0; u < kEntries; ++u) {
    if (want[u]) next[base + __popc(m[u] & below)] = j[u];
    base += __popc(m[u]);
  }
}

// Walk round `round`'s queue of `count` vertices with `nwarps` warps, this
// one `warp`: 32 / G vertices a warp at a time, a team of G lanes each.  A
// NARROW round (the lead cluster's) takes the vertex of this lane's first
// queue slot from `head`, loaded beside the count, and claims or lowers
// without reading the vertex word first; a wide one reads it first, so that
// its many atomics go only to vertices it may change.
template <bool SSSP, int G, bool NARROW>
__device__ __forceinline__ void walk(const ResidentArgs& a, int32_t round, int32_t count,
                                     long long warp, long long nwarps, int32_t head) {
  constexpr int kTeams = 32 / G;
  const int lane = threadIdx.x & 31;
  const int32_t* cur = (round & 1) ? a.q0 : a.q1;
  int32_t* next = (round & 1) ? a.q1 : a.q0;
  int32_t* tail = a.cnt + round % 3;
  int32_t* v = static_cast<int32_t*>(a.result);
  float* d = static_cast<float*>(a.result);
  for (long long s = warp * kTeams; s < count; s += nwarps * kTeams) {
    const long long q = s + lane / G;
    int32_t k = 0, end = 0;
    float di = 0.0f;
    if (q < count) {
      const int32_t i = NARROW && s == warp * kTeams ? head : __ldcg(cur + q);
      k = __ldg(a.indptr + i) + (lane & (G - 1));
      end = __ldg(a.indptr + i + 1);
      if constexpr (SSSP) di = __ldcg(d + i);
    }
    for (; __any_sync(kFullMask, k < end); k += kEntries * G) {
      int32_t j[kEntries];
      float nd[kEntries];
      bool want[kEntries];
#pragma unroll
      for (int u = 0; u < kEntries; ++u) {
        const int32_t e = k + u * G;
        want[u] = e < end;
        j[u] = want[u] ? __ldg(a.cols + e) : 0;
        if constexpr (SSSP) nd[u] = want[u] ? di + __ldg(a.values + e) : 0.0f;
      }
      if constexpr (!NARROW) {
#pragma unroll
        for (int u = 0; u < kEntries; ++u) {
          if constexpr (SSSP) want[u] = want[u] && nd[u] < __ldcg(d + j[u]);
          else want[u] = want[u] && __ldcg(v + j[u]) == 0;
        }
      }
#pragma unroll
      for (int u = 0; u < kEntries; ++u) {
        if constexpr (SSSP) want[u] = want[u] && nd[u] < atomic_min_float(d + j[u], nd[u]);
        else want[u] = want[u] && atomicCAS(v + j[u], 0, round + 1) == 0;
      }
      if constexpr (SSSP) {
#pragma unroll
        for (int u = 0; u < kEntries; ++u)
          want[u] = want[u] && atomicMax(a.stamp + j[u], round + 1) < round + 1;
      }
      append(want, j, next, tail, lane);
    }
  }
}

template <bool SSSP, int LOG2G>
__global__ void __launch_bounds__(kResidentThreads, 1) resident_kernel(const ResidentArgs a) {
  constexpr int G = 1 << LOG2G;
  constexpr int kTeams = 32 / G;
  __shared__ int32_t s_round, s_count;
  const bool lead = blockIdx.x < kLeadCtas;  // the first cluster
  const bool first = blockIdx.x == 0 && threadIdx.x == 0;
  const int warp_in_cta = threadIdx.x >> 5;
  // a round's consecutive warps lie on different SMs
  const long long lead_warp = static_cast<long long>(warp_in_cta) * kLeadCtas + blockIdx.x;
  const long long grid_warp = static_cast<long long>(warp_in_cta) * gridDim.x + blockIdx.x;
  const long long grid_warps = static_cast<long long>(gridDim.x) * kWarps;
  if (first) {
    if constexpr (SSSP) {
      static_cast<float*>(a.result)[a.source] = 0.0f;
      a.stamp[a.source] = 1;
    } else {
      static_cast<int32_t*>(a.result)[a.source] = 1;
    }
    a.q0[0] = a.source;
    a.cnt[0] = 1;
  }
  if (lead) cg::this_cluster().sync();

  const int32_t cap = a.n + 2;
  int32_t round = 1;  // the queue holds round `round`'s vertices (BFS: depth `round`)
  int32_t count = 0, wide = 0;
  for (;;) {
    if (!lead) {  // wait for the next wide round, or the end
      if (threadIdx.x == 0) s_round = wait_epoch(a.cnt + 3, round);
      __syncthreads();
      round = s_round;
      if (round == kDone) break;
    }
    int32_t head = 0;  // the lead cluster: the vertex in this lane's first queue slot
    const long long slot = lead_warp * kTeams + (threadIdx.x & 31) / G;
    if (lead && slot < a.n) head = __ldcg(((round & 1) ? a.q0 : a.q1) + slot);
    if (threadIdx.x == 0) s_count = __ldcg(a.cnt + (round - 1) % 3);
    __syncthreads();
    count = s_count;
    // only the lead cluster leaves here: a published round is non-empty
    // and within the cap
    if (count == 0 || round > cap) break;
    const bool wide_round = count > a.wide_above;
    if (first) {
      a.cnt[(round + 1) % 3] = 0;  // read last round, filled next round
      if (wide_round) {
        __threadfence();
        st_release(a.cnt + 3, round);
      }
      wide += wide_round;
    }
    if (wide_round) {
      walk<SSSP, G, false>(a, round, count, grid_warp, grid_warps, 0);
      cg::this_grid().sync();
    } else {
      walk<SSSP, G, true>(a, round, count, lead_warp, static_cast<long long>(kLeadCtas) * kWarps,
                          head);
      cg::this_cluster().sync();
    }
    ++round;
  }
  if (first) {
    st_release(a.cnt + 3, kDone);  // the CTAs still waiting leave
    a.stats[0] = round - 1;
    a.stats[1] = count != 0;
    a.stats[2] = wide;
  }
}

template <bool SSSP, int LOG2G>
void* kernel_of() {
  return reinterpret_cast<void*>(resident_kernel<SSSP, LOG2G>);
}

void* kernel_for(bool sssp, int log2g) {
  switch (log2g) {
    case 1: return sssp ? kernel_of<true, 1>() : kernel_of<false, 1>();
    case 2: return sssp ? kernel_of<true, 2>() : kernel_of<false, 2>();
    case 3: return sssp ? kernel_of<true, 3>() : kernel_of<false, 3>();
    case 4: return sssp ? kernel_of<true, 4>() : kernel_of<false, 4>();
    case 5: return sssp ? kernel_of<true, 5>() : kernel_of<false, 5>();
    default: return nullptr;
  }
}

struct LaunchShape {
  cudaLaunchAttribute attrs[2];
  cudaLaunchConfig_t config = {};

  // cooperative: with the cluster dimension, the launch's; without, the
  // occupancy query's
  LaunchShape(unsigned ctas, cudaStream_t stream, bool cooperative) {
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = kLeadCtas;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    attrs[1].id = cudaLaunchAttributeCooperative;
    attrs[1].val.cooperative = 1;
    config.gridDim = dim3(ctas);
    config.blockDim = dim3(kResidentThreads);
    config.dynamicSmemBytes = 0;
    config.stream = stream;
    config.attrs = attrs;
    config.numAttrs = cooperative ? 2 : 1;
  }
};

// The grid of one instance on the current device: the clusters that fit at
// once, times kLeadCtas; asked once per instance and device.
struct ResidentGrid {
  int device = -1;
  int ctas = 0;
  int regs = 0;
};

cudaError_t resident_grid(bool sssp, int log2g, ResidentGrid* out) {
  static ResidentGrid cache[2][6];
  void* kernel = kernel_for(sssp, log2g);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  ResidentGrid& g = cache[sssp][log2g];
  if (g.device != device) {
    int coop = 0, clusters = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    LaunchShape shape(kLeadCtas, nullptr, false);
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &shape.config);
    if (err != cudaSuccess) return err;
    if (clusters == 0) return cudaErrorCooperativeLaunchTooLarge;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    g = {device, clusters * kLeadCtas, attr.numRegs};
  }
  *out = g;
  return cudaSuccess;
}

int launch(bool sssp, int log2g, const ResidentArgs& args, void* stream) {
  ResidentGrid g;
  cudaError_t err = resident_grid(sssp, log2g, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  LaunchShape shape(static_cast<unsigned>(g.ctas), static_cast<cudaStream_t>(stream), true);
  ResidentArgs a = args;
  void* params[] = {&a};
  err = cudaLaunchKernelExC(&shape.config, kernel_for(sssp, log2g), params);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

ResidentArgs args_of(long long n, int source, long long wide_above, const void* indptr,
                     const void* cols, const void* values, void* result, void* stamp, void* queues,
                     void* counters, void* stats) {
  ResidentArgs a;
  a.n = static_cast<int32_t>(n);
  a.source = source;
  a.wide_above = static_cast<int32_t>(wide_above);
  a.indptr = static_cast<const int32_t*>(indptr);
  a.cols = static_cast<const int32_t*>(cols);
  a.values = static_cast<const float*>(values);
  a.result = result;
  a.stamp = static_cast<int32_t*>(stamp);
  a.q0 = static_cast<int32_t*>(queues);
  a.q1 = a.q0 + n;
  a.cnt = static_cast<int32_t*>(counters);
  a.stats = static_cast<int32_t*>(stats);
  return a;
}

}  // namespace

// v: int32 [n], zero; queues: int32 [2n]; counters: int32 [4], zero;
// stats: int32 [3]; a team is 1 << log2g lanes (1 to 5).
extern "C" int spla_bfs_resident(long long n, int source, int log2g, long long wide_above,
                                 const void* indptr, const void* cols, void* v, void* queues,
                                 void* counters, void* stats, void* stream) {
  return launch(false, log2g,
                args_of(n, source, wide_above, indptr, cols, nullptr, v, nullptr, queues, counters,
                        stats),
                stream);
}

// d: f32 [n], +inf; stamps: int32 [n], zero; the rest as for BFS.
extern "C" int spla_sssp_resident(long long n, int source, int log2g, long long wide_above,
                                  const void* indptr, const void* cols, const void* values, void* d,
                                  void* stamps, void* queues, void* counters, void* stats,
                                  void* stream) {
  return launch(true, log2g,
                args_of(n, source, wide_above, indptr, cols, values, d, stamps, queues, counters,
                        stats),
                stream);
}

// The CTAs of one launch of an instance on the current device, its cluster
// size and its registers a thread.
extern "C" int spla_resident_grid(int sssp, int log2g, int* ctas, int* cluster, int* regs) {
  ResidentGrid g;
  const cudaError_t err = resident_grid(sssp != 0, log2g, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  *ctas = g.ctas;
  *cluster = kLeadCtas;
  *regs = g.regs;
  return 0;
}
