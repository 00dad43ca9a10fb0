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
// Bound: the grid-wide barrier that ends each level.  A road-class graph
// has ~2 * side levels of a few hundred vertices each; its CSR and state
// (33.5 MB for the side-1024 grid) fit the 50 MB L2, and a level moves a few
// KB.  So the design spends one barrier a level and nothing else on the
// host or between launches:
//   * three tail counters rotate: in round r one is read (the size of the
//     queue being walked), one is filled (the next queue) and one is zeroed
//     (the queue after that), so no second barrier resets a tail.  Every
//     thread reads the same count after the barrier, so all threads leave
//     the loop in the same round and meet every barrier;
//   * a warp per queued vertex, lanes striding its row; a warp-aggregated
//     atomicAdd reserves the slots of the next queue;
//   * BFS claims a vertex with atomicCAS(v[j], 0, depth + 1), so the depths
//     do not depend on the order of the claims;
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
//     bit for bit.
// Vertices, queue slots and counters that other SMs write during the launch
// are read through L2 (__ldcg); the CSR arrays are read-only (__ldg).
// Both kinds stop when the queue is empty or after n + 2 rounds, the
// counterpart of the TPU kernel's max_iters, which ends a negative cycle;
// stats[0] = the rounds run, stats[1] = 1 when the cap stopped a non-empty
// queue.
//
// The grid is the occupancy limit times the SM count, launched with
// cudaLaunchCooperativeKernel: a grid-wide barrier is valid only when every
// CTA is resident, which the cooperative launch guarantees or refuses.

#include <cooperative_groups.h>

#include "semiring.cuh"

namespace cg = cooperative_groups;

namespace {

// Reserve this warp's slots in `next` for the lanes that want one.
__device__ __forceinline__ void append(bool want, int32_t j, int32_t* next, int32_t* tail,
                                       int lane) {
  const unsigned m = __ballot_sync(kFullMask, want);
  if (m == 0) return;
  const int leader = __ffs(m) - 1;
  int32_t base = 0;
  if (lane == leader) base = atomicAdd(tail, __popc(m));
  base = __shfl_sync(kFullMask, base, leader);
  if (want) next[base + __popc(m & ((1u << lane) - 1u))] = j;
}

// d = min(d, x) for a non-NaN x; returns the old value.
__device__ __forceinline__ float atomic_min_float(float* addr, float x) {
  if (!(__float_as_uint(x) >> 31))
    return __int_as_float(atomicMin(reinterpret_cast<int*>(addr), __float_as_int(x)));
  return __uint_as_float(atomicMax(reinterpret_cast<unsigned*>(addr), __float_as_uint(x)));
}

template <bool SSSP>
__global__ void __launch_bounds__(kThreads)
resident_kernel(int n, int source, const int32_t* __restrict__ indptr,
                const int32_t* __restrict__ cols, const float* __restrict__ values, void* result,
                int32_t* stamp, int32_t* q0, int32_t* q1, int32_t* cnt, int32_t* stats) {
  cg::grid_group grid = cg::this_grid();
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = static_cast<int>(tid >> 5);
  const int n_warps = static_cast<int>((static_cast<long long>(gridDim.x) * blockDim.x) >> 5);
  int32_t* v = static_cast<int32_t*>(result);
  float* d = static_cast<float*>(result);
  if (tid == 0) {
    if constexpr (SSSP) {
      d[source] = 0.0f;
      stamp[source] = 1;
    } else {
      v[source] = 1;
    }
    q0[0] = source;
    cnt[0] = 1;
    cnt[1] = 0;
    cnt[2] = 0;
  }
  grid.sync();

  const int cap = n + 2;
  int round = 1;  // the queue holds round `round`'s vertices (BFS: depth `round`)
  int32_t count;
  for (;;) {
    count = __ldcg(&cnt[(round - 1) % 3]);
    if (count == 0 || round > cap) break;
    const int32_t* cur = (round & 1) ? q0 : q1;
    int32_t* next = (round & 1) ? q1 : q0;
    int32_t* tail = &cnt[round % 3];
    if (tid == 0) cnt[(round + 1) % 3] = 0;  // read last round, filled next round
    for (int w = warp; w < count; w += n_warps) {
      const int32_t i = __ldcg(&cur[w]);
      const int32_t end = __ldg(&indptr[i + 1]);
      float di = 0.0f;
      if constexpr (SSSP) di = __ldcg(&d[i]);
      for (int32_t e0 = __ldg(&indptr[i]); e0 < end; e0 += 32) {
        const int32_t e = e0 + lane;
        bool want = false;
        int32_t j = 0;
        if (e < end) {
          j = __ldg(&cols[e]);
          if constexpr (SSSP) {
            const float nd = di + __ldg(&values[e]);
            if (nd < __ldcg(&d[j]) && nd < atomic_min_float(&d[j], nd))
              want = atomicMax(&stamp[j], round + 1) < round + 1;
          } else {
            want = __ldcg(&v[j]) == 0 && atomicCAS(&v[j], 0, round + 1) == 0;
          }
        }
        append(want, j, next, tail, lane);
      }
    }
    grid.sync();
    ++round;
  }
  if (tid == 0) {
    stats[0] = round - 1;
    stats[1] = count != 0;
  }
}

template <bool SSSP>
cudaError_t grid_blocks(int* blocks) {
  int device = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resident_kernel<SSSP>, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (per_sm == 0) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

template <bool SSSP>
int launch(long long n, int source, const void* indptr, const void* cols, const void* values,
           void* result, void* stamp, void* queues, void* counters, void* stats, void* stream) {
  int blocks = 0;
  cudaError_t err = grid_blocks<SSSP>(&blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n32 = static_cast<int>(n);
  const int32_t* indptr_p = static_cast<const int32_t*>(indptr);
  const int32_t* cols_p = static_cast<const int32_t*>(cols);
  const float* values_p = static_cast<const float*>(values);
  int32_t* stamp_p = static_cast<int32_t*>(stamp);
  int32_t* q0 = static_cast<int32_t*>(queues);
  int32_t* q1 = q0 + n;
  int32_t* cnt = static_cast<int32_t*>(counters);
  int32_t* stats_p = static_cast<int32_t*>(stats);
  void* args[] = {&n32, &source, &indptr_p, &cols_p, &values_p, &result,
                  &stamp_p, &q0, &q1, &cnt, &stats_p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(resident_kernel<SSSP>),
                                    dim3(blocks), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

// v: int32 [n], zero; queues: int32 [2n]; counters: int32 [3]; stats: int32 [2].
extern "C" int spla_bfs_resident(long long n, int source, const void* indptr, const void* cols,
                                 void* v, void* queues, void* counters, void* stats,
                                 void* stream) {
  return launch<false>(n, source, indptr, cols, nullptr, v, nullptr, queues, counters, stats,
                       stream);
}

// d: f32 [n], +inf; stamps: int32 [n], zero; the rest as for BFS.
extern "C" int spla_sssp_resident(long long n, int source, const void* indptr, const void* cols,
                                  const void* values, void* d, void* stamps, void* queues,
                                  void* counters, void* stats, void* stream) {
  return launch<true>(n, source, indptr, cols, values, d, stamps, queues, counters, stats, stream);
}

// The CTAs of one launch (occupancy limit x SMs) on the current device.
extern "C" int spla_resident_blocks(int sssp, int* blocks) {
  return static_cast<int>(sssp ? grid_blocks<true>(blocks) : grid_blocks<false>(blocks));
}
