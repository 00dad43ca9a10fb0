// The frontier lists of the BFS / SSSP level loop, shared by kernel 2
// (spmv_push.cu: the push over a list's edges, and the fused push levels)
// and kernel 3 (level_update.cu: the stream update of a pull level, and the
// update of an SSSP push level's touched vertices).
//
// A list of the level loop holds k vertices and, beside each, eoff[p]: the
// out-degrees in CSR(A) (the push matrix) of the vertices in the slots
// before p, so that the list's E edges are numbered 0..E-1 in slot order.
// Its size is one 64-bit word, (k << 32) | E.  Appends reserve their slots
// and their edges together, with one atomicAdd on that word a warp, so eoff
// grows with the slot whatever order the warps come in.  E < 2^31 (int32
// CSR), so the low word never carries into the high one.
//
// A push walks a list's edges in chunks of kChunk, a warp a chunk and
// kEdges consecutive edges a lane: a lane finds the slot of its first edge
// by bisecting eoff and walks forward from there, past the slots of
// vertices with no entries.  Every warp does the same work however the
// degrees are spread: a hub row is cut over as many warps as it needs.
#pragma once

#include "semiring.cuh"

constexpr int kEdges = 4;             // consecutive edges of a list a lane takes
constexpr int kChunk = 32 * kEdges;   // a warp's edges
constexpr int kBlockWarps = kThreads / 32;
constexpr unsigned kInfBits = 0x7f800000u;  // +inf

// Blocks of kThreads for a grid-stride walk of `edges` edges and `slots`
// list slots (or vertices): enough for both, at most 8 blocks an SM.
inline unsigned walk_blocks(long long edges, long long slots) {
  static const int max_blocks = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return 8 * (sms > 0 ? sms : 132);
  }();
  const long long by_edges = (edges + kChunk * kBlockWarps - 1) / (kChunk * kBlockWarps);
  const long long by_slots = (slots + kThreads - 1) / kThreads;
  long long b = by_edges > by_slots ? by_edges : by_slots;
  if (b < 1) b = 1;
  return static_cast<unsigned>(b < max_blocks ? b : max_blocks);
}

// out = out (+) v with (+) MIN or MAX, atomically; returns the old value.
// f32 uses integer atomics on the float bits, split by sign (a non-negative
// value orders like a signed int, a negative one reversed like an unsigned
// int), which is exact for negatives and +-inf; a NaN is stored as a NaN
// that both atomic orders keep, as torch.minimum propagates it.
template <int ADD>
__device__ __forceinline__ int32_t atomic_fold(int32_t* addr, int32_t v) {
  if constexpr (ADD == KC_MIN) return atomicMin(addr, v);
  else return atomicMax(addr, v);
}

template <int ADD>
__device__ __forceinline__ float atomic_fold(float* addr, float v) {
  if (v != v) {
    // 0xffc00000 is a negative NaN: the largest unsigned and a negative int,
    // so neither atomicMin(int) nor atomicMax(unsigned) replaces it (MIN);
    // 0x7fc00000 is larger than every int of a float and the smallest unsigned
    // above them, so atomicMax(int) and atomicMin(unsigned) keep it (MAX).
    return __uint_as_float(atomicExch(reinterpret_cast<unsigned*>(addr),
                                      ADD == KC_MIN ? 0xffc00000u : 0x7fc00000u));
  }
  const bool neg = __float_as_uint(v) >> 31;
  if constexpr (ADD == KC_MIN) {
    if (!neg) return __int_as_float(atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v)));
    return __uint_as_float(atomicMax(reinterpret_cast<unsigned*>(addr), __float_as_uint(v)));
  } else {
    if (!neg) return __int_as_float(atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v)));
    return __uint_as_float(atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v)));
  }
}

// The edges e0 .. e0 + kEdges - 1 of a list of k vertices and `total`
// edges: ok[u] when edge e0 + u exists, its source vertex src[u] and the
// index ent[u] of its entry in CSR(A).
__device__ __forceinline__ void lane_edges(const int32_t* __restrict__ list,
                                           const int32_t* __restrict__ eoff, int32_t k,
                                           int32_t total, const int32_t* __restrict__ indptr,
                                           long long e0, bool (&ok)[kEdges],
                                           int32_t (&src)[kEdges], int32_t (&ent)[kEdges]) {
#pragma unroll
  for (int u = 0; u < kEdges; ++u) {
    ok[u] = false;
    src[u] = 0;
    ent[u] = 0;
  }
  if (e0 >= total) return;
  const int32_t first = static_cast<int32_t>(e0);
  int32_t lo = 1, hi = k;  // eoff[0] = 0 <= first: find the last slot with eoff <= first
  while (lo < hi) {
    const int32_t mid = (lo + hi) >> 1;
    if (__ldg(eoff + mid) <= first) lo = mid + 1;
    else hi = mid;
  }
  int32_t p = lo - 1, loaded = p;
  int32_t off = __ldg(eoff + p);
  int32_t next = p + 1 < k ? __ldg(eoff + p + 1) : total;
  int32_t i = __ldg(list + p);
  int32_t row = __ldg(indptr + i);
#pragma unroll
  for (int u = 0; u < kEdges; ++u) {
    const int32_t e = first + u;
    if (e >= total) break;
    while (e >= next) {  // past the slot's last edge, and any slots of no edges
      ++p;
      off = next;
      next = p + 1 < k ? __ldg(eoff + p + 1) : total;
    }
    if (p != loaded) {
      loaded = p;
      i = __ldg(list + p);
      row = __ldg(indptr + i);
    }
    ok[u] = true;
    src[u] = i;
    ent[u] = row + (e - off);
  }
}

template <int K>
__device__ __forceinline__ bool any_of(const bool (&want)[K]) {
  bool any = false;
#pragma unroll
  for (int u = 0; u < K; ++u) any = any || want[u];
  return __any_sync(kFullMask, any);
}

// Append the vertices j[u] with want[u], of out-degree deg[u], to a list of
// the level loop (slots `list`, edge offsets `eoff`, size word `word`): one
// atomicAdd a warp reserves the warp's slots and their edges.  Every lane of
// the warp calls it.
template <int K>
__device__ __forceinline__ void append_wide(const bool (&want)[K], const int32_t (&j)[K],
                                            const int32_t (&deg)[K], int32_t* list, int32_t* eoff,
                                            unsigned long long* word, int lane) {
  if (!any_of(want)) return;
  int c = 0, d = 0;
#pragma unroll
  for (int u = 0; u < K; ++u) {
    if (want[u]) {
      ++c;
      d += deg[u];
    }
  }
  int cs = c, ds = d;  // inclusive scans over the lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(kFullMask, cs, o), b = __shfl_up_sync(kFullMask, ds, o);
    if (lane >= o) {
      cs += a;
      ds += b;
    }
  }
  unsigned long long base = 0;
  if (lane == 31)
    base = atomicAdd(word, (static_cast<unsigned long long>(cs) << 32) | static_cast<unsigned>(ds));
  base = __shfl_sync(kFullMask, base, 31);
  int32_t slot = static_cast<int32_t>(base >> 32) + cs - c;
  int32_t e = static_cast<int32_t>(base & 0xffffffffu) + ds - d;
#pragma unroll
  for (int u = 0; u < K; ++u) {
    if (want[u]) {
      list[slot] = j[u];
      eoff[slot] = e;
      ++slot;
      e += deg[u];
    }
  }
}

// Append the vertices j[u] with want[u] to a plain list whose size is the
// int32 *count: one atomicAdd a warp.  Every lane of the warp calls it.
template <int K>
__device__ __forceinline__ void append_list(const bool (&want)[K], const int32_t (&j)[K],
                                            int32_t* list, int32_t* count, int lane) {
  unsigned m[K];
  int total = 0;
#pragma unroll
  for (int u = 0; u < K; ++u) {
    m[u] = __ballot_sync(kFullMask, want[u]);
    total += __popc(m[u]);
  }
  if (total == 0) return;
  int32_t base = 0;
  if (lane == 0) base = atomicAdd(count, total);
  base = __shfl_sync(kFullMask, base, 0);
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int u = 0; u < K; ++u) {
    if (want[u]) list[base + __popc(m[u] & below)] = j[u];
    base += __popc(m[u]);
  }
}

// Append up to K vertices a thread (j[u] where want[u], of out-degree
// deg[u]), a whole block at once: one atomicAdd a block on the list's size,
// a 64-bit word (k << 32) | E with the degree offsets (WIDE) or an int32
// count.  A stream over n appends up to a vertex a thread, so an atomic a
// warp on one word would serialize n / 32 of them.  Every thread of the
// block calls it.
template <bool WIDE, int BLOCK, int K>
__device__ __forceinline__ void block_append(const bool (&want)[K], const int32_t (&j)[K],
                                             const int32_t (&deg)[K], int32_t* list, int32_t* eoff,
                                             void* size) {
  constexpr int kWarps = BLOCK / 32;
  __shared__ int32_t s_c[kWarps], s_d[kWarps];
  __shared__ unsigned long long s_base;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int c = 0, d = 0;
#pragma unroll
  for (int u = 0; u < K; ++u) {
    if (want[u]) {
      ++c;
      d += deg[u];
    }
  }
  int cs = c, ds = d;  // inclusive scans over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(kFullMask, cs, o);
    const int b = WIDE ? __shfl_up_sync(kFullMask, ds, o) : 0;
    if (lane >= o) {
      cs += a;
      ds += b;
    }
  }
  if (lane == 31) {
    s_c[warp] = cs;
    s_d[warp] = ds;
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scans over the warps, and the block's reservation
    const int wc = lane < kWarps ? s_c[lane] : 0, wd = lane < kWarps ? s_d[lane] : 0;
    int xc = wc, xd = wd;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int a = __shfl_up_sync(kFullMask, xc, o), b = __shfl_up_sync(kFullMask, xd, o);
      if (lane >= o) {
        xc += a;
        xd += b;
      }
    }
    if (lane < kWarps) {
      s_c[lane] = xc - wc;
      s_d[lane] = xd - wd;
    }
    if (lane == 31 && xc > 0) {
      if constexpr (WIDE)
        s_base = atomicAdd(static_cast<unsigned long long*>(size),
                           (static_cast<unsigned long long>(xc) << 32) | static_cast<unsigned>(xd));
      else
        s_base = static_cast<unsigned long long>(atomicAdd(static_cast<int32_t*>(size), xc)) << 32;
    }
  }
  __syncthreads();
  if (c > 0) {
    const unsigned long long base = s_base;
    int32_t slot = static_cast<int32_t>(base >> 32) + s_c[warp] + cs - c;
    int32_t e = static_cast<int32_t>(base & 0xffffffffu) + s_d[warp] + ds - d;
#pragma unroll
    for (int u = 0; u < K; ++u) {
      if (want[u]) {
        list[slot] = j[u];
        if constexpr (WIDE) eoff[slot] = e;
        ++slot;
        e += deg[u];
      }
    }
  }
  __syncthreads();  // the shared words are free for the next call
}

// Kernel 3's update of an SSSP push level's touched vertices (level_update.cu),
// launched by kernel 2's spla_sssp_push_level after its push.
void launch_sssp_touched(long long bound, const int32_t* touched, const int32_t* tcount, float* hits,
                         float* v, uint8_t* changed, const int32_t* indptr, int32_t* next_list,
                         int32_t* next_eoff, unsigned long long* next_word, cudaStream_t stream);
