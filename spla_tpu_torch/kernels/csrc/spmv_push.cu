// Kernel 2: the frontier push over CSR(A), and the fused push levels of the
// BFS / SSSP level loop.
//
// Replaces the sparse-frontier grid of spla_tpu/pallas/spmv.py
// fused_spmv2d_adaptive (:2346, kernel _make_sparse_fused_kernel :2231), whose
// cost follows the active tile batches, and, on push levels, the level update
// that follows it (_level_update :2789 through bfs_level_update_auto :2925
// and sssp_level_update_auto :2858, the chunk-sparse updates).  Here the cost
// follows the frontier: the input is a compacted frontier list, and only the
// rows of A that it names, and the vertices they reach, are read or written.
// CSR(A) is the transpose of the At the pull kernel walks, so push and pull
// give the same result.
//
// * spmv_push:   out[j] = out[j] (+) mul(A[i,j], x[i]) for every i in the list,
//   (+) an idempotent monoid (MIN or MAX), so the order of the atomics does
//   not matter (PLUS stays on kernel 1); the structural variant sets hits[j].
// * bfs_push_level (one launch): the list's depths set and its front bytes
//   cleared; each edge's column claimed in a bitmap of visited vertices
//   (atomicOr: visited or in the frontier), and each vertex claimed first
//   appended to the next list with its out-degree, and its front byte set.
//   So v, front, the next list and its size are what spmv_push_structural
//   followed by bfs_level_update leave, with no hits array and no pass over n.
// * sssp_push_level (two launches): the list's changed bytes cleared; each
//   edge's d[i] + w folded into a scratch `hits` that is +inf between levels,
//   and the lane whose atomic moves a slot off +inf appends that vertex to a
//   touched list, once.  Then kernel 3's touched update (level_update.cu)
//   does what sssp_level_update does for those vertices only and puts +inf
//   back.  The push reads d before any of it changes.
//
// Bound: bytes, and at small frontiers latency.  The edges of a list are
// balanced over warps by the degree prefix its append recorded
// (frontier.cuh): each lane takes four consecutive edges, issues their column
// and value loads, then its atomics; appends are one atomicAdd a warp.  The
// design it replaced gave each listed vertex one warp striding its row: half
// the lanes idle at degree 16, and a hub row walked by one warp alone.
// Every launch is a grid-stride loop of at most 8 blocks an SM; the public
// entries, whose edge count lies on the device, size the grid by the
// matrix's capacity.

#include "frontier.cuh"

namespace {

struct Walk {
  int32_t k;
  const int32_t* total;  // the list's edges, on the device
  const int32_t* list;
  const int32_t* eoff;
  const int32_t* indptr;
  const int32_t* cols;
};

__device__ __forceinline__ long long warp_id() {
  return (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
}

__device__ __forceinline__ long long warp_count() {
  return (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
}

__device__ __forceinline__ long long thread_id() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long thread_count() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

template <typename T, int MUL, int ADD>
__global__ void __launch_bounds__(kThreads)
spmv_push_kernel(const Walk w, const T* __restrict__ values, const T* __restrict__ x,
                 T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int32_t total = *w.total;
  for (long long c = warp_id() * kChunk; c < total; c += warp_count() * kChunk) {
    bool ok[kEdges];
    int32_t src[kEdges], ent[kEdges], j[kEdges];
    T a[kEdges], xi[kEdges];
    lane_edges(w.list, w.eoff, w.k, total, w.indptr, c + lane * kEdges, ok, src, ent);
#pragma unroll
    for (int u = 0; u < kEdges; ++u) {
      j[u] = ok[u] ? __ldg(w.cols + ent[u]) : 0;
      a[u] = ok[u] ? __ldg(values + ent[u]) : T(0);
      xi[u] = ok[u] ? __ldg(x + src[u]) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kEdges; ++u)
      if (ok[u]) atomic_fold<ADD>(out + j[u], apply_op<MUL>(a[u], xi[u]));
  }
}

__global__ void __launch_bounds__(kThreads)
spmv_push_structural_kernel(const Walk w, uint8_t* __restrict__ hits) {
  const int lane = threadIdx.x & 31;
  const int32_t total = *w.total;
  for (long long c = warp_id() * kChunk; c < total; c += warp_count() * kChunk) {
    bool ok[kEdges];
    int32_t src[kEdges], ent[kEdges], j[kEdges];
    lane_edges(w.list, w.eoff, w.k, total, w.indptr, c + lane * kEdges, ok, src, ent);
#pragma unroll
    for (int u = 0; u < kEdges; ++u) j[u] = ok[u] ? __ldg(w.cols + ent[u]) : 0;
    // every writer stores the same byte, so plain stores are race-free
#pragma unroll
    for (int u = 0; u < kEdges; ++u)
      if (ok[u]) hits[j[u]] = 1;
  }
}

struct Next {  // the list a level appends to
  int32_t* list;
  int32_t* eoff;
  unsigned long long* word;   // its size, zero at the launch
  unsigned long long* clear;  // the size word of the level after, zeroed here
};

__global__ void __launch_bounds__(kThreads)
bfs_push_level_kernel(const Walk w, int32_t* __restrict__ v, uint8_t* __restrict__ front,
                      uint32_t* __restrict__ vis, int32_t depth, const Next nx) {
  const int lane = threadIdx.x & 31;
  if (thread_id() == 0) *nx.clear = 0;
  for (long long p = thread_id(); p < w.k; p += thread_count()) {
    const int32_t i = __ldg(w.list + p);
    v[i] = depth;
    front[i] = 0;
  }
  const int32_t total = *w.total;
  for (long long c = warp_id() * kChunk; c < total; c += warp_count() * kChunk) {
    bool ok[kEdges], want[kEdges];
    int32_t src[kEdges], ent[kEdges], j[kEdges], deg[kEdges];
    lane_edges(w.list, w.eoff, w.k, total, w.indptr, c + lane * kEdges, ok, src, ent);
#pragma unroll
    for (int u = 0; u < kEdges; ++u) j[u] = ok[u] ? __ldg(w.cols + ent[u]) : 0;
    // a plain read first, so that the atomics go only to vertices not yet visited
#pragma unroll
    for (int u = 0; u < kEdges; ++u)
      want[u] = ok[u] && !((__ldcg(vis + (j[u] >> 5)) >> (j[u] & 31)) & 1u);
#pragma unroll
    for (int u = 0; u < kEdges; ++u) {
      if (want[u]) {
        const unsigned bit = 1u << (j[u] & 31);
        want[u] = !(atomicOr(vis + (j[u] >> 5), bit) & bit);
      }
    }
#pragma unroll
    for (int u = 0; u < kEdges; ++u) {
      deg[u] = 0;
      if (want[u]) {
        front[j[u]] = 1;
        deg[u] = __ldg(w.indptr + j[u] + 1) - __ldg(w.indptr + j[u]);
      }
    }
    append_wide(want, j, deg, nx.list, nx.eoff, nx.word, lane);
  }
}

__global__ void __launch_bounds__(kThreads)
sssp_push_kernel(const Walk w, const float* __restrict__ values, const float* __restrict__ d,
                 float* __restrict__ hits, uint8_t* __restrict__ changed, int32_t* __restrict__ touched,
                 int32_t* __restrict__ tcount, int32_t* __restrict__ tclear,
                 unsigned long long* __restrict__ clear) {
  const int lane = threadIdx.x & 31;
  if (thread_id() == 0) {
    *clear = 0;
    *tclear = 0;
  }
  for (long long p = thread_id(); p < w.k; p += thread_count()) changed[__ldg(w.list + p)] = 0;
  const int32_t total = *w.total;
  for (long long c = warp_id() * kChunk; c < total; c += warp_count() * kChunk) {
    bool ok[kEdges], want[kEdges];
    int32_t src[kEdges], ent[kEdges], j[kEdges];
    float nd[kEdges];
    lane_edges(w.list, w.eoff, w.k, total, w.indptr, c + lane * kEdges, ok, src, ent);
#pragma unroll
    for (int u = 0; u < kEdges; ++u) {
      j[u] = ok[u] ? __ldg(w.cols + ent[u]) : 0;
      nd[u] = ok[u] ? op_plus(__ldg(values + ent[u]), __ldg(d + src[u])) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kEdges; ++u) {
      want[u] = false;
      if (ok[u]) {
        const float old = atomic_fold<KC_MIN>(hits + j[u], nd[u]);
        want[u] = __float_as_uint(old) == kInfBits && __float_as_uint(nd[u]) != kInfBits;
      }
    }
    append_list(want, j, touched, tcount, lane);
  }
}

struct PushLaunch {
  Walk w;
  unsigned blocks;
  const void *values, *x;
  void* out;
  cudaStream_t stream;

  template <typename T, int MUL, int ADD>
  void run() {
    spmv_push_kernel<T, MUL, ADD><<<blocks, kThreads, 0, stream>>>(
        w, static_cast<const T*>(values), static_cast<const T*>(x), static_cast<T*>(out));
  }
};

Walk walk_of(long long k, const void* total, const void* list, const void* eoff, const void* indptr,
             const void* cols) {
  return Walk{static_cast<int32_t>(k), static_cast<const int32_t*>(total),
              static_cast<const int32_t*>(list), static_cast<const int32_t*>(eoff),
              static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(cols)};
}

}  // namespace

// The public push: `edges` bounds the list's edge count, which lies at
// `total` on the device.
extern "C" int spla_spmv_push(int mul, int add, int dtype, long long k, long long edges,
                              const void* list, const void* eoff, const void* total,
                              const void* indptr, const void* cols, const void* values,
                              const void* x, void* out, void* stream) {
  if (k == 0) return 0;
  PushLaunch launch{walk_of(k, total, list, eoff, indptr, cols), walk_blocks(edges, 0), values, x,
                    out, static_cast<cudaStream_t>(stream)};
  if (!dispatch<false>(mul, add, dtype, launch)) return -1;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spla_spmv_push_structural(long long k, long long edges, const void* list,
                                         const void* eoff, const void* total, const void* indptr,
                                         const void* cols, void* hits, void* stream) {
  if (k == 0) return 0;
  spmv_push_structural_kernel<<<walk_blocks(edges, 0), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      walk_of(k, total, list, eoff, indptr, cols), static_cast<uint8_t*>(hits));
  return static_cast<int>(cudaGetLastError());
}

// A BFS push level: the list of k vertices and `edges` edges (its size word
// at `total`), depth `depth`.
extern "C" int spla_bfs_push_level(long long k, long long edges, const void* list, const void* eoff,
                                   const void* total, const void* indptr, const void* cols, void* v,
                                   void* front, void* vis, int depth, void* next_list,
                                   void* next_eoff, void* next_word, void* clear_word,
                                   void* stream) {
  const Next nx{static_cast<int32_t*>(next_list), static_cast<int32_t*>(next_eoff),
                static_cast<unsigned long long*>(next_word),
                static_cast<unsigned long long*>(clear_word)};
  bfs_push_level_kernel<<<walk_blocks(edges, k), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      walk_of(k, total, list, eoff, indptr, cols), static_cast<int32_t*>(v),
      static_cast<uint8_t*>(front), static_cast<uint32_t*>(vis), depth, nx);
  return static_cast<int>(cudaGetLastError());
}

// An SSSP push level: the push, then kernel 3's update of the touched
// vertices (at most min(edges, n)).
extern "C" int spla_sssp_push_level(long long k, long long edges, long long n, const void* list,
                                    const void* eoff, const void* total, const void* indptr,
                                    const void* cols, const void* values, void* d, void* hits,
                                    void* changed, void* touched, void* tcount, void* tclear,
                                    void* next_list, void* next_eoff, void* next_word,
                                    void* clear_word, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  sssp_push_kernel<<<walk_blocks(edges, k), kThreads, 0, s>>>(
      walk_of(k, total, list, eoff, indptr, cols), static_cast<const float*>(values),
      static_cast<const float*>(d), static_cast<float*>(hits), static_cast<uint8_t*>(changed),
      static_cast<int32_t*>(touched), static_cast<int32_t*>(tcount), static_cast<int32_t*>(tclear),
      static_cast<unsigned long long*>(clear_word));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  launch_sssp_touched(edges < n ? edges : n, static_cast<const int32_t*>(touched),
                      static_cast<const int32_t*>(tcount), static_cast<float*>(hits),
                      static_cast<float*>(d), static_cast<uint8_t*>(changed),
                      static_cast<const int32_t*>(indptr), static_cast<int32_t*>(next_list),
                      static_cast<int32_t*>(next_eoff), static_cast<unsigned long long*>(next_word), s);
  return static_cast<int>(cudaGetLastError());
}
