// Kernel 3: the BFS / SSSP level update with frontier compaction.
//
// Replaces spla_tpu/pallas/spmv.py _level_update (:2789, pallas_call :2821)
// and its callers bfs_level_update (:2839) and sssp_level_update (:2846); the
// chunk-sparse bfs_level_update_auto (:2925) and sssp_level_update_auto
// (:2858), which skip chunks no hit reaches, have their counterpart in the
// fused push levels of kernel 2 (spmv_push.cu) and in the touched update
// below, whose cost follows the frontier and not n.
//
// * The stream update of a pull level, four vertices a thread (their bytes
//   of hits and front, or their distances and hits, in one access each):
//     BFS:  v' = front ? depth : v;  front' = hits and v' == 0;
//     SSSP: v' = min(v, hits) (semiring.cuh op_min: NaN propagates, -0 below +0);  changed = v' < v;
//   each vertex of the new frontier (or changed set) appended to the next
//   list, one atomicAdd a block of 1,024 vertices.  In the level loop
//   (`wide`) the list is one of frontier.cuh's, with its degree prefix, so
//   that the next push level can balance its edges; the kernel zeroes the
//   size word of the level after, so the loop launches nothing to clear it;
//   and BFS ORs the new frontier into the visited bitmap of the push levels
//   (visited: v != 0 or in the frontier), eight lanes a word.  The public
//   entries keep the plain list and its int32 count, zeroed with
//   cudaMemsetAsync before the launch.
// * The touched update of an SSSP push level, one thread a touched vertex j:
//   the same min and changed test against hits[j], the append, and hits[j]
//   put back to +inf for the next push level.
//
// Bound: bytes.  The BFS stream reads hits and front (1 + 1 bytes a
// vertex), and v only where a hit lands outside the frontier; SSSP reads 4 +
// 4.  It writes v only where it changes, front where it changes (SSSP:
// changed everywhere), and 4 bytes a listed vertex (8 with its offset, and
// its degree read).  The touched update moves ~14 bytes a touched vertex,
// gathered from random places, so on a push level that touches most
// vertices it costs more than a stream would (PERF.md).  The Triton kernel
// this replaced wrote v and front everywhere, and its launcher cost more
// host time than the device spent.  Two first versions here, a vertex a
// thread with an atomic a warp on the list's size (32,768 atomics on one
// word at n = 2^20), then with an atomic a block, ran 3.3x and 1.2-1.7x
// slower than it at n = 2^20.

#include "frontier.cuh"

namespace {

constexpr int kStreamThreads = 256;
constexpr int kPerThread = 4;  // vertices a thread of the streams: one atomic a block of 1,024

__device__ __forceinline__ long long global_thread() {
  return static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
}

// `vec`: hits and front are 4-byte aligned, so a thread reads and writes its
// four bytes of each in one access.
template <bool WIDE>
__global__ void __launch_bounds__(kStreamThreads)
bfs_update_kernel(int32_t n, bool vec, const uint8_t* __restrict__ hits, int32_t* __restrict__ v,
                  uint8_t* __restrict__ front, int32_t depth, int32_t* __restrict__ list,
                  int32_t* __restrict__ eoff, void* count, const int32_t* __restrict__ indptr,
                  uint32_t* __restrict__ vis, unsigned long long* __restrict__ clear) {
  const long long t = global_thread(), i0 = t * kPerThread;
  const int lane = threadIdx.x & 31;
  if (WIDE && t == 0) *clear = 0;
  const bool whole = vec && i0 + kPerThread <= n;
  bool h[kPerThread], f[kPerThread], fnew[kPerThread];
  int32_t j[kPerThread], deg[kPerThread];
  if (whole) {
    const uint32_t h4 = *reinterpret_cast<const uint32_t*>(hits + i0);
    const uint32_t f4 = *reinterpret_cast<const uint32_t*>(front + i0);
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      h[u] = (h4 >> (8 * u)) & 0xffu;
      f[u] = (f4 >> (8 * u)) & 0xffu;
    }
  } else {
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      h[u] = i0 + u < n && hits[i0 + u];
      f[u] = i0 + u < n && front[i0 + u];
    }
  }
  bool moved = false;
  uint32_t f_out = 0, nibble = 0;
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const long long i = i0 + u;
    j[u] = static_cast<int32_t>(i);
    fnew[u] = false;
    if (f[u]) v[i] = depth;  // v' = depth, never 0, so the frontier leaves fnew false
    else if (h[u]) fnew[u] = v[i] == 0;
    moved = moved || f[u] != fnew[u];
    f_out |= static_cast<uint32_t>(fnew[u]) << (8 * u);
    nibble |= static_cast<uint32_t>(fnew[u]) << u;
    deg[u] = WIDE && fnew[u] ? __ldg(indptr + i + 1) - __ldg(indptr + i) : 0;
  }
  if (moved) {
    if (whole) {
      *reinterpret_cast<uint32_t*>(front + i0) = f_out;
    } else {
#pragma unroll
      for (int u = 0; u < kPerThread; ++u)
        if (f[u] != fnew[u]) front[i0 + u] = fnew[u];
    }
  }
  if constexpr (WIDE) {
    // visited' = v' != 0 or fnew = (v != 0 or f) or fnew = visited or fnew.
    // Eight lanes hold a word's 32 vertices, and only they write it.
    uint32_t bits = nibble << (4 * (lane & 7));
    bits |= __shfl_xor_sync(kFullMask, bits, 1);
    bits |= __shfl_xor_sync(kFullMask, bits, 2);
    bits |= __shfl_xor_sync(kFullMask, bits, 4);
    if ((lane & 7) == 0 && i0 < n && bits) vis[i0 >> 5] |= bits;
  }
  block_append<WIDE, kStreamThreads>(fnew, j, deg, list, eoff, count);
}

// `vec`: hits and v are 16-byte aligned and changed 4-byte aligned, so a
// thread reads its four distances and hits, and writes its four bytes of
// changed, in one access each.
template <bool WIDE>
__global__ void __launch_bounds__(kStreamThreads)
sssp_update_kernel(int32_t n, bool vec, const float* __restrict__ hits, float* __restrict__ v,
                   uint8_t* __restrict__ changed, int32_t* __restrict__ list,
                   int32_t* __restrict__ eoff, void* count, const int32_t* __restrict__ indptr,
                   unsigned long long* __restrict__ clear) {
  const long long t = global_thread(), i0 = t * kPerThread;
  if (WIDE && t == 0) *clear = 0;
  const bool whole = vec && i0 + kPerThread <= n;
  const float inf = __uint_as_float(kInfBits);
  float h[kPerThread], vi[kPerThread];
  if (whole) {
    const float4 h4 = *reinterpret_cast<const float4*>(hits + i0);
    const float4 v4 = *reinterpret_cast<const float4*>(v + i0);
    h[0] = h4.x, h[1] = h4.y, h[2] = h4.z, h[3] = h4.w;
    vi[0] = v4.x, vi[1] = v4.y, vi[2] = v4.z, vi[3] = v4.w;
  } else {
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      h[u] = i0 + u < n ? hits[i0 + u] : inf;
      vi[u] = i0 + u < n ? v[i0 + u] : inf;
    }
  }
  bool ch[kPerThread];
  int32_t j[kPerThread], deg[kPerThread];
  uint32_t c_out = 0;
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const long long i = i0 + u;
    const float v2 = op_min(vi[u], h[u]);
    ch[u] = v2 < vi[u];
    if (__float_as_uint(v2) != __float_as_uint(vi[u])) v[i] = v2;  // never past n: h is +inf there
    c_out |= static_cast<uint32_t>(ch[u]) << (8 * u);
    j[u] = static_cast<int32_t>(i);
    deg[u] = WIDE && ch[u] ? __ldg(indptr + i + 1) - __ldg(indptr + i) : 0;
  }
  if (whole) {
    *reinterpret_cast<uint32_t*>(changed + i0) = c_out;
  } else {
#pragma unroll
    for (int u = 0; u < kPerThread; ++u)
      if (i0 + u < n) changed[i0 + u] = ch[u];
  }
  block_append<WIDE, kStreamThreads>(ch, j, deg, list, eoff, count);
}

__global__ void __launch_bounds__(kThreads)
sssp_touched_kernel(const int32_t* __restrict__ touched, const int32_t* __restrict__ tcount,
                    float* __restrict__ hits, float* __restrict__ v, uint8_t* __restrict__ changed,
                    const int32_t* __restrict__ indptr, int32_t* __restrict__ list,
                    int32_t* __restrict__ eoff, unsigned long long* __restrict__ word) {
  const int32_t total = *tcount;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // the loop's bounds are the block's, so that every thread reaches each append
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x; base < total; base += stride) {
    const long long t = base + threadIdx.x;
    bool ch = false;
    int32_t j = 0, deg = 0;
    if (t < total) {
      j = touched[t];
      const float h = hits[j], vj = v[j];
      hits[j] = __uint_as_float(kInfBits);
      const float v2 = op_min(vj, h);
      ch = v2 < vj;
      if (__float_as_uint(v2) != __float_as_uint(vj)) v[j] = v2;
      if (ch) {
        changed[j] = 1;
        deg = __ldg(indptr + j + 1) - __ldg(indptr + j);
      }
    }
    const bool want[1] = {ch};
    const int32_t jj[1] = {j}, dd[1] = {deg};
    block_append<true, kThreads>(want, jj, dd, list, eoff, word);
  }
}

unsigned stream_blocks(long long n) {
  constexpr long long per_block = static_cast<long long>(kStreamThreads) * kPerThread;
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

bool aligned(const void* p, unsigned bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

void launch_sssp_touched(long long bound, const int32_t* touched, const int32_t* tcount, float* hits,
                         float* v, uint8_t* changed, const int32_t* indptr, int32_t* next_list,
                         int32_t* next_eoff, unsigned long long* next_word, cudaStream_t stream) {
  sssp_touched_kernel<<<walk_blocks(0, bound), kThreads, 0, stream>>>(
      touched, tcount, hits, v, changed, indptr, next_list, next_eoff, next_word);
}

// `wide`: the level loop's list (eoff, a 64-bit size word at `count`, the
// size word `clear` of the level after, the visited bitmap `vis`); else a
// plain list and an int32 count, zeroed here first.
extern "C" int spla_bfs_level_update(long long n, const void* hits, void* v, void* front, int depth,
                                     void* list, void* count, int wide, void* eoff,
                                     const void* indptr, void* vis, void* clear, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!wide) {
    const cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  auto kernel = wide ? bfs_update_kernel<true> : bfs_update_kernel<false>;
  kernel<<<stream_blocks(n), kStreamThreads, 0, s>>>(
      static_cast<int32_t>(n), aligned(hits, 4) && aligned(front, 4), static_cast<const uint8_t*>(hits),
      static_cast<int32_t*>(v),
      static_cast<uint8_t*>(front), depth, static_cast<int32_t*>(list), static_cast<int32_t*>(eoff),
      count, static_cast<const int32_t*>(indptr), static_cast<uint32_t*>(vis),
      static_cast<unsigned long long*>(clear));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spla_sssp_level_update(long long n, const void* hits, void* v, void* changed,
                                      void* list, void* count, int wide, void* eoff,
                                      const void* indptr, void* clear, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!wide) {
    const cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  auto kernel = wide ? sssp_update_kernel<true> : sssp_update_kernel<false>;
  kernel<<<stream_blocks(n), kStreamThreads, 0, s>>>(
      static_cast<int32_t>(n), aligned(hits, 16) && aligned(v, 16) && aligned(changed, 4),
      static_cast<const float*>(hits), static_cast<float*>(v),
      static_cast<uint8_t*>(changed), static_cast<int32_t*>(list), static_cast<int32_t*>(eoff), count,
      static_cast<const int32_t*>(indptr), static_cast<unsigned long long*>(clear));
  return static_cast<int>(cudaGetLastError());
}
