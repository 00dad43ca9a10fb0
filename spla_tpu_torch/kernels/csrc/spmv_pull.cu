// Kernel 1's templated instances without a mask (spmv_pull.cuh holds the
// kernel and says what bounds it): mul in {PLUS, MULT, FIRST, SECOND, MIN,
// MAX} x add in {PLUS, MIN, MAX} x {f32, i32} x the five team sizes; the
// structural variant; and the pack of the x-validity mask into the bitmap
// that the masked instances and the structural variant read.  The masked
// templated instances are spmv_pull_masked.cu, the generic family
// spmv_pull_generic.cu and spmv_pull_generic_masked.cu.

#include "spmv_pull.cuh"

namespace {

constexpr int kPackWords = 8;  // bit words a warp packs, one byte load a lane each, all issued first

// bits[w] bit b = (valid[32 w + b] != 0), 0 past n.  Each load of a warp
// reads 32 consecutive bytes (one sector) with the streaming hint, since
// the bytes are read once; the first kPackWords lanes store the words.
__global__ void __launch_bounds__(kThreads)
pack_valid_bits_kernel(long long n, const uint8_t* valid, uint32_t* bits) {
  const long long words = (n + 31) >> 5;
  const long long w0 = (static_cast<long long>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5)) * kPackWords;
  const int lane = threadIdx.x & 31;
  uint8_t b[kPackWords];
#pragma unroll
  for (int u = 0; u < kPackWords; ++u) {
    const long long j = ((w0 + u) << 5) + lane;
    b[u] = j < n ? __ldcs(valid + j) : 0;
  }
  uint32_t mine = 0;
#pragma unroll
  for (int u = 0; u < kPackWords; ++u) {
    const uint32_t word = __ballot_sync(kFullMask, b[u] != 0);
    if (lane == u) mine = word;
  }
  if (lane < kPackWords && w0 + lane < words) bits[w0 + lane] = mine;
}

}  // namespace

extern "C" int spla_spmv_pull(int mul, int add, int dtype, long long m, int log2g, int hub_len, long long nhub,
                              long long nchunks, const void* chunk_row, const void* chunk_c0, const void* chunk_c1,
                              const void* chunk_hub, const void* chunk_first, int segments, long long nitems,
                              long long nshort, const void* items, const void* short_rows, const void* cuts,
                              void* part, void* part_any, void* done, const void* indptr, const void* cols,
                              const void* values, const void* x, const void* x_bits, const void* row_sel,
                              const void* init, unsigned init_bits, void* out, void* has, void* stream) {
  return pull_entry<false, false>(mul, false, add, dtype, m, log2g, hub_len, nhub, nchunks, chunk_row, chunk_c0,
                                  chunk_c1, chunk_hub, chunk_first, segments, nitems, nshort, items, short_rows,
                                  cuts, part, part_any, done, indptr, cols, values, x, x_bits, row_sel, init,
                                  init_bits, out, has, stream);
}

extern "C" int spla_pack_valid_bits(long long n, const void* valid, void* bits, void* stream) {
  if (n == 0) return 0;
  const long long words = (n + 31) >> 5;
  const long long per_cta = static_cast<long long>(kWarpsPerCta) * kPackWords;
  pack_valid_bits_kernel<<<static_cast<unsigned>((words + per_cta - 1) / per_cta), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(n, static_cast<const uint8_t*>(valid),
                                                                static_cast<uint32_t*>(bits));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spla_spmv_pull_structural(long long m, int log2g, int hub_len, long long nhub, long long nchunks,
                                         const void* chunk_row, const void* chunk_c0, const void* chunk_c1,
                                         const void* chunk_hub, const void* chunk_first, const void* indptr,
                                         const void* cols, const void* x_bits, const void* row_sel, void* hits,
                                         void* stream) {
  if (m == 0) return 0;
  const PullPlan plan = plan_of(log2g, hub_len, nhub, nchunks, chunk_row, chunk_c0, chunk_c1, chunk_hub,
                                chunk_first, 1, nchunks, 0, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr);
  if (!plan_ok(plan)) return static_cast<int>(cudaErrorInvalidValue);
  const HitArgs a{m, static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(cols),
                  static_cast<const uint32_t*>(x_bits), static_cast<const uint8_t*>(row_sel),
                  static_cast<uint8_t*>(hits)};
  const unsigned grid = grid_of(m, plan);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log2g) {
    case 1: spmv_pull_structural_kernel<1><<<grid, kThreads, 0, s>>>(a, plan); break;
    case 2: spmv_pull_structural_kernel<2><<<grid, kThreads, 0, s>>>(a, plan); break;
    case 3: spmv_pull_structural_kernel<3><<<grid, kThreads, 0, s>>>(a, plan); break;
    case 4: spmv_pull_structural_kernel<4><<<grid, kThreads, 0, s>>>(a, plan); break;
    default: spmv_pull_structural_kernel<5><<<grid, kThreads, 0, s>>>(a, plan);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spla_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
