// Kernel 1's templated instances (spmv_pull.cuh holds the kernel and says
// what bounds it): mul in {PLUS, MULT, FIRST, SECOND, MIN, MAX} x add in
// {PLUS, MIN, MAX} x {f32, i32} x the five team sizes, and the structural
// variant.  The generic family is spmv_pull_generic.cu.

#include "spmv_pull.cuh"

extern "C" int spla_spmv_pull(int mul, int add, int dtype, long long m, int log2g, int hub_len, long long nhub,
                              long long nchunks, const void* chunk_row, const void* chunk_c0,
                              const void* chunk_c1, const void* chunk_hub, const void* chunk_first,
                              void* part, void* part_any, void* done,
                              const void* indptr, const void* cols, const void* values, const void* x,
                              const void* x_valid, const void* row_sel, const void* init,
                              unsigned init_bits, void* out, void* has, void* stream) {
  if (m == 0) return 0;
  const PullPlan plan = plan_of(log2g, hub_len, nhub, nchunks, chunk_row, chunk_c0, chunk_c1, chunk_hub,
                                chunk_first, part, part_any, done);
  if (!plan_ok(plan)) return static_cast<int>(cudaErrorInvalidValue);
  PullLaunch launch{m, indptr, cols, values, x, x_valid, row_sel, init, init_bits, out, has, plan,
                    static_cast<cudaStream_t>(stream)};
  if (!dispatch<true>(mul, add, dtype, launch)) return -1;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spla_spmv_pull_structural(long long m, int log2g, int hub_len, long long nhub, long long nchunks,
                                         const void* chunk_row, const void* chunk_c0, const void* chunk_c1,
                                         const void* chunk_hub, const void* chunk_first, const void* indptr,
                                         const void* cols, const void* x_valid, const void* row_sel, void* hits,
                                         void* stream) {
  if (m == 0) return 0;
  const PullPlan plan = plan_of(log2g, hub_len, nhub, nchunks, chunk_row, chunk_c0, chunk_c1, chunk_hub,
                                chunk_first, nullptr, nullptr, nullptr);
  if (!plan_ok(plan)) return static_cast<int>(cudaErrorInvalidValue);
  const HitArgs a{m, static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(cols),
                  static_cast<const uint8_t*>(x_valid), static_cast<const uint8_t*>(row_sel),
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
