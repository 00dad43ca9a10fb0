// Kernel 1's generic family without a mask (spmv_pull.cuh holds the kernel
// and says what bounds it): one instance per (dtype, add, team size) whose
// mul is a kernel argument, switched on per product (the same in every lane
// of a launch), with mul(x[j], M[i,j]) when swap is set (vxm's product order
// for a mul that does not commute).  f32 with add in {PLUS, MIN, MAX}; i32
// and u32 with add in {PLUS, MULT, MIN, MAX, LOR, BOR, BAND, BXOR}; every
// built-in mul (semiring.cuh apply_runtime).  Requests the templated
// instances cover go there (kernels/spmv.py); this family serves the rest,
// and any of them when the wrapper asks for it by name (to time the two
// against each other).  The family with a mask is spmv_pull_generic_masked.cu.

#include "spmv_pull.cuh"

extern "C" int spla_spmv_pull_generic(int mul, int swap, int add, int dtype, long long m, int log2g, int hub_len,
                                      long long nhub, long long nchunks, const void* chunk_row, const void* chunk_c0,
                                      const void* chunk_c1, const void* chunk_hub, const void* chunk_first,
                                      int segments, long long nitems, long long nshort, const void* items,
                                      const void* short_rows, const void* cuts, void* part, void* part_any,
                                      void* done, const void* indptr, const void* cols, const void* values,
                                      const void* x, const void* x_bits, const void* row_sel, const void* init,
                                      unsigned init_bits, void* out, void* has, void* stream) {
  return pull_entry<true, false>(mul, swap != 0, add, dtype, m, log2g, hub_len, nhub, nchunks, chunk_row, chunk_c0,
                                 chunk_c1, chunk_hub, chunk_first, segments, nitems, nshort, items, short_rows, cuts,
                                 part, part_any, done, indptr, cols, values, x, x_bits, row_sel, init, init_bits,
                                 out, has, stream);
}
