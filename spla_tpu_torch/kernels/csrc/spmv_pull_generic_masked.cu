// Kernel 1's generic family with an x-validity mask, read as the bitmap that
// spla_pack_valid_bits (spmv_pull.cu) packs: the instances of
// spmv_pull_generic.cu, compiled apart so that the two sets build in
// parallel.

#include "spmv_pull.cuh"

extern "C" int spla_spmv_pull_generic_masked(int mul, int swap, int add, int dtype, long long m, int log2g,
                                             int hub_len, long long nhub, long long nchunks, const void* chunk_row,
                                             const void* chunk_c0, const void* chunk_c1, const void* chunk_hub,
                                             const void* chunk_first, int segments, long long nitems,
                                             long long nshort, const void* items, const void* short_rows,
                                             const void* cuts, void* part, void* part_any, void* done,
                                             const void* indptr, const void* cols, const void* values, const void* x,
                                             const void* x_bits, const void* row_sel, const void* init,
                                             unsigned init_bits, void* out, void* has, void* stream) {
  return pull_entry<true, true>(mul, swap != 0, add, dtype, m, log2g, hub_len, nhub, nchunks, chunk_row, chunk_c0,
                                chunk_c1, chunk_hub, chunk_first, segments, nitems, nshort, items, short_rows, cuts,
                                part, part_any, done, indptr, cols, values, x, x_bits, row_sel, init, init_bits, out,
                                has, stream);
}
