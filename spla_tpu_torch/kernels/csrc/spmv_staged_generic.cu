// Kernel 7's generic family (spmv_staged.cuh holds the kernel and says what
// bounds it): one instance per (slots, add), f32, add in {PLUS, MIN, MAX},
// whose mul is a kernel argument, switched on per product (the same in every
// lane of a launch), with mul(x[j], M[i,j]) when swap is set (vxm's product
// order for MINUS, DIV and MINUS_POW2), as kernel 1's generic family
// (spmv_pull_generic.cu).  Requests the templated instances cover go there
// (kernels/staged.py); this family serves the rest of spla_tpu's manual-DMA
// requests, and any of them when the wrapper asks for it by name (to time
// the two against each other).

#include "spmv_staged.cuh"

// mul, swap, add, then spla_spmv_staged's arguments from slots on.
extern "C" int spla_spmv_staged_generic(int mul, int swap, int add, int slots, int stage, long long nunits,
                                        const void* units, const void* unit_hub, const void* hub_units, void* part,
                                        void* part_any, void* done, const void* indptr, const void* cols,
                                        const void* values, const void* x, const void* x_valid,
                                        const void* row_sel, const void* init, unsigned init_bits, void* out,
                                        void* has, void* stream) {
  if (nunits == 0) return 0;
  if (!valid_plan(stage) || !runtime_mul_ok(mul, DT_F32)) return static_cast<int>(cudaErrorInvalidValue);
  StagedLaunch launch{slots, plan_of(stage, nunits, units, unit_hub, hub_units, part, part_any, done, indptr),
                      value_args(cols, values, x, x_valid, row_sel, init, init_bits, out, has, mul, swap != 0),
                      static_cast<cudaStream_t>(stream), cudaSuccess};
  if (!dispatch_generic<true, false, false, false>(add, DT_F32, launch)) return -1;
  return static_cast<int>(launch.err);
}
