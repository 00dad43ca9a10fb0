// Kernel 7's templated instances (spmv_staged.cuh holds the kernel and says
// what bounds it): mul in {PLUS, MULT, FIRST, SECOND, MIN, MAX} x add in
// {PLUS, MIN, MAX}, f32, and the structural variant, each at 2, 3 and 4
// slots.  The generic family is spmv_staged_generic.cu.

#include "spmv_staged.cuh"

// units: int4 [nunits]; unit_hub: int32 [nunits]; hub_units: int32 [nhub, 2];
// part: 32-bit words [nunits], part_any: uint8 [nunits], done: int32 [nhub] (zero), or
// null without hubs; x: f32 [n]; x_valid, row_sel: bool or null; init: f32
// on the device, or null and its bits in init_bits; out: f32 [m]; has: bool
// [m] or null.
extern "C" int spla_spmv_staged(int mul, int add, int slots, int stage, long long nunits, const void* units,
                                const void* unit_hub, const void* hub_units, void* part, void* part_any,
                                void* done, const void* indptr, const void* cols, const void* values,
                                const void* x, const void* x_valid, const void* row_sel, const void* init,
                                unsigned init_bits, void* out, void* has, void* stream) {
  if (nunits == 0) return 0;
  if (!valid_plan(stage)) return static_cast<int>(cudaErrorInvalidValue);
  StagedLaunch launch{slots, plan_of(stage, nunits, units, unit_hub, hub_units, part, part_any, done, indptr),
                      value_args(cols, values, x, x_valid, row_sel, init, init_bits, out, has, 0, false),
                      static_cast<cudaStream_t>(stream), cudaSuccess};
  if (!dispatch_mul<true, float>(mul, add, launch)) return -1;
  return static_cast<int>(launch.err);
}

// x_valid: bool [n]; row_sel: bool [m] or null; hits: bool [m], zero at
// launch where the plan has hubs.
extern "C" int spla_spmv_staged_structural(int slots, int stage, long long nunits, const void* units,
                                           const void* unit_hub, const void* indptr, const void* cols,
                                           const void* x_valid, const void* row_sel, void* hits,
                                           void* stream) {
  if (nunits == 0) return 0;
  if (!valid_plan(stage)) return static_cast<int>(cudaErrorInvalidValue);
  StagedLaunch launch{slots,
                      plan_of(stage, nunits, units, unit_hub, nullptr, nullptr, nullptr, nullptr, indptr),
                      {static_cast<const int32_t*>(cols), nullptr, nullptr,
                       static_cast<const uint8_t*>(x_valid), static_cast<const uint8_t*>(row_sel), nullptr,
                       0.f, nullptr, static_cast<uint8_t*>(hits), 0, false},
                      static_cast<cudaStream_t>(stream), cudaSuccess};
  launch.by_slots<KC_PLUS, KC_MAX, true>();
  return static_cast<int>(launch.err);
}
