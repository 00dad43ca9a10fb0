// Kernel 7: the staged-stream CSR pull SpMV.  Kernel 1's function
// (spmv_pull.cuh:1-33) for f32,
//   out[i] = init (+) fold_(+) { mul(M[i,j], x[j]) : x_valid[j] },  has[i] = any product,
// with the row-select mask fused, and a structural variant
//   hits[i] = row_sel[i] && any stored (i, j) with x_valid[j].
//
// Replaces spla_tpu/pallas/spmv.py fused_cell_spmv_apply_manual (:2140), the
// TPU SpMV whose fused stream stays in HBM while `slots` VMEM buffers are
// filled by make_async_copy one batch ahead of the compute.  Here the column
// and value streams of plain CSR, and each unit's row pointers, go through a
// ring of `slots` shared-memory stages (staged.cuh): cp.async keeps
// slots - 1 stages in flight while the CTA folds the current one.  x is
// gathered from global memory (L2), as in kernel 1; the TPU kernel keeps x
// whole in VMEM.
//
// Bound: bytes, as kernel 1 (4-byte column + 4-byte value + a gathered x
// element per entry; indptr and the output per row).  On random columns the
// x gathers set the floor (kernel 8's flat_gather), so the design keeps as
// many of them in flight as kernel 1 does:
//   * staged_plan packs rows into stages of close to `stage` entries (a
//     unit of several rows), and cuts rows longer than stage / 4 into
//     chunks of up to four stages, each chunk a unit of CTA work;
//   * a stage of several rows is folded by teams of G lanes a row, G picked
//     per stage from its mean row length so that a lane takes about four
//     entries; a long row's stage by the whole CTA, four entries a thread;
//     either way every lane issues its four x gathers before it folds any
//     (staged_fold.cuh);
//   * the producer reads each unit's descriptor once, ahead of its copies,
//     and the fold finds it beside its slot.
//
// Coverage (compile time): mul in {PLUS, MULT, FIRST, SECOND, MIN, MAX}, add
// in {PLUS, MIN, MAX}, f32, and the structural variant, each at 2, 3 and 4
// slots.

#include <cstring>

#include "staged_fold.cuh"

// At least 6 CTAs an SM, so at most 40 registers a thread: enough to hold a
// lane's four gathers in flight (at 32 the compiler gives up some of them),
// and no more, which would cost CTAs.
template <int SLOTS, int MUL, int ADD, bool STRUCT>
__global__ void __launch_bounds__(kThreads, 6)
spmv_staged_kernel(Plan p, StagedArgs a) {
  extern __shared__ __align__(16) uint32_t ring[];
  auto body = staged_fold<SLOTS, MUL, ADD, STRUCT>(p, a, ring);
  ring_loop<SLOTS>(p, body);
}

namespace {

struct StagedLaunch {
  int slots;
  Plan p;
  StagedArgs a;
  cudaStream_t stream;
  cudaError_t err;

  template <int SLOTS, int MUL, int ADD, bool STRUCT>
  void launch() {
    const auto kernel = spmv_staged_kernel<SLOTS, MUL, ADD, STRUCT>;
    static thread_local GridCache cache;
    const size_t smem = ring_bytes<STRUCT>(SLOTS, p.stage);
    unsigned grid = 0;
    err = ring_grid(kernel, smem, p.nunits, cache, &grid);
    if (err != cudaSuccess) return;
    kernel<<<grid, kThreads, smem, stream>>>(p, a);
    err = cudaGetLastError();
  }

  template <int MUL, int ADD, bool STRUCT>
  void by_slots() {
    switch (slots) {
      case 2: launch<2, MUL, ADD, STRUCT>(); break;
      case 3: launch<3, MUL, ADD, STRUCT>(); break;
      case 4: launch<4, MUL, ADD, STRUCT>(); break;
      default: err = cudaErrorInvalidValue;
    }
  }

  // the functor semiring.cuh's dispatch calls
  template <typename T, int MUL, int ADD>
  void run() {
    by_slots<MUL, ADD, false>();
  }
};

bool valid_plan(int stage) { return stage >= 2 && stage <= kMaxStage; }

Plan plan_of(int stage, long long nunits, const void* units, const void* unit_hub, const void* hub_units,
             void* part, void* part_any, void* done, const void* indptr) {
  return {static_cast<const int4*>(units), static_cast<const int32_t*>(unit_hub),
          static_cast<const int32_t*>(hub_units), static_cast<const int32_t*>(indptr), part,
          static_cast<uint8_t*>(part_any), static_cast<int32_t*>(done), nunits, stage};
}

}  // namespace

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
  float init_value;
  memcpy(&init_value, &init_bits, sizeof(float));
  StagedLaunch launch{slots,
                      plan_of(stage, nunits, units, unit_hub, hub_units, part, part_any, done, indptr),
                      {static_cast<const int32_t*>(cols), static_cast<const float*>(values),
                       static_cast<const float*>(x), static_cast<const uint8_t*>(x_valid),
                       static_cast<const uint8_t*>(row_sel), static_cast<const float*>(init), init_value,
                       static_cast<float*>(out), static_cast<uint8_t*>(has)},
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
                       0.f, nullptr, static_cast<uint8_t*>(hits)},
                      static_cast<cudaStream_t>(stream), cudaSuccess};
  launch.by_slots<KC_PLUS, KC_MAX, true>();
  return static_cast<int>(launch.err);
}
