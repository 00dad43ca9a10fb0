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
// Coverage, each at 2, 3 and 4 slots: the templated instances
// (spmv_staged.cu), mul in {PLUS, MULT, FIRST, SECOND, MIN, MAX} x add in
// {PLUS, MIN, MAX}, f32, and the structural variant; the generic family
// (spmv_staged_generic.cu), one instance per add in {PLUS, MIN, MAX}, f32,
// whose mul is a kernel argument (every built-in mul of f32, with its
// operands swapped where vxm asks: semiring.cuh apply_runtime), as kernel
// 1's generic family.  Together they take every f32 request of spla_tpu's
// manual-DMA kernel (kernels/staged.py staged_codes).  This header holds the
// kernel and its launch; each of the two sources compiles its own
// instances, in parallel.
#pragma once

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

// The arguments of a value launch; `mul` and `swap` are the generic family's.
StagedArgs value_args(const void* cols, const void* values, const void* x, const void* x_valid,
                      const void* row_sel, const void* init, unsigned init_bits, void* out, void* has, int mul,
                      bool swap) {
  float init_value;
  memcpy(&init_value, &init_bits, sizeof(float));
  return {static_cast<const int32_t*>(cols), static_cast<const float*>(values), static_cast<const float*>(x),
          static_cast<const uint8_t*>(x_valid), static_cast<const uint8_t*>(row_sel),
          static_cast<const float*>(init), init_value, static_cast<float*>(out), static_cast<uint8_t*>(has),
          mul, swap};
}

bool valid_plan(int stage) { return stage >= 2 && stage <= kMaxStage; }

Plan plan_of(int stage, long long nunits, const void* units, const void* unit_hub, const void* hub_units,
             void* part, void* part_any, void* done, const void* indptr) {
  return {static_cast<const int4*>(units), static_cast<const int32_t*>(unit_hub),
          static_cast<const int32_t*>(hub_units), static_cast<const int32_t*>(indptr), part,
          static_cast<uint8_t*>(part_any), static_cast<int32_t*>(done), nunits, stage};
}

}  // namespace

