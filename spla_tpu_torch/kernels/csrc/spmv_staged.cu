// Kernel 7: the staged-stream CSR pull SpMV.  Kernel 1's function
// (spmv_pull.cu:1-25) for f32,
//   out[i] = init (+) fold_(+) { mul(M[i,j], x[j]) : x_valid[j] },  has[i] = any product,
// with the row-select mask fused, and a structural variant
//   hits[i] = row_sel[i] && any stored (i, j) with x_valid[j].
//
// Replaces spla_tpu/pallas/spmv.py fused_cell_spmv_apply_manual (:2140), the
// TPU SpMV whose fused stream stays in HBM while `slots` VMEM buffers are
// filled by make_async_copy one batch ahead of the compute.  Here the column
// and value streams of plain CSR go through a ring of `slots` shared-memory
// stages (staged.cuh): cp.async keeps slots - 1 stages in flight while the CTA
// folds the current one.  x is gathered from global memory (L2), as in
// kernel 1; the TPU kernel keeps x whole in VMEM.
//
// Bound: bytes, as kernel 1 (4-byte column + 4-byte value + a gathered x
// element per entry; indptr and the output per row).  What the ring changes
// is only when the stream's bytes are asked for: a stage's lines are all in
// flight at once, ahead of the dependent x gathers, instead of one warp's
// 128 bytes per load as each row's loop reaches them.
//
// Folding a stage: a block of several rows (fewer than `stage` entries) is
// folded a warp per row, lanes striding the row as kernel 1 does, so these
// rows fold in kernel 1's order.  A block of one row is folded by the whole
// CTA; each thread carries its partial across the row's stages in registers
// and the CTA folds the partials after the last stage.
//
// Coverage (compile time): mul in {PLUS, MULT, FIRST, SECOND, MIN, MAX}, add
// in {PLUS, MIN, MAX}, f32, and the structural variant, each at 2, 3 and 4
// slots.

#include "staged.cuh"

template <int MUL, int ADD, bool STRUCT>
struct SpmvStage {
  RowBlocks p;
  uint32_t* ring_cols;
  uint32_t* ring_vals;
  int slot_w;
  const int32_t* cols;
  const float* values;
  const float* x;
  const uint8_t* x_valid;
  const uint8_t* row_sel;
  float init_v;
  float* out;
  uint8_t* has;  // the structural variant's hits
  float* red;
  uint8_t* red_any;
  float acc;  // a one-row block's partial, carried across its stages
  bool any;

  __device__ void copy(int slot, const Cursor& c) {
    const long long e0 = c.e0(p), e1 = c.e1(p);
    copy_words(ring_cols + slot * slot_w, cols, e0, e1);
    if (!STRUCT) copy_words(ring_vals + slot * slot_w, values, e0, e1);
  }

  __device__ void consume(int slot, const Cursor& c) {
    const long long e0 = c.e0(p);
    const int len = static_cast<int>(c.e1(p) - e0);
    // sc[k - e0] = cols[k], sv[k - e0] = values[k]
    const int32_t* sc = reinterpret_cast<const int32_t*>(ring_cols + slot * slot_w) + line_offset(cols, e0);
    const float* sv =
        STRUCT ? nullptr : reinterpret_cast<const float*>(ring_vals + slot * slot_w) + line_offset(values, e0);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (c.r1 - c.r0 == 1) {
      const int32_t row = c.r0;
      const bool sel = row_sel == nullptr || row_sel[row];
      if (c.part == 0) {
        acc = monoid_identity<ADD, float>();
        any = false;
      }
      if (sel) {
        for (int k = threadIdx.x; k < len; k += kThreads) {
          const int32_t col = sc[k];
          if (x_valid != nullptr && !x_valid[col]) continue;
          if (!STRUCT) acc = apply_op<ADD>(acc, apply_op<MUL>(sv[k], x[col]));
          any = true;
        }
      }
      if (!c.last()) return;
      if (STRUCT) {
        const int hit = __syncthreads_or(any);
        if (threadIdx.x == 0) has[row] = sel && hit;
        return;
      }
      float v = acc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v = apply_op<ADD>(v, __shfl_xor_sync(kFullMask, v, off));
      const bool a = __any_sync(kFullMask, any);
      if (lane == 0) {
        red[warp] = v;
        red_any[warp] = a;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        float total = red[0];
        bool hit = red_any[0];
        for (int w = 1; w < kWarps; ++w) {
          total = apply_op<ADD>(total, red[w]);
          hit = hit || red_any[w];
        }
        out[row] = hit ? apply_op<ADD>(init_v, total) : init_v;
        if (has != nullptr) has[row] = hit;
      }
      return;
    }
    for (int32_t row = c.r0 + warp; row < c.r1; row += kWarps) {
      if (row_sel != nullptr && !row_sel[row]) {
        if (lane == 0) {
          if (STRUCT) {
            has[row] = 0;
          } else {
            out[row] = init_v;
            if (has != nullptr) has[row] = 0;
          }
        }
        continue;
      }
      const int end = static_cast<int>(p.indptr[row + 1] - e0);
      float v = monoid_identity<ADD, float>();
      bool a = false;
      for (int k = static_cast<int>(p.indptr[row] - e0) + lane; k < end; k += 32) {
        const int32_t col = sc[k];
        if (x_valid != nullptr && !x_valid[col]) continue;
        if (!STRUCT) v = apply_op<ADD>(v, apply_op<MUL>(sv[k], x[col]));
        a = true;
      }
      a = __any_sync(kFullMask, a);
      if constexpr (STRUCT) {
        if (lane == 0) has[row] = a;
      } else {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v = apply_op<ADD>(v, __shfl_xor_sync(kFullMask, v, off));
        if (lane == 0) {
          out[row] = a ? apply_op<ADD>(init_v, v) : init_v;
          if (has != nullptr) has[row] = a;
        }
      }
    }
  }
};

template <int SLOTS, int MUL, int ADD, bool STRUCT>
__global__ void __launch_bounds__(kThreads)
spmv_staged_kernel(RowBlocks p, const int32_t* __restrict__ cols, const float* __restrict__ values,
                   const float* __restrict__ x, const uint8_t* __restrict__ x_valid,
                   const uint8_t* __restrict__ row_sel, const float* __restrict__ init,
                   float* __restrict__ out, uint8_t* __restrict__ has) {
  extern __shared__ __align__(16) uint32_t ring[];
  __shared__ float red[kWarps];
  __shared__ uint8_t red_any[kWarps];
  const int slot_w = slot_words(p.stage);
  SpmvStage<MUL, ADD, STRUCT> body{p, ring, ring + SLOTS * slot_w, slot_w, cols, values, x, x_valid,
                                   row_sel, STRUCT ? 0.f : *init, out, has, red, red_any,
                                   monoid_identity<ADD, float>(), false};
  ring_loop<SLOTS>(p, body);
}

namespace {

struct StagedLaunch {
  int slots;
  RowBlocks p;
  const void *cols, *values, *x, *x_valid, *row_sel, *init;
  void *out, *has;
  cudaStream_t stream;
  cudaError_t err;

  template <int SLOTS, int MUL, int ADD, bool STRUCT>
  void launch() {
    const auto kernel = spmv_staged_kernel<SLOTS, MUL, ADD, STRUCT>;
    const size_t smem = sizeof(uint32_t) * SLOTS * slot_words(p.stage) * (STRUCT ? 1 : 2);
    unsigned grid = 0;
    err = ring_grid(kernel, smem, p.nblocks, &grid);
    if (err != cudaSuccess) return;
    kernel<<<grid, kThreads, smem, stream>>>(
        p, static_cast<const int32_t*>(cols), static_cast<const float*>(values),
        static_cast<const float*>(x), static_cast<const uint8_t*>(x_valid),
        static_cast<const uint8_t*>(row_sel), static_cast<const float*>(init),
        static_cast<float*>(out), static_cast<uint8_t*>(has));
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

}  // namespace

// block_rows: int32 [nblocks + 1]; x: f32 [n]; x_valid, row_sel: bool or null;
// init: f32 [1]; out: f32 [m]; has: bool [m] or null.
extern "C" int spla_spmv_staged(int mul, int add, int slots, int stage, long long nblocks,
                                const void* block_rows, const void* indptr, const void* cols,
                                const void* values, const void* x, const void* x_valid,
                                const void* row_sel, const void* init, void* out, void* has,
                                void* stream) {
  if (nblocks == 0) return 0;
  if (!valid_plan(stage)) return static_cast<int>(cudaErrorInvalidValue);
  StagedLaunch launch{slots,
                      {static_cast<const int32_t*>(block_rows), static_cast<const int32_t*>(indptr),
                       nblocks, stage},
                      cols, values, x, x_valid, row_sel, init, out, has,
                      static_cast<cudaStream_t>(stream), cudaSuccess};
  if (!dispatch_mul<true, float>(mul, add, launch)) return -1;
  return static_cast<int>(launch.err);
}

// x_valid: bool [n]; row_sel: bool [m] or null; hits: bool [m].
extern "C" int spla_spmv_staged_structural(int slots, int stage, long long nblocks,
                                           const void* block_rows, const void* indptr,
                                           const void* cols, const void* x_valid,
                                           const void* row_sel, void* hits, void* stream) {
  if (nblocks == 0) return 0;
  if (!valid_plan(stage)) return static_cast<int>(cudaErrorInvalidValue);
  StagedLaunch launch{slots,
                      {static_cast<const int32_t*>(block_rows), static_cast<const int32_t*>(indptr),
                       nblocks, stage},
                      cols, nullptr, nullptr, x_valid, row_sel, nullptr, nullptr, hits,
                      static_cast<cudaStream_t>(stream), cudaSuccess};
  launch.by_slots<KC_PLUS, KC_MAX, true>();
  return static_cast<int>(launch.err);
}
