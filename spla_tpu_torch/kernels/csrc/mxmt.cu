// Kernels 4 and 5: masked SpGEMM-T by sorted-row intersection.  For each
// selected mask entry e = (i, j), the products mul(A[i,k], B[j,k]) over the
// columns k of B's row j that A's row i holds:
//   kernel 4, mxmt_reduce:  total  = sum of every product of every entry;
//   kernel 5, mxmt_masked:  out[e] = init (+) fold_(+) products(e), has[e].
//
// Replaces spla_tpu/pallas/mxmt.py pallas_mxmT_reduce (:335, kernel
// _make_reduce_kernel :235) and pallas_mxmT_job_partials (:362, kernel
// _make_partials_kernel :260) with the segment fold after it
// (spla_tpu/ops/spgemm.py:711).  The TPU has no gather, so a host packer
// (native/pairpack.cpp) cuts every mask entry into 8 x 8 chunk-pair jobs
// that the TPU kernel compares all-pairs.  On Hopper a lane reads A.cols[p]
// itself, so these kernels take the plain CSR of A and B and the mask's
// (row, col) lists, and nothing is built on the host.
//
// Bound: latency of dependent loads.  Per mask entry a warp reads two indptr
// pairs and B's row j (coalesced), then each lane bisects A's row i:
// ~log2(deg_i) dependent probes into the same 64-128 bytes for the whole
// warp, which L1 serves after the first.  Design against that bound:
//   * one warp per mask entry, lanes striding B's row j; the lower-bound
//     search makes the first of equal columns in A's row match, as
//     spla_tpu.utils.search.rowwise_find does, and every element of B's row
//     count, duplicates included;
//   * the selection (op_select of the mask value, and the mask's stored
//     range) comes in as one byte per entry: an unselected entry reads
//     nothing else;
//   * kernel 4 keeps a lane-local sum over a grid-stride loop of entries,
//     folds it with shuffles and shared memory, and adds one 64-bit atomic
//     per block.  i32 products sum in int64 (two's complement, as uint64),
//     hits of the structural instance in int64, f32 products in f64, so the
//     2^24 exactness gates of the TPU path (spla_tpu/algorithms.py:749-760)
//     have no counterpart here.  The f64 atomics add in no fixed order;
//   * kernel 5 folds each entry in the add monoid with shuffles and lane 0
//     writes out[e] and has[e]; the op layer compacts.
// At degree 16 half of a warp's lanes idle; sub-warp groups sized from the
// mean degree, or a merge-path split of hub rows, are later work.  Rows of
// 1e5 entries are correct but walked by one warp.
//
// Coverage (compile time): kernel 5, mul in {PLUS, MULT, FIRST, SECOND, MIN,
// MAX} x add in {PLUS, MIN, MAX} x {f32, i32}, and a structural instance per
// (add, dtype) whose every hit's product is 1; kernel 4, the 6 muls x
// {f32, i32} and a structural instance that counts hits and reads no values.

#include <type_traits>

#include "semiring.cuh"

namespace {

constexpr int kStruct = -1;            // MUL of the structural instances
constexpr unsigned kReduceMaxBlocks = 132 * 16;

// First position in cols[lo, hi) whose column is not below key.
__device__ __forceinline__ int32_t lower_bound(const int32_t* __restrict__ cols, int32_t lo,
                                               int32_t hi, int32_t key) {
  while (lo < hi) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    if (cols[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <int MUL, typename T>
__device__ __forceinline__ T product(const T* __restrict__ a_vals, int32_t p,
                                     const T* __restrict__ b_vals, int32_t t) {
  if constexpr (MUL == kStruct) {
    return T(1);
  } else {
    return apply_op<MUL>(a_vals[p], b_vals[t]);
  }
}

}  // namespace

struct MxmtOperands {
  const int32_t* mrow;
  const int32_t* mcol;
  const uint8_t* sel;
  const int32_t* a_indptr;
  const int32_t* a_cols;
  const void* a_vals;
  const int32_t* b_indptr;
  const int32_t* b_cols;
  const void* b_vals;
};

// The operands of one launch; kernels 4 and 5 take it by value.
inline MxmtOperands mxmt_operands(const void* mrow, const void* mcol, const void* sel,
                                  const void* a_indptr, const void* a_cols, const void* a_vals,
                                  const void* b_indptr, const void* b_cols, const void* b_vals) {
  return {static_cast<const int32_t*>(mrow), static_cast<const int32_t*>(mcol),
          static_cast<const uint8_t*>(sel), static_cast<const int32_t*>(a_indptr),
          static_cast<const int32_t*>(a_cols), a_vals, static_cast<const int32_t*>(b_indptr),
          static_cast<const int32_t*>(b_cols), b_vals};
}

template <typename T, int MUL, int ADD>
__global__ void __launch_bounds__(kThreads)
mxmt_masked_kernel(long long cap, MxmtOperands o, const T* __restrict__ init, T* __restrict__ out,
                   uint8_t* __restrict__ has) {
  const long long e = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (e >= cap) return;  // e is uniform across the warp
  const T init_v = *init;
  if (!o.sel[e]) {
    if (lane == 0) {
      out[e] = init_v;
      has[e] = 0;
    }
    return;
  }
  const T* __restrict__ a_vals = static_cast<const T*>(o.a_vals);
  const T* __restrict__ b_vals = static_cast<const T*>(o.b_vals);
  const int32_t i = o.mrow[e], j = o.mcol[e];
  const int32_t a_lo = o.a_indptr[i], a_hi = o.a_indptr[i + 1];
  const int32_t b_end = o.b_indptr[j + 1];
  T acc = monoid_identity<ADD, T>();
  bool any = false;
  for (int32_t t = o.b_indptr[j] + lane; t < b_end; t += 32) {
    const int32_t k = o.b_cols[t];
    const int32_t p = lower_bound(o.a_cols, a_lo, a_hi, k);
    if (p < a_hi && o.a_cols[p] == k) {
      acc = apply_op<ADD>(acc, product<MUL>(a_vals, p, b_vals, t));
      any = true;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc = apply_op<ADD>(acc, __shfl_xor_sync(kFullMask, acc, off));
  any = __any_sync(kFullMask, any);
  if (lane == 0) {
    out[e] = any ? apply_op<ADD>(init_v, acc) : init_v;
    has[e] = any;
  }
}

// i32 products and hits sum as uint64 (two's complement int64); f32 in f64.
template <typename T, int MUL>
using ReduceAcc = std::conditional_t<std::is_same_v<T, float> && MUL != kStruct, double,
                                     unsigned long long>;

template <typename T, int MUL>
__global__ void __launch_bounds__(kThreads)
mxmt_reduce_kernel(long long cap, MxmtOperands o, ReduceAcc<T, MUL>* __restrict__ total) {
  using Acc = ReduceAcc<T, MUL>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  const T* __restrict__ a_vals = static_cast<const T*>(o.a_vals);
  const T* __restrict__ b_vals = static_cast<const T*>(o.b_vals);
  Acc acc = 0;
  for (long long e = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5; e < cap;
       e += warps) {
    if (!o.sel[e]) continue;  // uniform across the warp
    const int32_t i = o.mrow[e], j = o.mcol[e];
    const int32_t a_lo = o.a_indptr[i], a_hi = o.a_indptr[i + 1];
    const int32_t b_end = o.b_indptr[j + 1];
    for (int32_t t = o.b_indptr[j] + lane; t < b_end; t += 32) {
      const int32_t k = o.b_cols[t];
      const int32_t p = lower_bound(o.a_cols, a_lo, a_hi, k);
      if (p < a_hi && o.a_cols[p] == k) {
        const T v = product<MUL>(a_vals, p, b_vals, t);
        if constexpr (std::is_same_v<Acc, double>) {
          acc += static_cast<double>(v);
        } else {
          acc += static_cast<unsigned long long>(static_cast<long long>(v));
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFullMask, acc, off);
  __shared__ Acc warp_sums[kThreads / 32];
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    Acc s = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    atomicAdd(total, s);
  }
}

namespace {

struct MaskedLaunch {
  long long cap;
  MxmtOperands o;
  const void* init;
  void *out, *has;
  cudaStream_t stream;

  template <typename T, int MUL, int ADD>
  void run() {
    mxmt_masked_kernel<T, MUL, ADD><<<blocks_for_warps(cap), kThreads, 0, stream>>>(
        cap, o, static_cast<const T*>(init), static_cast<T*>(out), static_cast<uint8_t*>(has));
  }
};

struct ReduceLaunch {
  long long cap;
  MxmtOperands o;
  void* total;
  cudaStream_t stream;

  template <typename T, int MUL>
  void run() {
    const unsigned blocks = blocks_for_warps(cap) < kReduceMaxBlocks ? blocks_for_warps(cap)
                                                                     : kReduceMaxBlocks;
    mxmt_reduce_kernel<T, MUL><<<blocks, kThreads, 0, stream>>>(
        cap, o, static_cast<ReduceAcc<T, MUL>*>(total));
  }
};

template <typename T>
bool dispatch_reduce_mul(int mul, ReduceLaunch& launch) {
  switch (mul) {
    case KC_PLUS: launch.run<T, KC_PLUS>(); return true;
    case KC_MULT: launch.run<T, KC_MULT>(); return true;
    case KC_FIRST: launch.run<T, KC_FIRST>(); return true;
    case KC_SECOND: launch.run<T, KC_SECOND>(); return true;
    case KC_MIN: launch.run<T, KC_MIN>(); return true;
    case KC_MAX: launch.run<T, KC_MAX>(); return true;
    default: return false;
  }
}

}  // namespace

extern "C" int spla_mxmt_masked(int mul, int add, int dtype, int structural, long long cap,
                                const void* mrow, const void* mcol, const void* sel,
                                const void* a_indptr, const void* a_cols, const void* a_vals,
                                const void* b_indptr, const void* b_cols, const void* b_vals,
                                const void* init, void* out, void* has, void* stream) {
  if (cap == 0) return 0;
  MaskedLaunch launch{cap,
                      mxmt_operands(mrow, mcol, sel, a_indptr, a_cols, a_vals, b_indptr, b_cols, b_vals),
                      init, out, has, static_cast<cudaStream_t>(stream)};
  bool ok;
  if (!structural) {
    ok = dispatch<true>(mul, add, dtype, launch);
  } else if (dtype == DT_F32) {
    ok = dispatch_add<true, float, kStruct>(add, launch);
  } else if (dtype == DT_I32) {
    ok = dispatch_add<true, int32_t, kStruct>(add, launch);
  } else {
    ok = false;
  }
  if (!ok) return -1;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spla_mxmt_reduce(int mul, int dtype, int structural, long long cap,
                                const void* mrow, const void* mcol, const void* sel,
                                const void* a_indptr, const void* a_cols, const void* a_vals,
                                const void* b_indptr, const void* b_cols, const void* b_vals,
                                void* total, void* stream) {
  if (cap == 0) return 0;
  ReduceLaunch launch{cap,
                      mxmt_operands(mrow, mcol, sel, a_indptr, a_cols, a_vals, b_indptr, b_cols, b_vals),
                      total, static_cast<cudaStream_t>(stream)};
  bool ok;
  if (structural) {
    launch.run<int32_t, kStruct>();  // reads no values: one instance serves every dtype
    ok = true;
  } else if (dtype == DT_F32) {
    ok = dispatch_reduce_mul<float>(mul, launch);
  } else if (dtype == DT_I32) {
    ok = dispatch_reduce_mul<int32_t>(mul, launch);
  } else {
    ok = false;
  }
  if (!ok) return -1;
  return static_cast<int>(cudaGetLastError());
}
