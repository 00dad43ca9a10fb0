// Semiring operators shared by the SpMV and SpGEMM kernels (spmv_pull.cu,
// spmv_pull_generic.cu, spmv_push.cu, spmv_staged.cu, spmv_staged_generic.cu,
// mxmt.cu, spgemm.cu),
// and the fold of a row's chunks that kernels 1 and 7 share.
//
// Two kinds of instance.  The templated ones fix (mul, add, dtype) at
// compile time: mul in {PLUS, MULT, FIRST, SECOND, MIN, MAX}, add in
// {PLUS, MIN, MAX}, f32 and i32 (dispatch below; kernels 1, 2 and 7).  The
// generic family fixes (dtype, add) and takes the mul as a kernel argument
// (MUL = kRuntimeMul: apply_mul switches on it, the same code in every lane
// of a launch, so the branch never diverges); it covers every built-in mul,
// an operand swap, u32 and the bitwise and logical adds (dispatch_generic).
// Kernels 4, 5 and 9 have only the family; kernels 1 and 7 have both, their
// templated instances serving the requests they hold (PERF.md: kernel 1's
// family is ~3% slower on a skewed graph).
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

// Kept equal to spla_tpu_torch.op.KernelCode.
enum KernelCode : int {
  KC_PLUS = 0, KC_MULT = 1, KC_FIRST = 2, KC_SECOND = 3, KC_MIN = 4, KC_MAX = 5, KC_MINUS = 6, KC_DIV = 7,
  KC_MINUS_POW2 = 8, KC_BONE = 9, KC_LOR = 10, KC_LAND = 11, KC_BOR = 12, KC_BAND = 13, KC_BXOR = 14
};
// Kept equal to spla_tpu_torch.kernels.spmv.DTYPE_CODES.
enum DtypeCode : int { DT_F32 = 0, DT_I32 = 1, DT_U32 = 2 };

constexpr int kRuntimeMul = 64;  // MUL of the generic instances: the mul is a kernel argument

constexpr int kThreads = 256;  // 8 warps per block, one row (or frontier vertex) per warp
constexpr unsigned kFullMask = 0xffffffffu;

// i32 PLUS, MINUS and MULT wrap, as in the reference; computed in uint32_t
// because signed overflow is undefined behaviour in C++.  u32 wraps natively.
__device__ __forceinline__ float op_plus(float a, float b) { return a + b; }
__device__ __forceinline__ int32_t op_plus(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ uint32_t op_plus(uint32_t a, uint32_t b) { return a + b; }
__device__ __forceinline__ float op_minus(float a, float b) { return a - b; }
__device__ __forceinline__ int32_t op_minus(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ uint32_t op_minus(uint32_t a, uint32_t b) { return a - b; }
__device__ __forceinline__ float op_mult(float a, float b) { return a * b; }
__device__ __forceinline__ int32_t op_mult(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}
__device__ __forceinline__ uint32_t op_mult(uint32_t a, uint32_t b) { return a * b; }

// DIV: IEEE for f32; XLA's integer division (spla_tpu.op uses lax.div) for
// i32 and u32: toward zero, x / 0 all ones, INT_MIN / -1 INT_MIN.
__device__ __forceinline__ float op_div(float a, float b) { return a / b; }
__device__ __forceinline__ int32_t op_div(int32_t a, int32_t b) {
  if (b == 0) return -1;
  if (b == -1) return op_minus(int32_t(0), a);  // -INT_MIN wraps to INT_MIN
  return a / b;
}
__device__ __forceinline__ uint32_t op_div(uint32_t a, uint32_t b) { return b == 0 ? UINT32_MAX : a / b; }

// f32 MIN / MAX are IEEE 754-2019 minimum / maximum, as the port's MIN and
// MAX ops (op.py _float_min): -0.0 is below +0.0 in either operand order,
// so a fold's zero depends on neither the order of its entries nor the
// device, and a NaN propagates (as the canonical NaN 0x7fffffff; fminf /
// fmaxf would drop it).  PTX's min.NaN / max.NaN (sm_80 and later) are
// exactly that, in one instruction: a compare and a select on the sign bit
// measured 1.8-2.6% slower on kernels 7 and 9 (tools/tie_times.py; PERF.md).
template <typename T>
__device__ __forceinline__ T op_min(T a, T b) {
  if constexpr (std::is_same_v<T, float>) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
  } else {
    return a < b ? a : b;
  }
}
template <typename T>
__device__ __forceinline__ T op_max(T a, T b) {
  if constexpr (std::is_same_v<T, float>) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
  } else {
    return a > b ? a : b;
  }
}

// LOR / LAND: 1 or 0 of the type; a NaN is nonzero.
template <typename T>
__device__ __forceinline__ T op_lor(T a, T b) { return T((a != T(0)) | (b != T(0))); }
template <typename T>
__device__ __forceinline__ T op_land(T a, T b) { return T((a != T(0)) & (b != T(0))); }

template <int OP, typename T>
__device__ __forceinline__ T apply_op(T a, T b) {
  if constexpr (OP == KC_PLUS) return op_plus(a, b);
  else if constexpr (OP == KC_MULT) return op_mult(a, b);
  else if constexpr (OP == KC_FIRST) return a;
  else if constexpr (OP == KC_SECOND) return b;
  else if constexpr (OP == KC_MIN) return op_min(a, b);
  else if constexpr (OP == KC_MAX) return op_max(a, b);
  else if constexpr (OP == KC_MINUS) return op_minus(a, b);
  else if constexpr (OP == KC_DIV) return op_div(a, b);
  else if constexpr (OP == KC_MINUS_POW2) return op_mult(op_minus(a, b), op_minus(a, b));
  else if constexpr (OP == KC_BONE) return T(1);
  else if constexpr (OP == KC_LOR) return op_lor(a, b);
  else if constexpr (OP == KC_LAND) return op_land(a, b);
  else if constexpr (OP == KC_BOR) return a | b;
  else if constexpr (OP == KC_BAND) return a & b;
  else {
    static_assert(OP == KC_BXOR, "not a KernelCode");
    return a ^ b;
  }
}

// mul(a, b) by the run-time code; the bitwise muls exist for the integer
// types only (runtime_mul_ok: the C entries refuse them in f32).
template <typename T>
__device__ __forceinline__ T apply_runtime(int op, T a, T b) {
  switch (op) {
    case KC_PLUS: return apply_op<KC_PLUS>(a, b);
    case KC_MULT: return apply_op<KC_MULT>(a, b);
    case KC_FIRST: return a;
    case KC_SECOND: return b;
    case KC_MIN: return apply_op<KC_MIN>(a, b);
    case KC_MAX: return apply_op<KC_MAX>(a, b);
    case KC_MINUS: return apply_op<KC_MINUS>(a, b);
    case KC_DIV: return apply_op<KC_DIV>(a, b);
    case KC_MINUS_POW2: return apply_op<KC_MINUS_POW2>(a, b);
    case KC_BONE: return T(1);
    case KC_LOR: return apply_op<KC_LOR>(a, b);
    case KC_LAND: return apply_op<KC_LAND>(a, b);
    default:
      if constexpr (std::is_integral_v<T>) {
        if (op == KC_BOR) return a | b;
        if (op == KC_BAND) return a & b;
        return a ^ b;
      } else {
        return a;
      }
  }
}

// Whether a generic instance takes `mul` in `dtype`: a KernelCode, and no
// bitwise mul in f32 (apply_runtime has none there).
inline bool runtime_mul_ok(int mul, int dtype) {
  if (mul < KC_PLUS || mul > KC_BXOR) return false;
  return dtype != DT_F32 || (mul != KC_BOR && mul != KC_BAND && mul != KC_BXOR);
}

// The product of a templated instance (MUL fixed) or of a generic one
// (swap: mul(b, a)).
template <int MUL, typename T>
__device__ __forceinline__ T apply_mul(T a, T b, int mul, bool swap) {
  if constexpr (MUL == kRuntimeMul) return swap ? apply_runtime(mul, b, a) : apply_runtime(mul, a, b);
  else return apply_op<MUL>(a, b);
}

template <typename T> struct Limits;
template <> struct Limits<float> {
  static __device__ float lowest() { return __uint_as_float(0xff800000u); }   // -inf
  static __device__ float highest() { return __uint_as_float(0x7f800000u); }  // +inf
};
template <> struct Limits<int32_t> {
  static __device__ int32_t lowest() { return INT32_MIN; }
  static __device__ int32_t highest() { return INT32_MAX; }
};
template <> struct Limits<uint32_t> {
  static __device__ uint32_t lowest() { return 0u; }
  static __device__ uint32_t highest() { return UINT32_MAX; }
};

// Identity of the add monoids the kernels cover.
template <int ADD, typename T>
__device__ __forceinline__ T monoid_identity() {
  if constexpr (ADD == KC_PLUS || ADD == KC_LOR || ADD == KC_BOR || ADD == KC_BXOR) return T(0);
  else if constexpr (ADD == KC_MULT) return T(1);
  else if constexpr (ADD == KC_BAND) return static_cast<T>(~0u);  // all ones
  else if constexpr (ADD == KC_MIN) return Limits<T>::highest();
  else {
    static_assert(ADD == KC_MAX, "not an add monoid of the kernels");
    return Limits<T>::lowest();
  }
}

// A row cut into `count` chunks from chunk `first`, a CTA each (kernel 1's
// hub chunks, kernel 7's hub units).  Thread 0 of chunk `chunk` publishes
// its fold (v, hit) into part/part_any and counts itself on done[hub] after
// a fence; the last chunk to count folds every chunk's partial in chunk
// order into (v, hit), zeroes the counter for the next launch on the
// stream, and returns true.  The others return false.  No atomic folds a
// value, so the result is deterministic.
template <int ADD, typename T>
__device__ bool fold_chunks(T* part, uint8_t* part_any, int32_t* done, int32_t hub, int32_t chunk,
                            int32_t first, int32_t count, T& v, bool& hit) {
  part[chunk] = v;
  part_any[chunk] = hit;
  __threadfence();
  if (atomicAdd(done + hub, 1) != count - 1) return false;
  done[hub] = 0;  // every chunk has counted: ready for the next launch
  __threadfence();
  v = monoid_identity<ADD, T>();
  hit = false;
  for (int32_t c = first; c < first + count; ++c) {
    if (__ldcg(part_any + c)) {
      v = apply_op<ADD>(v, __ldcg(part + c));
      hit = true;
    }
  }
  return true;
}

// Host-side dispatch from runtime codes to template instances.  `Launch`
// is a functor with `template <typename T, int MUL, int ADD> void run()`.
// PULL instances cover add in {PLUS, MIN, MAX}; push instances fold only
// the idempotent MIN and MAX.  Returns false for a combination not compiled.
template <bool PULL, typename T, int MUL, typename Launch>
bool dispatch_add(int add, Launch& launch) {
  switch (add) {
    case KC_PLUS:
      if constexpr (PULL) {
        launch.template run<T, MUL, KC_PLUS>();
        return true;
      } else {
        return false;
      }
    case KC_MIN: launch.template run<T, MUL, KC_MIN>(); return true;
    case KC_MAX: launch.template run<T, MUL, KC_MAX>(); return true;
    default: return false;
  }
}

template <bool PULL, typename T, typename Launch>
bool dispatch_mul(int mul, int add, Launch& launch) {
  switch (mul) {
    case KC_PLUS: return dispatch_add<PULL, T, KC_PLUS>(add, launch);
    case KC_MULT: return dispatch_add<PULL, T, KC_MULT>(add, launch);
    case KC_FIRST: return dispatch_add<PULL, T, KC_FIRST>(add, launch);
    case KC_SECOND: return dispatch_add<PULL, T, KC_SECOND>(add, launch);
    case KC_MIN: return dispatch_add<PULL, T, KC_MIN>(add, launch);
    case KC_MAX: return dispatch_add<PULL, T, KC_MAX>(add, launch);
    default: return false;
  }
}

template <bool PULL, typename Launch>
bool dispatch(int mul, int add, int dtype, Launch& launch) {
  switch (dtype) {
    case DT_F32: return dispatch_mul<PULL, float>(mul, add, launch);
    case DT_I32: return dispatch_mul<PULL, int32_t>(mul, add, launch);
    default: return false;
  }
}

// The generic family's dispatch: `launch.template run<T, kRuntimeMul, ADD>()`
// for f32 with add in {PLUS, MIN, MAX}, and i32 / u32 with any add that
// has an identity (PLUS, MULT, MIN, MAX, LOR, BOR, BAND, BXOR) where
// INT_ADDS, or PLUS / MIN / MAX only.  Returns false for any other.
template <typename T, bool INT_ADDS, typename Launch>
bool dispatch_generic_add(int add, Launch& launch) {
  switch (add) {
    case KC_PLUS: launch.template run<T, kRuntimeMul, KC_PLUS>(); return true;
    case KC_MIN: launch.template run<T, kRuntimeMul, KC_MIN>(); return true;
    case KC_MAX: launch.template run<T, kRuntimeMul, KC_MAX>(); return true;
    default: break;
  }
  if constexpr (INT_ADDS && std::is_integral_v<T>) {
    switch (add) {
      case KC_MULT: launch.template run<T, kRuntimeMul, KC_MULT>(); return true;
      case KC_LOR: launch.template run<T, kRuntimeMul, KC_LOR>(); return true;
      case KC_BOR: launch.template run<T, kRuntimeMul, KC_BOR>(); return true;
      case KC_BAND: launch.template run<T, kRuntimeMul, KC_BAND>(); return true;
      case KC_BXOR: launch.template run<T, kRuntimeMul, KC_BXOR>(); return true;
      default: break;
    }
  }
  return false;
}

// The dtypes of a generic family: f32 if F32, i32 if I32, u32 if U32.
template <bool F32, bool I32, bool U32, bool INT_ADDS, typename Launch>
bool dispatch_generic(int add, int dtype, Launch& launch) {
  switch (dtype) {
    case DT_F32:
      if constexpr (F32) return dispatch_generic_add<float, INT_ADDS>(add, launch);
      return false;
    case DT_I32:
      if constexpr (I32) return dispatch_generic_add<int32_t, INT_ADDS>(add, launch);
      return false;
    case DT_U32:
      if constexpr (U32) return dispatch_generic_add<uint32_t, INT_ADDS>(add, launch);
      return false;
    default: return false;
  }
}

inline unsigned blocks_for_warps(long long warps) {
  return static_cast<unsigned>((warps * 32 + kThreads - 1) / kThreads);
}
