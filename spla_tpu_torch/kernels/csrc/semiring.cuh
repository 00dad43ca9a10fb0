// Semiring operators shared by the SpMV kernels (spmv_pull.cu, spmv_push.cu,
// spmv_staged.cu), and the fold of a row's chunks that kernels 1 and 7 share.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Kept equal to spla_tpu_torch.op.KernelCode.
enum KernelCode : int { KC_PLUS = 0, KC_MULT = 1, KC_FIRST = 2, KC_SECOND = 3, KC_MIN = 4, KC_MAX = 5 };
// Kept equal to spla_tpu_torch.kernels.spmv.DTYPE_CODES.
enum DtypeCode : int { DT_F32 = 0, DT_I32 = 1 };

constexpr int kThreads = 256;  // 8 warps per block, one row (or frontier vertex) per warp
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ bool is_nan(float a) { return a != a; }
__device__ __forceinline__ bool is_nan(int32_t) { return false; }

// i32 PLUS and MULT wrap, as in the reference; computed in uint32_t because
// signed overflow is undefined behaviour in C++.
__device__ __forceinline__ float op_plus(float a, float b) { return a + b; }
__device__ __forceinline__ int32_t op_plus(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
__device__ __forceinline__ float op_mult(float a, float b) { return a * b; }
__device__ __forceinline__ int32_t op_mult(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

// torch.minimum / torch.maximum propagate NaN; fminf / fmaxf would drop it.
template <typename T>
__device__ __forceinline__ T op_min(T a, T b) { return (a < b || is_nan(a)) ? a : b; }
template <typename T>
__device__ __forceinline__ T op_max(T a, T b) { return (a > b || is_nan(a)) ? a : b; }

template <int OP, typename T>
__device__ __forceinline__ T apply_op(T a, T b) {
  if constexpr (OP == KC_PLUS) return op_plus(a, b);
  else if constexpr (OP == KC_MULT) return op_mult(a, b);
  else if constexpr (OP == KC_FIRST) return a;
  else if constexpr (OP == KC_SECOND) return b;
  else if constexpr (OP == KC_MIN) return op_min(a, b);
  else return op_max(a, b);
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

// Identity of the add monoids the kernels cover.
template <int ADD, typename T>
__device__ __forceinline__ T monoid_identity() {
  if constexpr (ADD == KC_PLUS) return T(0);
  else if constexpr (ADD == KC_MIN) return Limits<T>::highest();
  else return Limits<T>::lowest();
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

inline unsigned blocks_for_warps(long long warps) {
  return static_cast<unsigned>((warps * 32 + kThreads - 1) / kThreads);
}
