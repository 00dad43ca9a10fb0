// Kernel 7's fold of a stage (spmv_staged.cu), shared with kernel 8's
// ring_fold probe (spmv_probe.cu), which folds column and value words that
// stay resident in place of each stage's own.
//
// A unit of several rows is one stage, folded by teams of G lanes a row
// (kernel 1's mapping), G picked per stage from its mean row length so that
// a lane takes about four entries of its row: each lane reads its columns
// and values from the slot and issues all its x gathers (and x_valid reads)
// before it folds any; a team folds its lanes with shuffles.
//
// A unit of one row walks its stages with the thread striding the stage
// (entries t, t + 256, t + 512, t + 768), again four gathers issued before
// any fold, and carries its partial in registers from stage to stage.  After
// its last stage the CTA folds the partials (shuffles, then the warps in
// order).  A hub row's chunks are folded in chunk order by the last of them
// to finish, as kernel 1's are (semiring.cuh fold_chunks).  No atomics fold
// values, so results are deterministic.  The structural variant stops a team at
// its row's first hit and a chunk at its first stage with a hit (every chunk
// that hits writes 1 into hits zeroed beforehand, or the row's only chunk
// writes its result).
#pragma once

#include "staged.cuh"

struct StagedArgs {
  const int32_t* cols;
  const float* values;
  const float* x;
  const uint8_t* x_valid;
  const uint8_t* row_sel;
  const float* init;  // on the device, or null: then init_value
  float init_value;
  float* out;
  uint8_t* has;       // the structural variant's hits
  int mul;            // the generic family's mul (MUL = kRuntimeMul) and operand swap
  bool swap;
};

template <int MUL, int ADD, bool STRUCT>
struct StagedFold {
  Plan p;
  StagedArgs a;
  uint32_t* ring_cols;  // SLOTS slots of slot_w words
  uint32_t* ring_vals;  // the same, value kernels only
  uint32_t* ring_rows;  // SLOTS slots of kRowWords words: a unit of several rows' indptr slice
  int slot_w;
  float init_v;
  // a one-row unit's state, carried across its stages
  float acc;
  bool any, sel, hit;

  // this thread's copies of a stage: its columns and values, and a unit of
  // several rows' row pointers
  __device__ void copy(int slot, const Stage& s) {
    copy_words(ring_cols + slot * slot_w, a.cols, s.e0, s.e1);
    if (!STRUCT) copy_words(ring_vals + slot * slot_w, a.values, s.e0, s.e1);
    copy_rows(slot, s);
  }

  __device__ void copy_rows(int slot, const Stage& s) {
    if (s.several_rows()) copy_words(ring_rows + slot * kRowWords, p.indptr, s.r0, s.r1 + 1);
  }

  __device__ void consume(int slot, const Stage& s) {
    fold(slot, s, ring_cols + slot * slot_w, ring_vals + slot * slot_w);
  }

  // Fold stage s, whose columns and values are the slot words at `cw` and
  // `vw` and whose row pointers are in slot `slot`.
  __device__ void fold(int slot, const Stage& s, const uint32_t* cw, const uint32_t* vw) {
    const int32_t* sc = reinterpret_cast<const int32_t*>(cw) + line_offset(a.cols, s.e0);
    const float* sv = STRUCT ? nullptr : reinterpret_cast<const float*>(vw) + line_offset(a.values, s.e0);
    if (!s.several_rows()) {
      fold_row(s, sc, sv);
      return;
    }
    const int32_t* sp =
        reinterpret_cast<const int32_t*>(ring_rows + slot * kRowWords) + line_offset(p.indptr, s.r0);
    fold_rows(s, sc, sv, sp);
  }

  // The row's result (`any`: some product was folded); an unselected row
  // is stored with any = false.
  __device__ void store(int32_t row, bool hit_row, float v) const {
    if (STRUCT) {
      a.has[row] = hit_row;
      return;
    }
    a.out[row] = hit_row ? apply_op<ADD>(init_v, v) : init_v;
    if (a.has != nullptr) a.has[row] = hit_row;
  }

  // A lane's entries j0 + u * step (u < kPerThread) of `sc`/`sv`: column (-1
  // at and past len), value, gathered x and whether the product counts; the
  // slot reads first, then every gather
  __device__ __forceinline__ void gather(const int32_t* sc, const float* sv, int j0, int step, int len,
                                         int32_t (&c)[kPerThread], float (&v)[kPerThread],
                                         float (&xv)[kPerThread], bool (&ok)[kPerThread]) const {
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int j = j0 + u * step;
      c[u] = j < len ? sc[j] : -1;
      if (!STRUCT) v[u] = j < len ? sv[j] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      ok[u] = c[u] >= 0 && (a.x_valid == nullptr || __ldg(a.x_valid + c[u]));
      if (!STRUCT) xv[u] = c[u] >= 0 ? __ldg(a.x + c[u]) : 0.f;
    }
  }

  // A unit of several rows: teams of G lanes a row (kernel 1's mapping),
  // 256 / G rows at once, G the least power of two from 1 to 32 at or above
  // the stage's mean row length over kPerThread, so that a lane takes about
  // kPerThread entries of its row: it reads up to kPerThread columns and
  // values from the slot, then issues their x gathers, before it folds.  An
  // unselected row reads nothing but its mask byte.  The structural variant
  // votes each round and a team stops at its first hit.
  __device__ void fold_rows(const Stage& s, const int32_t* sc, const float* sv, const int32_t* sp) {
    const int nrows = s.r1 - s.r0;
    const int want = (s.e1 - s.e0 + kPerThread * nrows - 1) / (kPerThread * nrows);
    int log2g = 0;
    while (log2g < 5 && (1 << log2g) < want) ++log2g;
    const int g = 1 << log2g;
    const int lane = threadIdx.x & 31, team = threadIdx.x >> log2g, sub = threadIdx.x & (g - 1);
    const unsigned tmask = g == 32 ? kFullMask : ((1u << g) - 1u) << (lane & ~(g - 1));
    for (int base = 0; base < nrows; base += kThreads >> log2g) {  // uniform across the CTA
      const int i = base + team;
      const bool has_row = i < nrows;
      const bool walk = has_row && (a.row_sel == nullptr || a.row_sel[s.r0 + i]);
      int k = walk ? sp[i] - s.e0 + sub : 0;
      const int end = walk ? sp[i + 1] - s.e0 : 0;
      float acc_t = monoid_identity<ADD, float>();
      bool any_t = false;
      int32_t c[kPerThread];
      float v[kPerThread], xv[kPerThread];
      bool ok[kPerThread];
      if constexpr (STRUCT) {
        // every lane votes in every round until each team has a hit or its row ends
        bool active = walk;
        for (; __any_sync(kFullMask, active); k += kPerThread * g) {
          bool found = false;
          if (active) {
            gather(sc + k, sv, 0, g, end - k, c, v, xv, ok);
#pragma unroll
            for (int u = 0; u < kPerThread; ++u) found = found || ok[u];
          }
          const bool team_hit = (__ballot_sync(kFullMask, active && found) & tmask) != 0;
          any_t = any_t || team_hit;
          active = active && !team_hit && end - k > kPerThread * g;
        }
      } else {
        for (; k < end; k += kPerThread * g) {
          gather(sc + k, sv + k, 0, g, end - k, c, v, xv, ok);
#pragma unroll
          for (int u = 0; u < kPerThread; ++u) {
            if (ok[u]) {
              acc_t = apply_op<ADD>(acc_t, apply_mul<MUL>(v[u], xv[u], a.mul, a.swap));
              any_t = true;
            }
          }
        }
        for (int off = g >> 1; off > 0; off >>= 1) {
          acc_t = apply_op<ADD>(acc_t, __shfl_xor_sync(kFullMask, acc_t, off));
        }
        any_t = (__ballot_sync(kFullMask, any_t) & tmask) != 0;
      }
      if (sub == 0 && has_row) store(s.r0 + i, any_t, acc_t);
    }
  }

  __device__ void fold_row(const Stage& s, const int32_t* sc, const float* sv) {
    __shared__ float red_v[kWarps];
    __shared__ uint8_t red_a[kWarps];
    const int32_t row = s.r0;
    if (s.first()) {
      acc = monoid_identity<ADD, float>();
      any = hit = false;
      sel = a.row_sel == nullptr || a.row_sel[row];
    }
    if (sel && !(STRUCT && hit)) {
      int32_t c[kPerThread];
      float v[kPerThread], xv[kPerThread];
      bool ok[kPerThread];
      gather(sc, sv, threadIdx.x, kThreads, s.e1 - s.e0, c, v, xv, ok);
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) {
        if (ok[u]) {
          if (!STRUCT) acc = apply_op<ADD>(acc, apply_mul<MUL>(v[u], xv[u], a.mul, a.swap));
          any = true;
        }
      }
    }
    if (STRUCT) hit = __syncthreads_or(any);
    if (!s.last()) return;
    const int32_t hub = p.unit_hub[s.unit];
    if (STRUCT) {
      if (threadIdx.x != 0) return;
      if (hub < 0) a.has[row] = sel && hit;
      else if (sel && hit) a.has[row] = 1;
      return;
    }
    float v = acc;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = apply_op<ADD>(v, __shfl_xor_sync(kFullMask, v, off));
    const bool wa = __any_sync(kFullMask, any);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
      red_v[warp] = v;
      red_a[warp] = wa;
    }
    __syncthreads();
    if (threadIdx.x != 0) return;
    float total = red_v[0];
    bool found = red_a[0];
    for (int w = 1; w < kWarps; ++w) {
      total = apply_op<ADD>(total, red_v[w]);
      found = found || red_a[w];
    }
    if (hub >= 0) {
      const int32_t first = p.hub_units[2 * hub], count = p.hub_units[2 * hub + 1];
      if (!sel) {  // no chunk counts itself; the first writes init
        if (s.unit == first) store(row, false, 0.f);
        return;
      }
      if (!fold_chunks<ADD>(static_cast<float*>(p.part), p.part_any, p.done, hub, s.unit, first, count, total,
                            found)) {
        return;  // another chunk of the row folds them all
      }
    }
    store(row, sel && found, total);
  }
};

// Dynamic shared memory of a ring of SLOTS slots.
template <bool STRUCT>
constexpr size_t ring_bytes(int slots, int stage) {
  return sizeof(uint32_t) * slots * (static_cast<size_t>(slot_words(stage)) * (STRUCT ? 1 : 2) + kRowWords);
}

// The fold over a ring of SLOTS slots at `ring`: the column slots, then the
// value slots (value kernels), then the row-pointer slots.
template <int SLOTS, int MUL, int ADD, bool STRUCT>
__device__ __forceinline__ StagedFold<MUL, ADD, STRUCT> staged_fold(const Plan& p, const StagedArgs& a,
                                                                   uint32_t* ring) {
  const int slot_w = slot_words(p.stage);
  uint32_t* vals = ring + SLOTS * slot_w;
  uint32_t* rows = vals + (STRUCT ? 0 : SLOTS * slot_w);
  const float init_v = STRUCT ? 0.f : (a.init != nullptr ? *a.init : a.init_value);
  return {p, a, ring, vals, rows, slot_w, init_v, monoid_identity<ADD, float>(), false, false, false};
}
