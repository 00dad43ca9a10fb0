// Kernel 1: CSR semiring pull SpMV,  out[i] = init (+) fold_(+) { mul(M[i,j], x[j]) : x_valid[j] }.
//
// Replaces spla_tpu/pallas/spmv.py fused_cell_spmv_apply (:2055, kernel
// _make_fused_kernel :1923) and the full-grid branch of fused_spmv2d_adaptive
// (:2346).  The TPU kernel streams a packed cell/pair/oct tile format because
// the TPU has no hardware gather; on Hopper x[col] is one load, so this kernel
// reads the plain CSR (indptr / cols / values) the port keeps.
//
// Bound: bytes.  Per stored entry it reads a 4-byte column, a 4-byte value
// (none in the structural variant) and, where x[j] is valid, a gathered
// 4-byte x element; per row two indptr words and one output word.  A random
// gather moves a whole 32-byte sector, so on a graph with random columns the
// gathers, not the column and value streams, set the floor (PERF.md), and
// they cost L2 rather than HBM traffic only while their target stays in the
// 50 MB L2.  The x-validity mask reaches the kernel as a bitmap (bit j & 31
// of word j >> 5; pack_valid_bits_kernel packs the caller's bytes first): n/8
// bytes, 4.2 MB at n = 2^25, which stays in L2 where the byte mask (n bytes)
// and x (4n) do not.  A masked entry gathers its bit's word, and x[j] only
// where the bit is set, so a pull over a sparse mask skips most x gathers.
// The design keeps as many bytes in flight as it can and leaves the gathers
// in L2:
//   * a team of G lanes per row, G a power of two from 2 to 32 picked from
//     the mean row length (kernels/spmv.py pull_plan; an instance per G), so
//     a warp walks 32 / G rows at once rather than one half-empty row;
//   * each lane issues kUnroll column and value loads, then (masked) the
//     kUnroll bit words, then the x gathers that their bits allow, before it
//     folds any; an instance without a mask gathers x straight after the
//     columns; the structural variant tests a round's bits one by one and
//     stops at the first set (round_hits);
//   * cols and values are read with the streaming hint (ld.global.cs, evict
//     first), so the bits and x stay in L2 as long as they fit; the bits and
//     x go through the read-only path;
//   * rows longer than hub_len entries (the hub rows, listed by pull_plan)
//     are cut into chunks of HUB_CHUNK entries, a CTA each, folded through
//     shared memory; the last CTA of a row to finish folds the chunks'
//     partials in chunk order and zeroes the row's counter again (the
//     partials, counters and bits belong to the plan, so launches on one
//     matrix follow one another on a stream).  Those CTAs come first in the
//     launch;
//   * where x passes the L2 budget the value kernel's plan cuts the columns
//     into S segments and the hub rows where their columns cross a
//     segment's edge, and launches the pieces segment by segment (items),
//     so the hub CTAs in flight gather from one window of x that L2 holds.
//     A row of more than HUB_CHUNK entries keeps its CTA chunks, cut at the
//     edges too; the shorter hub rows give a warp a piece, the 8 warps of a
//     CTA the pieces of 8 rows in one segment, each row's S pieces folded
//     in column order as the chunks are (fold_chunks);
//   * the row-select mask and the x-validity mask are fused: an unselected
//     row reads nothing but its mask byte, and the separate mask-select and
//     stored-ness passes of the TPU path disappear (`has` is written here).
// A team folds its lanes with a shuffle of width G in the add monoid; every
// lane of a warp takes part in every shuffle, past the last row too.
//
// Coverage (see semiring.cuh): the templated instances (spmv_pull.cu), mul
// in {PLUS, MULT, FIRST, SECOND, MIN, MAX}, add in {PLUS, MIN, MAX}, f32 and
// i32; the generic family (spmv_pull_generic.cu), every built-in mul as a
// kernel argument, with its operands swapped where vxm asks, in f32 with add
// in {PLUS, MIN, MAX} and in i32 and u32 with add in {PLUS, MULT, MIN, MAX,
// LOR, BOR, BAND, BXOR}: what spla_tpu's Pallas SpMV takes
// (kernels/spmv.py pull_codes); and a structural variant that reads no
// values: hits[i] = selected && any valid x[j] in row i, whose team (or
// chunk CTA) stops at its first hit.  This header holds the kernels; each
// source compiles its own instances, in parallel: spmv_pull.cu the templated
// ones without a mask, the structural variant and the pack,
// spmv_pull_masked.cu the templated ones with a mask, and
// spmv_pull_generic.cu / spmv_pull_generic_masked.cu the family's.
#pragma once

#include <cstring>

#include "semiring.cuh"

namespace {

constexpr int kWarpsPerCta = kThreads / 32;
constexpr int kUnroll = 4;  // column and value loads a lane issues before it uses one

template <typename T>
struct PullArgs {
  long long m;
  const int32_t* indptr;
  const int32_t* cols;
  const T* values;
  const T* x;
  const uint32_t* x_bits;  // the masked instances': bit j & 31 of word j >> 5 set where x[j] is valid
  const uint8_t* row_sel;
  const T* init;  // on the device, or null: then init_value
  T init_value;
  T* out;
  uint8_t* has;
  int mul;    // the generic family's mul (a KernelCode); unused by the templated instances
  bool swap;  // the generic family computes mul(x[j], M[i,j])

  __device__ T init_of() const { return init != nullptr ? *init : init_value; }
};

// The launch shape (kernels/spmv.py pull_plan) and the hub rows' scratch.
// Hub h (the h-th row cut into chunks) has chunks chunk_first[h] ..
// chunk_first[h + 1] - 1; chunk b walks entries [chunk_c0[b], chunk_c1[b])
// of row chunk_row[b].  With segments > 1 (the value kernel) item k of the
// launch is chunk items[k] where that is not negative, else, with
// -1 - items[k] = c * segments + s, the pieces in segment s of short hubs
// 8 c .. 8 c + 7, a warp each: short hub j's piece s ends at
// cuts[j * (segments - 1) + s] (its row's end for the last), its fold in
// part[nchunks + j * segments + s], its counter done[nhub + j].
struct PullPlan {
  const int32_t *chunk_row, *chunk_c0, *chunk_c1, *chunk_hub;  // [nchunks]
  const int32_t* chunk_first;                                 // [nhub + 1]
  long long nhub, nchunks;
  int log2g;  // a team is 1 << log2g lanes
  int hub_len;
  int segments;
  long long nitems, nshort;
  const int32_t* items;       // [nitems], or null with one segment: item b is chunk b
  const int32_t* short_rows;  // [nshort]
  const int32_t* cuts;        // [nshort * (segments - 1)]
  void* part;          // T, a chunk's or piece's fold (value kernel, rows of several)
  uint8_t* part_any;   // whether it folded anything
  int32_t* done;       // [nhub + nshort]: chunks or pieces of each row finished; zero between launches
};

// A lane's next kUnroll entries k, k + stride, ... (column -1 at and past end).
template <typename T, bool VALUES>
__device__ __forceinline__ void issue(int32_t (&c)[kUnroll], T (&v)[kUnroll], const int32_t* cols,
                                      const T* values, int32_t k, int32_t end, int stride) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int32_t e = k + u * stride;
    const bool in = e < end;
    c[u] = in ? __ldcs(cols + e) : -1;
    if constexpr (VALUES) v[u] = in ? __ldcs(values + e) : T(0);
  }
}

// Fold this lane's entries k, k + stride, ... < end: per round, kUnroll
// column and value loads, then (MASKED) the kUnroll bit words, then the x
// gathers of the entries whose bit is set, then the products.
template <typename T, int MUL, int ADD, bool MASKED>
__device__ __forceinline__ void fold_range(int32_t k, int32_t end, int stride, const PullArgs<T>& a,
                                           T& acc, bool& any) {
  for (; k < end; k += kUnroll * stride) {
    int32_t c[kUnroll];
    T v[kUnroll];
    issue<T, true>(c, v, a.cols, a.values, k, end, stride);
    bool ok[kUnroll];
    if constexpr (MASKED) {
      uint32_t w[kUnroll];  // the words that hold the columns' bits (0 past the end)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) w[u] = c[u] >= 0 ? __ldg(a.x_bits + (c[u] >> 5)) : 0u;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) ok[u] = (w[u] >> (c[u] & 31)) & 1u;
    } else {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) ok[u] = c[u] >= 0;
    }
    T xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) xv[u] = ok[u] ? __ldg(a.x + c[u]) : T(0);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (ok[u]) {
        acc = apply_op<ADD>(acc, apply_mul<MUL>(v[u], xv[u], a.mul, a.swap));
        any = true;
      }
    }
    if (end - k <= kUnroll * stride) break;  // no overflow of k past end
  }
}

// A lane's row in its warp's slab (the 32 / G rows a warp walks at once):
// which entries it walks and whether its team writes the row.  An
// unselected row reads only its mask byte and is written with init; a
// selected hub row is left to its chunk CTAs.
struct Head {
  long long row;
  int32_t start, end;
  bool walk, store;
};

template <int LOG2G>
__device__ __forceinline__ Head head(long long m, const int32_t* indptr, const uint8_t* row_sel,
                                     const PullPlan& p, long long slab, int team) {
  Head h{(slab << (5 - LOG2G)) + team, 0, 0, false, false};
  h.store = h.row < m;
  if (h.store && (row_sel == nullptr || row_sel[h.row])) {
    h.start = indptr[h.row];
    h.end = indptr[h.row + 1];
    h.walk = h.store = h.end - h.start <= p.hub_len;
  }
  return h;
}

template <int LOG2G>
__device__ __forceinline__ unsigned team_mask(int lane) {
  constexpr int g = 1 << LOG2G;
  return g == 32 ? kFullMask : ((1u << g) - 1u) << (lane & ~(g - 1));
}

// A hub chunk (b) or a short hub's piece: its row, entry range, fold slot
// and siblings (the row's slots first .. first + count - 1, its counter
// done[hub]); false if the row is not selected (uniform across the CTA or
// warp that walks it).
struct Chunk {
  long long row;
  int32_t hub, slot, first, count, c0, c1;

  __device__ bool load(const PullPlan& p, int32_t b, const uint8_t* row_sel) {
    row = p.chunk_row[b];
    c0 = p.chunk_c0[b];
    c1 = p.chunk_c1[b];
    hub = p.chunk_hub[b];
    slot = b;
    if (row_sel != nullptr && !row_sel[row]) return false;
    first = p.chunk_first[hub];
    count = p.chunk_first[hub + 1] - first;
    return true;
  }

  __device__ bool load_piece(const PullPlan& p, const int32_t* indptr, int32_t j, int s, const uint8_t* row_sel) {
    row = p.short_rows[j];
    if (row_sel != nullptr && !row_sel[row]) return false;
    const int32_t* cut = p.cuts + static_cast<long long>(j) * (p.segments - 1);
    c0 = s == 0 ? indptr[row] : cut[s - 1];
    c1 = s == p.segments - 1 ? indptr[row + 1] : cut[s];
    hub = static_cast<int32_t>(p.nhub) + j;
    first = static_cast<int32_t>(p.nchunks) + j * p.segments;
    slot = first + s;
    count = p.segments;
    return true;
  }
};

// The last of a hub row's chunks or pieces to finish (the only one where
// the row has one) writes it: its fold and init, and whether it folded any.
template <typename T, int ADD>
__device__ __forceinline__ void finish_hub(const PullArgs<T>& a, const PullPlan& p, const Chunk& ch, T v, bool hit) {
  if (ch.count > 1 && !fold_chunks<ADD>(static_cast<T*>(p.part), p.part_any, p.done, ch.hub, ch.slot, ch.first,
                                         ch.count, v, hit)) {
    return;  // another chunk of the row folds them all
  }
  const T init_v = a.init_of();
  a.out[ch.row] = hit ? apply_op<ADD>(init_v, v) : init_v;
  if (a.has != nullptr) a.has[ch.row] = hit;
}

template <typename T, int MUL, int ADD, bool MASKED>
__device__ void pull_chunk(const PullArgs<T>& a, const PullPlan& p, int32_t b) {
  __shared__ T red[kWarpsPerCta];
  __shared__ bool red_any[kWarpsPerCta];
  Chunk ch;
  if (!ch.load(p, b, a.row_sel)) return;  // the slab pass writes init
  T acc = monoid_identity<ADD, T>();
  bool any = false;
  fold_range<T, MUL, ADD, MASKED>(ch.c0 + static_cast<int32_t>(threadIdx.x), ch.c1, kThreads, a, acc, any);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc = apply_op<ADD>(acc, __shfl_xor_sync(kFullMask, acc, off));
  any = __any_sync(kFullMask, any);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[warp] = acc;
    red_any[warp] = any;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  T v = red[0];
  bool hit = red_any[0];
  for (int w = 1; w < kWarpsPerCta; ++w) {
    v = apply_op<ADD>(v, red[w]);
    hit = hit || red_any[w];
  }
  finish_hub<T, ADD>(a, p, ch, v, hit);
}

// A warp's piece of item code k (-1 - items[k]): segment k % segments of
// short hub (k / segments) * 8 + warp.
template <typename T, int MUL, int ADD, bool MASKED>
__device__ void pull_piece(const PullArgs<T>& a, const PullPlan& p, int32_t k) {
  const int32_t j = k / p.segments * kWarpsPerCta + static_cast<int32_t>(threadIdx.x >> 5);
  Chunk ch;
  if (j >= p.nshort || !ch.load_piece(p, a.indptr, j, k % p.segments, a.row_sel)) return;
  T acc = monoid_identity<ADD, T>();
  bool any = false;
  fold_range<T, MUL, ADD, MASKED>(ch.c0 + static_cast<int32_t>(threadIdx.x & 31), ch.c1, 32, a, acc, any);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc = apply_op<ADD>(acc, __shfl_xor_sync(kFullMask, acc, off));
  any = __any_sync(kFullMask, any);
  if ((threadIdx.x & 31) == 0) finish_hub<T, ADD>(a, p, ch, acc, any);
}

template <typename T, int MUL, int ADD, int LOG2G, bool MASKED>
__global__ void __launch_bounds__(kThreads)
spmv_pull_kernel(PullArgs<T> a, PullPlan p) {
  constexpr int g = 1 << LOG2G;
  if (blockIdx.x < p.nitems) {
    const int32_t item = p.items == nullptr ? static_cast<int32_t>(blockIdx.x) : p.items[blockIdx.x];
    if (item >= 0) {
      pull_chunk<T, MUL, ADD, MASKED>(a, p, item);
    } else {
      pull_piece<T, MUL, ADD, MASKED>(a, p, -1 - item);
    }
    return;
  }
  const long long slab = (static_cast<long long>(blockIdx.x) - p.nitems) * kWarpsPerCta + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int team = lane >> LOG2G, sub = lane & (g - 1);
  const Head h = head<LOG2G>(a.m, a.indptr, a.row_sel, p, slab, team);
  T acc = monoid_identity<ADD, T>();
  bool any = false;
  if (h.walk) fold_range<T, MUL, ADD, MASKED>(h.start + sub, h.end, g, a, acc, any);
#pragma unroll
  for (int off = g >> 1; off > 0; off >>= 1) acc = apply_op<ADD>(acc, __shfl_xor_sync(kFullMask, acc, off));
  any = (__ballot_sync(kFullMask, any) & team_mask<LOG2G>(lane)) != 0;
  if (sub == 0 && h.store) {
    const T init_v = a.init_of();
    a.out[h.row] = any ? apply_op<ADD>(init_v, acc) : init_v;
    if (a.has != nullptr) a.has[h.row] = any;
  }
}

struct HitArgs {
  long long m;
  const int32_t* indptr;
  const int32_t* cols;
  const uint32_t* x_bits;  // bit j & 31 of word j >> 5 set where x[j] is valid
  const uint8_t* row_sel;
  uint8_t* hits;  // zero at launch where the matrix has hub rows
};

// Whether a round's columns hold a valid one.  The bit words are loaded
// one by one, each only while none before it was set: the bitmap stays in
// L2, so a step costs an L2 hit, and a dense mask stops after the first
// (measured faster than all kUnroll words loaded before any test, at 10%
// to 100% valid: PERF.md, kernel 1's findings).
__device__ __forceinline__ bool round_hits(const int32_t (&c)[kUnroll], const uint32_t* x_bits) {
  bool found = false;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    found = found || (c[u] >= 0 && ((__ldg(x_bits + (c[u] >> 5)) >> (c[u] & 31)) & 1u));
  return found;
}

template <int LOG2G>
__global__ void __launch_bounds__(kThreads)
spmv_pull_structural_kernel(HitArgs a, PullPlan p) {
  int32_t c[kUnroll];
  int32_t unused[kUnroll];
  if (blockIdx.x < p.nchunks) {  // a hub chunk: the CTA stops at its first round with a hit
    Chunk ch;
    if (!ch.load(p, static_cast<int32_t>(blockIdx.x), a.row_sel)) return;
    for (int32_t base = ch.c0; base < ch.c1; base += kUnroll * kThreads) {
      issue<int32_t, false>(c, unused, a.cols, nullptr, base + static_cast<int32_t>(threadIdx.x), ch.c1,
                            kThreads);
      if (__syncthreads_or(round_hits(c, a.x_bits))) {
        if (threadIdx.x == 0) a.hits[ch.row] = 1;  // every chunk that hits writes 1
        return;
      }
      if (ch.c1 - base <= kUnroll * kThreads) break;
    }
    return;
  }
  const long long slab = (static_cast<long long>(blockIdx.x) - p.nchunks) * kWarpsPerCta + (threadIdx.x >> 5);
  constexpr int g = 1 << LOG2G;
  const int lane = threadIdx.x & 31;
  const int team = lane >> LOG2G, sub = lane & (g - 1);
  const unsigned tmask = team_mask<LOG2G>(lane);
  const Head h = head<LOG2G>(a.m, a.indptr, a.row_sel, p, slab, team);
  // every lane votes in every round until each team has a hit or its row ends
  bool active = h.walk, hit = false;
  for (int32_t k = h.start + sub; __any_sync(kFullMask, active); k += kUnroll * g) {
    if (active) issue<int32_t, false>(c, unused, a.cols, nullptr, k, h.end, g);
    const bool team_hit = (__ballot_sync(kFullMask, active && round_hits(c, a.x_bits)) & tmask) != 0;
    hit = hit || team_hit;
    active = active && !team_hit && h.end - k > kUnroll * g;
  }
  if (sub == 0 && h.store) a.hits[h.row] = hit;
}

unsigned grid_of(long long m, const PullPlan& p) {
  const long long slabs = (m + (32 >> p.log2g) - 1) >> (5 - p.log2g);
  return static_cast<unsigned>(p.nitems + (slabs + kWarpsPerCta - 1) / kWarpsPerCta);
}

template <bool MASKED>
struct PullLaunch {
  long long m;
  const void *indptr, *cols, *values, *x, *x_bits, *row_sel, *init;
  uint32_t init_bits;
  void *out, *has;
  PullPlan plan;
  cudaStream_t stream;
  int mul = 0;  // the generic family's mul and operand swap
  bool swap = false;

  template <typename T, int MUL, int ADD>
  void run() {
    static_assert(sizeof(T) == sizeof(init_bits), "init travels as its 32 bits");
    T init_value;
    memcpy(&init_value, &init_bits, sizeof(T));
    const PullArgs<T> a{m, static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(cols),
                        static_cast<const T*>(values), static_cast<const T*>(x),
                        static_cast<const uint32_t*>(x_bits), static_cast<const uint8_t*>(row_sel),
                        static_cast<const T*>(init), init_value, static_cast<T*>(out),
                        static_cast<uint8_t*>(has), mul, swap};
    const unsigned grid = grid_of(m, plan);
    switch (plan.log2g) {
      case 1: spmv_pull_kernel<T, MUL, ADD, 1, MASKED><<<grid, kThreads, 0, stream>>>(a, plan); break;
      case 2: spmv_pull_kernel<T, MUL, ADD, 2, MASKED><<<grid, kThreads, 0, stream>>>(a, plan); break;
      case 3: spmv_pull_kernel<T, MUL, ADD, 3, MASKED><<<grid, kThreads, 0, stream>>>(a, plan); break;
      case 4: spmv_pull_kernel<T, MUL, ADD, 4, MASKED><<<grid, kThreads, 0, stream>>>(a, plan); break;
      default: spmv_pull_kernel<T, MUL, ADD, 5, MASKED><<<grid, kThreads, 0, stream>>>(a, plan);
    }
  }
};

// The plan of the C arguments; segments 1 (and no items) for the
// structural kernel's.
PullPlan plan_of(int log2g, int hub_len, long long nhub, long long nchunks, const void* chunk_row,
                 const void* chunk_c0, const void* chunk_c1, const void* chunk_hub, const void* chunk_first,
                 int segments, long long nitems, long long nshort, const void* items, const void* short_rows,
                 const void* cuts, void* part, void* part_any, void* done) {
  return PullPlan{static_cast<const int32_t*>(chunk_row), static_cast<const int32_t*>(chunk_c0),
                  static_cast<const int32_t*>(chunk_c1), static_cast<const int32_t*>(chunk_hub),
                  static_cast<const int32_t*>(chunk_first), nhub, nchunks, log2g, hub_len, segments, nitems,
                  nshort, static_cast<const int32_t*>(items), static_cast<const int32_t*>(short_rows),
                  static_cast<const int32_t*>(cuts), part, static_cast<uint8_t*>(part_any),
                  static_cast<int32_t*>(done)};
}

bool plan_ok(const PullPlan& p) {
  const bool one = p.segments == 1 && p.items == nullptr && p.nitems == p.nchunks && p.nshort == 0 &&
                   p.nchunks >= p.nhub;
  const bool cut = p.segments > 1 && p.items != nullptr && p.nitems >= p.nchunks && p.nshort >= 0 &&
                   (p.nshort == 0 || (p.short_rows != nullptr && p.cuts != nullptr));
  return p.log2g >= 1 && p.log2g <= 5 && p.hub_len >= 0 && p.nhub >= 0 && (one || cut);
}

// The C entries of the value kernel (spmv_pull*.cu): the templated instances
// (GENERIC false) or the family, with a mask (MASKED: x_bits, null only
// where n is 0) or without (x_bits unread).
template <bool GENERIC, bool MASKED>
int pull_entry(int mul, bool swap, int add, int dtype, long long m, int log2g, int hub_len, long long nhub,
               long long nchunks, const void* chunk_row, const void* chunk_c0, const void* chunk_c1,
               const void* chunk_hub, const void* chunk_first, int segments, long long nitems, long long nshort,
               const void* items, const void* short_rows, const void* cuts, void* part, void* part_any, void* done,
               const void* indptr, const void* cols, const void* values, const void* x, const void* x_bits,
               const void* row_sel, const void* init, unsigned init_bits, void* out, void* has, void* stream) {
  if (m == 0) return 0;
  if (GENERIC && !runtime_mul_ok(mul, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const PullPlan plan = plan_of(log2g, hub_len, nhub, nchunks, chunk_row, chunk_c0, chunk_c1, chunk_hub,
                                chunk_first, segments, nitems, nshort, items, short_rows, cuts, part, part_any,
                                done);
  if (!plan_ok(plan)) return static_cast<int>(cudaErrorInvalidValue);
  PullLaunch<MASKED> launch{m, indptr, cols, values, x, x_bits, row_sel, init, init_bits, out, has, plan,
                            static_cast<cudaStream_t>(stream), mul, swap};
  bool ok;
  if constexpr (GENERIC) {
    ok = dispatch_generic<true, true, true, true>(add, dtype, launch);
  } else {
    ok = dispatch<true>(mul, add, dtype, launch);
  }
  if (!ok) return -1;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
