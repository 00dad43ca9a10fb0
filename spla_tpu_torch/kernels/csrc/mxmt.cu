// Kernels 4 and 5: masked SpGEMM-T by sorted-row intersection.  For each
// selected mask entry e = (i, j), the products mul(A[i,k], B[j,k]) over the
// columns k of B's row j that A's row i holds:
//   kernel 4, mxmt_reduce:  total  = sum of every product of every entry;
//   kernel 5, mxmt_masked:  out[e] = init (+) fold_(+) products(e), has[e];
// and a diagnostic instance, mxmt_gather: the same walk with no probe of A,
//   out[e] = XOR of B's row j (its columns, and its value bits).
// Kernel 4's structural instance and the gather also have an ordered walk
// (the template's ORDERED, the entry point's `ordered`): only the entries
// (i, j) with j < i, each over the columns k < j of B's row j.  On a
// symmetric 0/1 pattern with no diagonal and strictly increasing rows
// (mask = A = B, kernels/mxmt.py ordered_walk), it counts each triangle
// k < j < i once, a sixth of the full sum: GAP's OrderedCount (gapbs
// src/tc.cc), which algorithms.tc takes there.  On urand (degree 32) it
// gathers half the B rows, each over ~1/3 of its length, ~16% of the
// products.
//
// Replaces spla_tpu/pallas/mxmt.py pallas_mxmT_reduce (:335, kernel
// _make_reduce_kernel :235) and pallas_mxmT_job_partials (:362, kernel
// _make_partials_kernel :260) with the segment fold after it
// (spla_tpu/ops/spgemm.py:711).  The TPU has no gather, so a host packer
// (native/pairpack.cpp) cuts every mask entry into 8 x 8 chunk-pair jobs
// that the TPU kernel compares all-pairs.  On Hopper a lane reads B.cols[t]
// itself, so these kernels take the plain CSR of the mask, A and B, and a
// launch plan built on the device (kernels/mxmt.py mxmt_plan).
//
// Bound: the latency of dependent loads, and under it the gathers of B's
// rows.  Per mask entry a lane reads the entry's row, column and selection,
// two A and two B indptr words and B's row j, and each element of that row
// bisects A's row i (~log2(deg) dependent probes).  The gathers of B's rows
// (random rows of ~17 entries at n = 2^20, 67 MB of columns, beyond the 50
// MB L2) are what no design avoids: mxmt_gather, the same walk with no
// probe of A, measures them (PERF.md).  The design keeps entries in flight
// and takes the probes off L1/L2:
//   * the mask's stored entries are walked in windows of kWindow, a warp a
//     window and a lane an entry (a long mask row spans several windows):
//     each lane loads its entry's row id, column and selection byte (the
//     one-pass streams, with the streaming hint), then its A row's bounds
//     and its B range; the window's rows are consecutive, so their rows of A
//     are one stretch of A, which the warp stages in shared memory when it
//     holds at most kStage entries: a probe is then a shared-memory access.
//     Otherwise the window's entries probe A in global memory;
//   * teams of kTeam (2) lanes fold the window's entries, 16 at once.  A
//     lane issues kUnroll loads of B's columns (and values) at once and
//     bisects for all kUnroll together (the trip count depends only on A's
//     row length, so the steps interleave), and a team issues its next
//     entry's first batch before it folds the current entry;
//   * a B row longer than hub_len entries is cut into chunks of HUB_CHUNK
//     entries, a CTA each, first in the launch; the CTA stages A's row i in
//     the shared memory of all its warps (kChunkStage entries).  Kernel 4
//     adds the chunks' sums into its total; kernel 5 folds an entry's
//     chunks in chunk order (semiring.cuh fold_chunks), so MIN, MAX and
//     integer results are bitwise those of the plain version; the gather
//     XORs them in with atomics;
//   * the lower-bound search makes the first of equal columns in A's row
//     match, as spla_tpu.utils.search.rowwise_find does, and every element
//     of B's row counts, duplicates included;
//   * kernel 4 keeps a lane-local sum over a grid-stride loop of windows,
//     folds it with shuffles and shared memory and adds one 64-bit atomic
//     per CTA: i32 products sum in int64 (two's complement, as uint64), hits
//     of the structural instance in int64, f32 products in f64 (the f64
//     atomics add in no fixed order).  Its structural instance takes no
//     selection: every stored entry (the windows end at indptr[m]);
//   * the ordered walk keeps, of a window, the entries (i, j) with j < i
//     that have B entries, packed to the front by a ballot (about 16 of 32
//     on a symmetric graph: one round of the 16 teams, not two); a lane
//     folds only B's columns below j and stops after the first batch of
//     kUnroll whose last column reaches j (B's rows are sorted).  A hub
//     chunk of an entry with j >= i returns at once; the others cut their
//     stretch at B's first column not below j (a bisection of the chunk).
//     The warp issues its teams' first B batches before it stages A's rows,
//     so the two dependent loads overlap (kernel 4 46.7 -> 43.4 ms at
//     urand-tc's size, PERF.md); the probes into A's row i are the full
//     walk's.  Instances without the walk compile to the full walk's code.
// Tried and dropped (tools/mxmt_times.py; PERF.md has the numbers): the
// first design, a warp per entry with each lane bisecting A's row in global
// memory (half the lanes idle at degree 16, one entry in flight a warp);
// units of one mask row a warp (~16 entries, one more dependent load a
// unit; kernel 5 and the gather 7-15% slower, in another call); teams of 4,
// 8 or 16 lanes from the mean length of the B rows reached (kernel 1's
// rule; up to 2.1x slower than teams of 2 at n = 2^20, and no faster at
// degree 48-192), and of 1 lane; 8 CTAs an SM by __launch_bounds__
// (spills, 1.6-6x slower); no streaming hint on the mask (no change); the
// next batch of an entry kept in flight while one is folded (within 2%,
// 9-24 more registers); in the ordered walk, the second batch issued with
// the first (1% faster at n = 2^24 degree 32, its gather floor 13% slower).
//
// Coverage: one family each (semiring.cuh's generic family), whose mul is a
// kernel argument.  Kernel 5, add in {PLUS, MIN, MAX} x {f32, i32, u32}
// (kernels/mxmt.py sends it every f32 mul and PLUS, MULT, FIRST, SECOND,
// MIN, MAX in i32 and u32: spla_tpu's Pallas SpGEMM-T gate), and a
// structural instance per (add, dtype) whose every hit's product is 1.
// Kernel 4, an instance each in f32, i32 and u32 (u32 products sum
// zero-extended in uint64), and a structural instance that counts hits and
// reads no values; the gather with and without values.  A templated
// instance per mul was no faster (PERF.md).

#include <cstring>
#include <type_traits>

#include "semiring.cuh"

namespace {

enum Mode : int { kReduce = 0, kMasked = 1, kGather = 2 };  // spla_mxmt's mode (kernels/mxmt.py _launch)

constexpr int kStruct = -1;          // MUL of the structural instances (and of the gather without values)
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 32;          // stored entries a warp walks at once; kept equal to kernels/mxmt.py WINDOW
constexpr int kStage = 256;          // A entries a warp stages; kept equal to kernels/mxmt.py A_STAGE
constexpr int kChunkStage = kStage * kWarps;  // A-row entries a chunk CTA stages
constexpr int kUnroll = 4;           // B loads a lane issues before it probes
constexpr int kTeam = 2;             // lanes that fold one entry; kept equal to kernels/mxmt.py TEAM
constexpr unsigned kMaxWindowCtas = 132 * 8;  // CTAs of the windows' grid-stride loop

// i32 products and hits sum as uint64 (two's complement int64); f32 in f64.
template <typename T, int MUL>
using ReduceAcc = std::conditional_t<std::is_same_v<T, float> && MUL != kStruct, double,
                                     unsigned long long>;

template <int MODE, typename T, int MUL>
using AccOf = std::conditional_t<MODE == kGather, uint32_t,
                                 std::conditional_t<MODE == kMasked, T, ReduceAcc<T, MUL>>>;

template <int MODE, int ADD, typename Acc>
__device__ __forceinline__ Acc acc_identity() {
  if constexpr (MODE == kMasked) return monoid_identity<ADD, Acc>();
  else return Acc(0);
}

template <int MODE, int ADD, typename Acc>
__device__ __forceinline__ Acc combine(Acc a, Acc b) {
  if constexpr (MODE == kMasked) return apply_op<ADD>(a, b);
  else if constexpr (MODE == kGather) return a ^ b;
  else return a + b;
}

template <int MODE, int ADD, typename Acc, typename T>
__device__ __forceinline__ void accumulate(Acc& acc, T v) {
  if constexpr (MODE == kMasked) {
    acc = apply_op<ADD>(acc, v);
  } else if constexpr (std::is_same_v<Acc, double>) {
    acc += static_cast<double>(v);
  } else {
    acc += static_cast<unsigned long long>(static_cast<long long>(v));
  }
}

template <bool GLOBAL, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (GLOBAL) return __ldg(p);
  else return *p;
}

__device__ __forceinline__ uint32_t bits_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits_of(int32_t v) { return static_cast<uint32_t>(v); }

// For each u, the first position in a[0, n) whose column is not below
// key[u] (n if none); n >= 1.  The trip count depends only on n, so the
// kUnroll searches advance in step and a team's lanes stay together.
template <bool GLOBAL>
__device__ __forceinline__ void lower_bounds(const int32_t* __restrict__ a, int32_t n,
                                             const int32_t (&key)[kUnroll], int32_t (&pos)[kUnroll]) {
  int32_t base[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) base[u] = 0;
  for (int32_t len = n; len > 1;) {
    const int32_t half = len >> 1;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) base[u] = load<GLOBAL>(a + base[u] + half) < key[u] ? base[u] + half : base[u];
    len -= half;
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) pos[u] = base[u] + (load<GLOBAL>(a + base[u]) < key[u]);
}

template <int MUL, typename T>
__device__ __forceinline__ T product(T a, T b, int mul) {
  if constexpr (MUL == kStruct) return T(1);  // every hit's product is 1
  else return apply_mul<MUL>(a, b, mul, false);
}

}  // namespace

struct MxmtArgs {
  long long cap;  // mask capacity
  const int32_t* m_rows;  // the mask's row ids (row_ids)
  const int32_t* m_cols;
  const uint8_t* sel;  // null: every stored entry
  const int32_t *a_indptr, *a_cols;
  const void* a_vals;
  const int32_t *b_indptr, *b_cols;
  const void* b_vals;
  int mul;  // the generic instances' mul (a KernelCode)
};

// The launch shape (kernels/mxmt.py mxmt_plan).  Window w holds stored
// entries [w * kWindow, min((w + 1) * kWindow, stored)).  Hub h
// (the h-th stored entry whose B row is longer than hub_len) has chunks
// chunk_first[h] .. chunk_first[h + 1] - 1; chunk b walks entries
// [chunk_c0[b], chunk_c1[b]) of B for mask entry chunk_entry[b] of row
// chunk_row[b].
struct MxmtPlan {
  const int32_t *chunk_entry, *chunk_row, *chunk_c0, *chunk_c1, *chunk_hub;  // [nchunks]
  const int32_t* chunk_first;         // [nhub + 1]
  long long stored, nhub, nchunks;    // stored: the mask's indptr[m]
  int hub_len;
  void* part;          // [nchunks] T: each chunk's fold (kernel 5, hubs of several chunks)
  uint8_t* part_any;   // [nchunks]
  int32_t* done;       // [nhub]: chunks of each hub finished; zero between launches
};

// What a launch writes: kernel 5 out/has (and its init), kernel 4 total,
// the gather out (32-bit words, zero at launch where B has hub rows).
template <typename T>
struct Sink {
  const T* init;  // on the device, or null: then init_value
  T init_value;
  void* out;
  uint8_t* has;
  void* total;

  __device__ T init_of() const { return init != nullptr ? *init : init_value; }
};

template <typename T, bool VALUES, bool ORDERED>
struct MxmtShared {
  int32_t cols[kWarps * kStage];  // a warp's staged rows of A at cols + warp * kStage
  T vals[VALUES ? kWarps * kStage : 1];
  int32_t lo[kWarps][kWindow], hi[kWarps][kWindow];      // each entry's B range
  int32_t a_off[kWarps][kWindow], a_len[kWarps][kWindow];  // and its A row
  int32_t lim[ORDERED ? kWarps : 1][kWindow];  // the ordered walk: the entry's column j (B's columns below it)
  int32_t src[ORDERED ? kWarps : 1][kWindow];  // and its lane in the window (the gather's output)
};

// A lane's next kUnroll entries of B, t, t + stride, ... (column -1 at and
// past end), with their values where the instance reads values.
template <typename T, bool VALUES>
struct Batch {
  int32_t k[kUnroll];
  T v[kUnroll];

  __device__ __forceinline__ void issue(const MxmtArgs& o, int32_t t, int32_t end, int stride) {
    const T* __restrict__ b_vals = static_cast<const T*>(o.b_vals);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int32_t e = t + u * stride;
      k[u] = e < end ? __ldg(o.b_cols + e) : -1;
      v[u] = VALUES && e < end ? __ldg(b_vals + e) : T(0);
    }
  }
};

// Fold one batch against A's row a[0, na) (staged or in global memory; na
// >= 1 unless the gather, which reads no A).
template <int MODE, typename T, int MUL, int ADD, bool GLOBAL, bool ORDERED>
__device__ __forceinline__ void fold_batch(const Batch<T, MUL != kStruct>& b, const int32_t* __restrict__ a,
                                           const T* __restrict__ av, int32_t na, int mul, int32_t lim,
                                           AccOf<MODE, T, MUL>& acc, bool& any) {
  if constexpr (MODE == kGather) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (b.k[u] >= 0 && (!ORDERED || b.k[u] < lim)) {
        acc ^= static_cast<uint32_t>(b.k[u]);
        if constexpr (MUL != kStruct) acc ^= bits_of(b.v[u]);
      }
    }
  } else {
    int32_t p[kUnroll];
    lower_bounds<GLOBAL>(a, na, b.k, p);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (b.k[u] >= 0 && (!ORDERED || b.k[u] < lim) && p[u] < na && load<GLOBAL>(a + p[u]) == b.k[u]) {
        T av_p = T(0);
        if constexpr (MUL != kStruct) av_p = load<GLOBAL>(av + p[u]);
        accumulate<MODE, ADD>(acc, product<MUL>(av_p, b.v[u], mul));
        any = true;
      }
    }
  }
}

// Whether the ordered walk goes on past this batch: its last column (the
// lane's furthest) is still below lim, so a later one may be too.
template <typename T, bool VALUES>
__device__ __forceinline__ bool below(const Batch<T, VALUES>& b, int32_t lim) {
  return b.k[kUnroll - 1] >= 0 && b.k[kUnroll - 1] < lim;
}

// Fold this lane's share of B's entries [t, end) (t, t + stride, ...),
// whose first batch is already issued into `first`.  The one routine of
// all three modes.  The ordered walk folds only B's columns below lim and
// stops after the first batch that reaches it (B's rows are sorted).
template <int MODE, typename T, int MUL, int ADD, bool GLOBAL, bool ORDERED>
__device__ __forceinline__ void walk(const MxmtArgs& o, const int32_t* __restrict__ a,
                                     const T* __restrict__ av, int32_t na, const Batch<T, MUL != kStruct>& first,
                                     int32_t t, int32_t end, int stride, int32_t lim, AccOf<MODE, T, MUL>& acc,
                                     bool& any) {
  fold_batch<MODE, T, MUL, ADD, GLOBAL, ORDERED>(first, a, av, na, o.mul, lim, acc, any);
  if constexpr (ORDERED) {
    if (!below(first, lim)) return;
  }
  const int32_t step = kUnroll * stride;
  for (int32_t off = step; off < end - t; off += step) {  // no overflow of t + off past end
    Batch<T, MUL != kStruct> b;
    b.issue(o, t + off, end, stride);
    fold_batch<MODE, T, MUL, ADD, GLOBAL, ORDERED>(b, a, av, na, o.mul, lim, acc, any);
    if constexpr (ORDERED) {
      if (!below(b, lim)) return;
    }
  }
}

// The first position in a[0, n) whose column is not below key (n if none).
__device__ __forceinline__ int32_t first_not_below(const int32_t* __restrict__ a, int32_t n, int32_t key) {
  int32_t lo = 0;
  while (n > 0) {
    const int32_t half = n >> 1;
    if (__ldg(a + lo + half) < key) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// One window of stored entries, walked by one warp, a lane an entry: each
// lane loads its entry's row, column and selection (the one-pass streams,
// with the streaming hint), then its A row's bounds and B range; the
// window's rows are consecutive, so their rows of A are one stretch, which
// the warp stages in shared memory; then teams of kTeam lanes fold the
// entries, each team issuing its next entry's first batch before it folds
// the current one.  Kernel 4 leaves its sums in lane_acc; kernel 5 and the
// gather write each entry.  The ordered walk keeps only the entries (i, j)
// with j < i that have B entries to walk and packs them to the front of
// the window (a ballot), so that no team idles on another.
template <int MODE, typename T, int MUL, int ADD, bool ORDERED>
__device__ __forceinline__ void window_walk(const MxmtArgs& o, const MxmtPlan& p, const Sink<T>& s,
                                            MxmtShared<T, MUL != kStruct, ORDERED>& sh, long long w, int warp,
                                            int lane, AccOf<MODE, T, MUL>& lane_acc) {
  using Acc = AccOf<MODE, T, MUL>;
  constexpr bool kValues = MUL != kStruct;
  constexpr int g = kTeam, teams = 32 / kTeam;
  const T* __restrict__ a_vals = static_cast<const T*>(o.a_vals);
  const long long e0 = w * kWindow, e = e0 + lane;
  const int ne = static_cast<int>(min(static_cast<long long>(kWindow), p.stored - e0));
  const bool in = lane < ne;
  int32_t row = 0, j = 0;
  bool selected = false;
  if (in) {
    row = __ldcs(o.m_rows + e);
    j = __ldcs(o.m_cols + e);
    selected = o.sel == nullptr || __ldcs(o.sel + e);
  }
  int32_t a0 = 0, a1 = 0, lo = 0, hi = 0;
  if (in) {
    if constexpr (MODE != kGather) {
      a0 = __ldg(o.a_indptr + row);
      a1 = __ldg(o.a_indptr + row + 1);
    }
    if (selected) {
      lo = __ldg(o.b_indptr + j);
      hi = __ldg(o.b_indptr + j + 1);
    }
  }
  const int32_t base = __shfl_sync(kFullMask, a0, 0), top = __shfl_sync(kFullMask, a1, ne - 1);
  const bool staged = MODE != kGather && top - base <= kStage;
  int32_t* __restrict__ s_cols = sh.cols + warp * kStage;
  T* __restrict__ s_vals = sh.vals + (kValues ? warp * kStage : 0);
  const auto stage = [&] {
    for (int32_t k = lane; k < top - base; k += 32) {
      s_cols[k] = __ldg(o.a_cols + base + k);
      if constexpr (kValues) s_vals[k] = __ldg(a_vals + base + k);
    }
  };
  if (staged && !ORDERED) stage();  // the ordered walk stages once its first B loads are in flight
  bool empty = false;  // selected with no product, or not selected: written here
  if (in) {
    if (hi - lo > p.hub_len) {
      lo = hi = 0;  // the entry's chunk CTAs write it
    } else {
      empty = hi == lo || (MODE != kGather && a1 == a0) || (ORDERED && j >= row);
    }
  }
  if (empty) {
    lo = hi = 0;
    if constexpr (MODE == kMasked) {
      static_cast<T*>(s.out)[e] = s.init_of();
      s.has[e] = 0;
    } else if constexpr (MODE == kGather) {
      static_cast<uint32_t*>(s.out)[e] = 0;
    }
  }
  int slot = lane, nf = ne;  // the entry's place among those the teams fold, and their count
  if constexpr (ORDERED) {
    const unsigned live = __ballot_sync(kFullMask, lo != hi);
    slot = __popc(live & ((1u << lane) - 1u));
    nf = __popc(live);
    if (lo != hi) {
      sh.lim[warp][slot] = j;
      sh.src[warp][slot] = lane;
    }
  }
  if (!ORDERED || lo != hi) {
    sh.lo[warp][slot] = lo;
    sh.hi[warp][slot] = hi;
    sh.a_off[warp][slot] = staged ? a0 - base : a0;
    sh.a_len[warp][slot] = a1 - a0;
  }
  __syncwarp();
  const int team = lane / g, sub = lane % g;
  const unsigned tmask = ((1u << g) - 1u) << (lane & ~(g - 1));
  const int32_t* a_cols = staged ? s_cols : o.a_cols;
  const T* av = staged ? s_vals : a_vals;
  int32_t blo = 0, bhi = 0;
  if (team < nf) {
    blo = sh.lo[warp][team];
    bhi = sh.hi[warp][team];
  }
  Batch<T, kValues> cur;
  cur.issue(o, blo + sub, bhi, g);
  if constexpr (ORDERED) {
    if (staged) stage();
    __syncwarp();
  }
  for (int q = team; q < nf; q += teams) {
    const int qn = q + teams;
    int32_t nlo = 0, nhi = 0;
    if (qn < nf) {
      nlo = sh.lo[warp][qn];
      nhi = sh.hi[warp][qn];
    }
    Batch<T, kValues> next;
    next.issue(o, nlo + sub, nhi, g);
    if (blo != bhi) {  // uniform across the team
      const int32_t off = sh.a_off[warp][q], na = sh.a_len[warp][q];
      int32_t lim = 0;
      if constexpr (ORDERED) lim = sh.lim[warp][q];
      Acc acc = acc_identity<MODE, ADD, Acc>();
      bool any = false;
      if (staged) {
        walk<MODE, T, MUL, ADD, false, ORDERED>(o, a_cols + off, av + off, na, cur, blo + sub, bhi, g, lim,
                                                acc, any);
      } else {
        walk<MODE, T, MUL, ADD, true, ORDERED>(o, a_cols + off, av + off, na, cur, blo + sub, bhi, g, lim,
                                               acc, any);
      }
      if constexpr (MODE == kReduce) {
        lane_acc += acc;
      } else {
#pragma unroll
        for (int o2 = g >> 1; o2 > 0; o2 >>= 1) acc = combine<MODE, ADD>(acc, __shfl_xor_sync(tmask, acc, o2));
        any = (__ballot_sync(tmask, any) & tmask) != 0;
        if (sub == 0) {
          if constexpr (MODE == kMasked) {
            const T init_v = s.init_of();
            static_cast<T*>(s.out)[e0 + q] = any ? apply_op<ADD>(init_v, acc) : init_v;
            s.has[e0 + q] = any;
          } else if constexpr (ORDERED) {
            static_cast<uint32_t*>(s.out)[e0 + sh.src[warp][q]] = acc;
          } else {
            static_cast<uint32_t*>(s.out)[e0 + q] = acc;
          }
        }
      }
    }
    cur = next;
    blo = nlo;
    bhi = nhi;
  }
  __syncwarp();  // the window's shared rows are read before the next window stages its own
}

// This CTA's hub chunk: a stretch of a long B row for one mask entry.  The
// ordered walk skips an entry (i, j) with j >= i and cuts the stretch at
// B's first column not below j.
template <int MODE, typename T, int MUL, int ADD, bool ORDERED>
__device__ __forceinline__ void chunk_walk(const MxmtArgs& o, const MxmtPlan& p, const Sink<T>& s,
                                           MxmtShared<T, MUL != kStruct, ORDERED>& sh,
                                           AccOf<MODE, T, MUL>& lane_acc) {
  using Acc = AccOf<MODE, T, MUL>;
  constexpr bool kValues = MUL != kStruct;
  __shared__ Acc red[kWarps];
  __shared__ bool red_any[kWarps];
  const int32_t b = static_cast<int32_t>(blockIdx.x);
  const int32_t e = p.chunk_entry[b];
  if (o.sel != nullptr && !o.sel[e]) return;  // uniform: the window walk writes init
  const int32_t row = p.chunk_row[b], c0 = p.chunk_c0[b];
  int32_t c1 = p.chunk_c1[b], lim = 0;
  if constexpr (ORDERED) {  // uniform across the CTA
    lim = o.m_cols[e];
    if (lim >= row) return;
    c1 = c0 + first_not_below(o.b_cols + c0, c1 - c0, lim);
    if (c1 == c0) return;
  }
  const T* __restrict__ a_vals = static_cast<const T*>(o.a_vals);
  const int tid = threadIdx.x;
  Batch<T, kValues> first;
  first.issue(o, c0 + tid, c1, kThreads);
  int32_t a_lo = 0, na = 0;
  if constexpr (MODE != kGather) {
    a_lo = o.a_indptr[row];
    na = o.a_indptr[row + 1] - a_lo;
  }
  Acc acc = acc_identity<MODE, ADD, Acc>();
  bool any = false;
  if (MODE == kGather || na > 0) {
    const bool staged = MODE != kGather && na <= kChunkStage;
    if (staged) {
      for (int32_t k = tid; k < na; k += kThreads) {
        sh.cols[k] = __ldg(o.a_cols + a_lo + k);
        if constexpr (kValues) sh.vals[k] = __ldg(a_vals + a_lo + k);
      }
      __syncthreads();
      walk<MODE, T, MUL, ADD, false, ORDERED>(o, sh.cols, sh.vals, na, first, c0 + tid, c1, kThreads, lim, acc,
                                              any);
    } else {
      walk<MODE, T, MUL, ADD, true, ORDERED>(o, o.a_cols + a_lo, a_vals + a_lo, na, first, c0 + tid, c1,
                                             kThreads, lim, acc, any);
    }
  }
  if constexpr (MODE == kReduce) {
    lane_acc += acc;
    return;
  } else {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc = combine<MODE, ADD>(acc, __shfl_xor_sync(kFullMask, acc, off));
    any = __any_sync(kFullMask, any);
    const int lane = tid & 31, warp = tid >> 5;
    if (lane == 0) {
      red[warp] = acc;
      red_any[warp] = any;
    }
    __syncthreads();
    if (tid != 0) return;
    Acc v = red[0];
    bool hit = red_any[0];
    for (int w = 1; w < kWarps; ++w) {
      v = combine<MODE, ADD>(v, red[w]);
      hit = hit || red_any[w];
    }
    if constexpr (MODE == kGather) {
      atomicXor(static_cast<unsigned int*>(s.out) + e, v);
    } else {
      const int32_t hub = p.chunk_hub[b];
      const int32_t first_chunk = p.chunk_first[hub], count = p.chunk_first[hub + 1] - first_chunk;
      if (count > 1 && !fold_chunks<ADD>(static_cast<T*>(p.part), p.part_any, p.done, hub, b, first_chunk,
                                         count, v, hit)) {
        return;  // another chunk of the entry folds them all
      }
      const T init_v = s.init_of();
      static_cast<T*>(s.out)[e] = hit ? apply_op<ADD>(init_v, v) : init_v;
      s.has[e] = hit;
    }
  }
}

template <int MODE, typename T, int MUL, int ADD, bool ORDERED>
__global__ void __launch_bounds__(kThreads)
mxmt_kernel(MxmtArgs o, MxmtPlan p, Sink<T> s) {
  using Acc = AccOf<MODE, T, MUL>;
  __shared__ MxmtShared<T, MUL != kStruct, ORDERED> sh;
  Acc lane_acc = 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (blockIdx.x < p.nchunks) {
    chunk_walk<MODE, T, MUL, ADD, ORDERED>(o, p, s, sh, lane_acc);
    if constexpr (MODE != kReduce) return;
  } else {
    const long long ctas = static_cast<long long>(gridDim.x) - p.nchunks;
    const long long cta = static_cast<long long>(blockIdx.x) - p.nchunks;
    const long long windows = (p.stored + kWindow - 1) / kWindow;
    for (long long w = cta * kWarps + warp; w < windows; w += ctas * kWarps) {
      window_walk<MODE, T, MUL, ADD, ORDERED>(o, p, s, sh, w, warp, lane, lane_acc);
    }
    if constexpr (MODE == kMasked) {  // capacity padding past indptr[m]
      const T init_v = s.init_of();
      for (long long e = p.stored + cta * kThreads + threadIdx.x; e < o.cap; e += ctas * kThreads) {
        static_cast<T*>(s.out)[e] = init_v;
        s.has[e] = 0;
      }
    }
  }
  if constexpr (MODE == kReduce) {
    __shared__ Acc warp_sums[kWarps];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) lane_acc += __shfl_xor_sync(kFullMask, lane_acc, off);
    if (lane == 0) warp_sums[warp] = lane_acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      Acc total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
      if (total != Acc(0)) atomicAdd(static_cast<Acc*>(s.total), total);
    }
  }
}

namespace {

struct MxmtLaunch {
  MxmtArgs o;
  MxmtPlan p;
  const void* init;
  uint32_t init_bits;
  void *out, *has, *total;
  cudaStream_t stream;

  template <int MODE, typename T, int MUL, int ADD, bool ORDERED = false>
  void run_mode() {
    static_assert(sizeof(T) == sizeof(init_bits), "init travels as its 32 bits");
    T init_value;
    memcpy(&init_value, &init_bits, sizeof(T));
    const Sink<T> s{static_cast<const T*>(init), init_value, out, static_cast<uint8_t*>(has), total};
    const long long windows = (p.stored + kWindow - 1) / kWindow;
    const long long want = (windows + kWarps - 1) / kWarps;
    const unsigned window_ctas = static_cast<unsigned>(want < 1 ? 1 : (want < kMaxWindowCtas ? want : kMaxWindowCtas));
    mxmt_kernel<MODE, T, MUL, ADD, ORDERED>
        <<<static_cast<unsigned>(p.nchunks) + window_ctas, kThreads, 0, stream>>>(o, p, s);
  }

  // the functor semiring.cuh's dispatch_generic calls: kernel 5's (add, dtype)
  template <typename T, int MUL, int ADD>
  void run() {
    run_mode<kMasked, T, MUL, ADD>();
  }
};

// The structural kernel 5 instances: the functor dispatch_add calls.
struct StructLaunch {
  MxmtLaunch& l;
  template <typename T, int MUL, int ADD>
  void run() {
    l.run_mode<kMasked, T, kStruct, ADD>();
  }
};

bool plan_ok(const MxmtPlan& p) {
  return p.hub_len >= 0 && p.stored >= 0 && p.nhub >= 0 && p.nchunks >= p.nhub;
}

}  // namespace

extern "C" int spla_mxmt(int mode, int mul, int add, int dtype, int structural, int ordered, long long cap,
                         const void* m_rows, const void* m_cols, const void* sel, const void* a_indptr,
                         const void* a_cols, const void* a_vals, const void* b_indptr, const void* b_cols,
                         const void* b_vals, int hub_len, long long stored, long long nhub,
                         long long nchunks, const void* chunk_entry,
                         const void* chunk_row, const void* chunk_c0, const void* chunk_c1,
                         const void* chunk_hub, const void* chunk_first, void* part, void* part_any, void* done,
                         const void* init, unsigned init_bits, void* out, void* has, void* total, void* stream) {
  if (cap == 0) return 0;
  const MxmtArgs o{cap, static_cast<const int32_t*>(m_rows), static_cast<const int32_t*>(m_cols),
                   static_cast<const uint8_t*>(sel), static_cast<const int32_t*>(a_indptr),
                   static_cast<const int32_t*>(a_cols), a_vals, static_cast<const int32_t*>(b_indptr),
                   static_cast<const int32_t*>(b_cols), b_vals, mul};
  const MxmtPlan p{static_cast<const int32_t*>(chunk_entry), static_cast<const int32_t*>(chunk_row),
                   static_cast<const int32_t*>(chunk_c0), static_cast<const int32_t*>(chunk_c1),
                   static_cast<const int32_t*>(chunk_hub), static_cast<const int32_t*>(chunk_first),
                   stored, nhub, nchunks, hub_len, part, static_cast<uint8_t*>(part_any),
                   static_cast<int32_t*>(done)};
  if (!plan_ok(p)) return static_cast<int>(cudaErrorInvalidValue);
  MxmtLaunch launch{o, p, init, init_bits, out, has, total, static_cast<cudaStream_t>(stream)};
  bool ok = true;
  if (!structural && mode != kGather && !runtime_mul_ok(mul, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ordered && !(mode == kGather || (mode == kReduce && structural))) return -1;
  if (mode == kMasked) {
    StructLaunch st{launch};
    if (!structural) {
      ok = dispatch_generic<true, true, true, false>(add, dtype, launch);
    } else if (dtype == DT_F32) {
      ok = dispatch_add<true, float, kStruct>(add, st);
    } else if (dtype == DT_I32) {
      ok = dispatch_add<true, int32_t, kStruct>(add, st);
    } else if (dtype == DT_U32) {
      ok = dispatch_add<true, uint32_t, kStruct>(add, st);
    } else {
      ok = false;
    }
  } else if (mode == kReduce) {
    if (structural && ordered) {
      launch.run_mode<kReduce, int32_t, kStruct, KC_PLUS, true>();
    } else if (structural) {
      launch.run_mode<kReduce, int32_t, kStruct, KC_PLUS>();  // reads no values: one instance for every dtype
    } else if (dtype == DT_F32) {
      launch.run_mode<kReduce, float, kRuntimeMul, KC_PLUS>();
    } else if (dtype == DT_I32) {
      launch.run_mode<kReduce, int32_t, kRuntimeMul, KC_PLUS>();
    } else if (dtype == DT_U32) {
      launch.run_mode<kReduce, uint32_t, kRuntimeMul, KC_PLUS>();
    } else {
      ok = false;
    }
  } else if (mode == kGather) {
    if (structural) {  // columns only
      ordered ? launch.run_mode<kGather, int32_t, kStruct, KC_PLUS, true>()
              : launch.run_mode<kGather, int32_t, kStruct, KC_PLUS>();
    } else {  // columns and the values' 32 bits
      ordered ? launch.run_mode<kGather, int32_t, KC_PLUS, KC_PLUS, true>()
              : launch.run_mode<kGather, int32_t, KC_PLUS, KC_PLUS>();
    }
  } else {
    ok = false;
  }
  if (!ok) return -1;
  return static_cast<int>(cudaGetLastError());
}
