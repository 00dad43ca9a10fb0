// Kernel 9: row-wise Gustavson SpGEMM, C = A (+).(x) B, each row of C folded
// in one place, its entries equal to init left out, its columns in order.
//
// Replaces the Pallas ESC path of spla_tpu/ops/spgemm.py: _mxm_pallas_try
// (:213) and _mxm_esc_numeric (:196), three balanced_fused_apply passes into
// spla_tpu/pallas/spmv.py fused_cell_spmv_apply (:2055) over host-packed
// pattern formats: a gather of each product's A value, one of its B value,
// then a fold by (i, j).  The TPU has no gather and no scatter, so the host
// expands and sorts every product once (_mxm_esc_prep :99, at most 2^24 of
// them).  On Hopper a thread reads B[p, :] itself and folds into a table with
// shared-memory atomics, so this kernel takes the plain CSR of A and B, a
// plan of row bins (kernels/spgemm.py mxm_plan), and has no product cap:
// product offsets are 64-bit wherever a row's count can pass 2^31.
//
// Bound: the bytes it must move are A and B read once and C written once;
// its operations are 2 a product.  What it does beyond that: each product
// reads its B entry where B's row lies (rows of ~16 entries at random: whole
// 32-byte sectors, mostly), and folds into shared memory, its own CTA's or,
// for a large row, a cluster neighbour's.  Three C calls (kernels/spgemm.py
// mxm):
//   * spla_mxm_symbolic: each row's distinct columns, into row_nnz; the
//     wrapper's prefix sum of them is C's layout (sym), whose total it reads;
//   * spla_mxm_numeric: each row's products folded with op_add, and written
//     at sym[row] in column order with the entries equal to init left out;
//     kept[row] counts what was written;
//   * spla_mxm_compact: with ptr the prefix sum of kept, the rows at
//     ptr[row] != sym[row] (those after a left-out entry) move there, in two
//     launches (a copy out, a copy back), and [ptr[m], size) is padding
//     (column 0, init, row m).  When nothing was left out it moves nothing.
// Rows come in three bins, by their product count (mxm_plan):
//   * small (<= kSmallMax products): a warp a row, a table of the least power
//     of two >= 2 x its products (32 to 2 x kSmallMax slots) in shared
//     memory, kSmallWarps rows a CTA; its kept entries are compacted with a
//     ballot and each lane writes its own at their rank, counted against
//     every kept column four at a time (no sort);
//   * medium (<= kMediumMax): a CTA a row (512 threads in the numeric phase,
//     256 in the symbolic one), a table of
//     2^11 to 2^14 slots (the least >= 2 x its products) in dynamic shared
//     memory, a launch for each size so that small tables share an SM.  The
//     numeric phase keeps the table's kept entries (init (+) value != init)
//     in one pass, a warp's with one ballot and one shared atomicAdd that
//     reserves their place (in no order), counting each radix pass's digits
//     as it goes; then a block-wide LSD radix sort on the column, 8-bit
//     digits, one pass for each byte of n - 1: a stable scatter whose ranks
//     come from __match_any_sync within a warp and a prefix over the warps.
//     Its passes go between the two halves of the table, and the last one
//     writes C at sym[row] + rank;
//   * large: a thread-block cluster of `cluster` CTAs a row (16 by default,
//     which needs the non-portable attribute; 8 is the portable most), the
//     row's products split evenly between them.  CTA r owns columns
//     [c0 + r W, c0 + (r + 1) W) of a window of W x cluster columns and
//     keeps their values, op_add's identity between rows, in its dynamic
//     shared memory; each product folds into its
//     owner's value through distributed shared memory (map_shared_rank).
//     Where n is wider than a window the row is walked once a window.  After
//     a cluster barrier each CTA counts its kept values (a warp's ballot over
//     32 columns), the counts' prefix over the ranks, read from the other
//     CTAs' shared memory, places it in C, and each writes its columns in
//     order and resets them.  An untouched column holds the identity, and
//     init (+) identity = init, so it is left out as a folded one equal to
//     init is; that fails only for a NaN init (NaN != NaN), so then, and only
//     then, each product also marks its column in its owner's occupancy
//     bitmap (W bits beside the values) and only marked columns are kept.
//     This is the reference's dense row accumulator (cpu_mxm.hpp:88-114),
//     held on chip.
//     The symbolic phase's large rows are a CTA each with an occupancy
//     bitmap of large_words words in shared memory, in windows likewise.
// A group (a warp or a CTA) walks a row's products in chunks of its size of A
// entries: each member loads its entry's column, B range and value, a prefix
// sum over the group numbers the chunk's products, and the members take the
// products in turn, finding theirs by bisecting the prefix (so a product's
// loads are spread evenly however long B's rows are); a CTA of a cluster
// takes only the products of its share.  Tables use linear probing from a
// multiplicative hash, keys claimed with atomicCAS; values fold with
// atomicAdd (f32 and i32 PLUS), atomicMin / atomicMax (i32), and a CAS loop
// for f32 MIN / MAX (NaN propagates, as in torch.minimum), in shared memory
// or a cluster neighbour's.  f32 PLUS sums in the order the atomics land:
// not bitwise equal to the plain version; everything else is.
//
// Coverage: semiring.cuh's generic family, whose mul is a kernel argument,
// in f32 and i32 x add in {PLUS, MIN, MAX} (kernels/spgemm.py sends it
// every f32 mul, spla_tpu's Pallas ESC gate, spla_tpu/ops/spgemm.py:229,
// and PLUS, MULT, FIRST, SECOND, MIN, MAX in i32), each with a small, a
// medium and a large instance; the symbolic and compaction kernels read no
// values (one instance each).  A templated instance per mul was no faster
// (PERF.md).

#include <cooperative_groups.h>
#include <cstring>
#include <type_traits>

#include "semiring.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSmallMax = 512;        // kept equal to kernels/spgemm.py SMALL_MAX
constexpr int kMediumMax = 8192;      // kept equal to kernels/spgemm.py MEDIUM_MAX
constexpr int kSmallSlots = 2 * kSmallMax;
constexpr int kSmallWarps = 4;        // small rows a CTA
constexpr int kSymbolicMediumThreads = 256;
constexpr int kMediumThreads = 512;   // numeric medium: 512 measured faster than 256 on the skewed graph
constexpr int kMediumLog2Min = 11;    // medium tables: 2^11 slots (> 2 x kSmallMax) ...
constexpr int kMediumClasses = 4;     // ... to 2^14 (2 x kMediumMax), one launch a size
constexpr int kStage = 8;             // table slots, or radix items, a thread holds in one step
constexpr int kRadixBins = 256;       // 8-bit digits ...
constexpr int kRadixMaxPasses = 4;    // ... of a column below 2^31
constexpr int kLargeThreads = 512;
constexpr int kMaxCluster = 16;       // kept equal to kernels/spgemm.py's largest CLUSTER
constexpr int32_t kEmpty = -1;        // a free table slot
constexpr unsigned kMaxCtas = 132 * 16;  // CTAs of a grid-stride loop over rows
static_assert(2 * kMediumMax == 1 << (kMediumLog2Min + kMediumClasses - 1), "the largest table holds 2 x kMediumMax");
static_assert(kMediumMax < 65536, "a medium row's places fit the radix sort's 16-bit counters");

struct Operands {
  const int32_t *a_indptr, *a_cols;
  const void* a_vals;
  const int32_t *b_indptr, *b_cols;
  const void* b_vals;
  int mul;  // a KernelCode
};

struct Bins {
  const int32_t* rows;            // small rows, then medium rows by table size, then large
  long long nsmall, nlarge;
  long long nmedium[kMediumClasses];  // medium rows of tables of 2^(kMediumLog2Min + c) slots
  const long long* row_products;  // [m]
  int cluster;                    // numeric only: CTAs of a large row's cluster
  int large_log2w;                // numeric only: log2 of the columns each of them holds (W)
  int radix_passes;               // numeric only: 8-bit digits of a column (n - 1), at least 1
};

// What the numeric phase writes.
template <typename T>
struct Out {
  const long long* sym;  // [m + 1] C's layout
  const T* init;         // on the device, or null: then init_value
  T init_value;
  int32_t* cols;
  T* vals;
  int32_t* rows;
  int32_t* kept;         // [m]

  __device__ T init_of() const { return init != nullptr ? *init : init_value; }
};

__host__ __device__ __forceinline__ long long medium_rows(const Bins& b) {
  long long total = 0;
  for (int c = 0; c < kMediumClasses; ++c) total += b.nmedium[c];
  return total;
}

__device__ __forceinline__ int log2_ceil(long long x) {
  return x <= 1 ? 0 : 64 - __clzll(x - 1);
}

// log2 of a row's table: the least power of two >= 2 x its products, in [lo, hi].
__device__ __forceinline__ int table_log2(long long products, int lo, int hi) {
  return min(max(log2_ceil(2 * products), lo), hi);
}

// ------------------------------------------------------------------ groups

// A warp walking one row.
struct WarpGroup {
  static constexpr int kSize = 32;
  int rank;
  __device__ void sync() const { __syncwarp(); }
  // The exclusive prefix of v over the group; total gets the sum.
  template <typename I>
  __device__ I scan(I v, I& total) const {
    I x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const I y = __shfl_up_sync(kFullMask, x, o);
      if (rank >= o) x += y;
    }
    total = __shfl_sync(kFullMask, x, 31);
    return x - v;
  }
};

// A CTA of THREADS walking one row; scratch is 32 words of shared memory.
template <int THREADS>
struct BlockGroup {
  static constexpr int kSize = THREADS;
  int rank;
  long long* scratch;
  __device__ void sync() const { __syncthreads(); }
  template <typename I>
  __device__ I scan(I v, I& total) const {
    constexpr int warps = THREADS / 32;
    const int lane = rank & 31, warp = rank >> 5;
    I x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const I y = __shfl_up_sync(kFullMask, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) scratch[warp] = x;
    __syncthreads();
    if (warp == 0) {
      long long w = lane < warps ? scratch[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(kFullMask, w, o);
        if (lane >= o) w += y;
      }
      if (lane < warps) scratch[lane] = w;
    }
    __syncthreads();
    const I before = warp > 0 ? static_cast<I>(scratch[warp - 1]) : I(0);
    total = static_cast<I>(scratch[warps - 1]);
    __syncthreads();  // scratch is read before the next scan writes it
    return before + x - v;
  }
};

// ------------------------------------------------------------------ the walk

// A chunk of a group's A entries: the exclusive prefix of their products,
// where each one's B row starts, and its value.
template <int G, typename T, typename Off>
struct Chunk {
  Off off[G];
  int32_t b0[G];
  T av[G];
};

// The largest value of an offset type.
template <typename Off>
__host__ __device__ constexpr Off max_of() {
  return static_cast<Off>((1ULL << (8 * sizeof(Off) - 1)) - 1);
}

// Calls fn(j, product) for the products [lo, hi) of row `row`, in expansion
// order (mul(A[row, p], B[p, j]) when VALUES, else a 0): A's entries in
// chunks of the group's size, the chunk's products spread over the members
// in order.  Chunks past hi are not read.
template <typename Grp, typename T, int MUL, bool VALUES, typename Off, typename Fn>
__device__ __forceinline__ void walk_row(const Grp& g, const Operands& o, int32_t row,
                                         Chunk<Grp::kSize, T, Off>& ch, Fn&& fn, Off lo = 0,
                                         Off hi = max_of<Off>()) {
  constexpr int G = Grp::kSize;
  const T* __restrict__ a_vals = static_cast<const T*>(o.a_vals);
  const T* __restrict__ b_vals = static_cast<const T*>(o.b_vals);
  const int32_t a0 = __ldg(o.a_indptr + row), a1 = __ldg(o.a_indptr + row + 1);
  Off before = 0;  // the row's products before this chunk (the same in every member)
  for (int32_t c = a0; c < a1 && before < hi; c += G) {
    const int32_t p = c + g.rank;
    Off deg = 0;
    if (p < a1) {
      const int32_t k = __ldg(o.a_cols + p);
      const int32_t b0 = __ldg(o.b_indptr + k);
      deg = __ldg(o.b_indptr + k + 1) - b0;
      ch.b0[g.rank] = b0;
      if constexpr (VALUES) ch.av[g.rank] = __ldg(a_vals + p);
    }
    Off total;
    ch.off[g.rank] = g.scan(deg, total);
    g.sync();
    const int nent = min(G, a1 - c);
    const Off q0 = lo > before ? lo - before : Off(0);
    const Off q1 = hi - before < total ? hi - before : total;
    for (Off q = q0 + g.rank; q < q1; q += G) {
      int r = 0;  // the last entry whose products start at or before q
#pragma unroll
      for (int step = G >> 1; step > 0; step >>= 1) {
        if (r + step < nent && ch.off[r + step] <= q) r += step;
      }
      const int32_t t = ch.b0[r] + static_cast<int32_t>(q - ch.off[r]);
      const int32_t j = __ldg(o.b_cols + t);
      T prod = T(0);
      if constexpr (VALUES) prod = apply_mul<MUL>(ch.av[r], __ldg(b_vals + t), o.mul, false);
      fn(j, prod);
    }
    before += total;
    g.sync();  // the chunk is read before the next one is staged
  }
}

// ------------------------------------------------------------------ tables

__device__ __forceinline__ uint32_t hash_slot(int32_t j, int log2t) {
  return (static_cast<uint32_t>(j) * 0x9E3779B1u) >> (32 - log2t);
}

// The slot of column j in keys[0, 2^log2t), claimed if j is not there yet;
// `fresh` says whether this call claimed it.  The table never fills: it has
// at least twice the row's products.
__device__ __forceinline__ uint32_t claim(int32_t* keys, int log2t, int32_t j, bool& fresh) {
  const uint32_t mask = (1u << log2t) - 1u;
  for (uint32_t h = hash_slot(j, log2t);; h = (h + 1u) & mask) {
    const int32_t k = keys[h];
    if (k == j) {
      fresh = false;
      return h;
    }
    if (k == kEmpty) {
      const int32_t old = atomicCAS(keys + h, kEmpty, j);
      if (old == kEmpty || old == j) {
        fresh = old == kEmpty;
        return h;
      }
    }
  }
}

// *addr = op(*addr, v) for f32 MIN / MAX by a CAS loop (NaN propagates, as
// in op_min / op_max); a value already in place is not written.
template <int ADD>
__device__ __forceinline__ void cas_fold(float* addr, float v) {
  unsigned* a = reinterpret_cast<unsigned*>(addr);
  unsigned old = *a, seen;
  do {
    seen = old;
    const unsigned want = __float_as_uint(apply_op<ADD>(__uint_as_float(seen), v));
    if (want == seen) break;
    old = atomicCAS(a, seen, want);
  } while (old != seen);
}

// *addr = op_add(*addr, v), atomically (shared memory: this CTA's or a cluster neighbour's).
template <int ADD, typename T>
__device__ __forceinline__ void atomic_fold(T* addr, T v) {
  if constexpr (ADD == KC_PLUS) {
    atomicAdd(addr, v);  // i32 wraps, as op_plus does
  } else if constexpr (std::is_same_v<T, int32_t>) {
    if constexpr (ADD == KC_MIN) atomicMin(addr, v);
    else atomicMax(addr, v);
  } else {
    cas_fold<ADD>(addr, v);
  }
}

// ------------------------------------------------------------------ a row in a table

// The symbolic phase of one row in a table of 2^log2t keys: its distinct columns.
template <typename Grp>
__device__ int32_t count_row(const Grp& g, const Operands& o, int32_t row, int32_t* keys, int log2t,
                             Chunk<Grp::kSize, int32_t, int32_t>& ch) {
  for (int32_t s = g.rank; s < (1 << log2t); s += Grp::kSize) keys[s] = kEmpty;
  g.sync();
  int32_t mine = 0;
  walk_row<Grp, int32_t, KC_PLUS, false, int32_t>(g, o, row, ch, [&](int32_t j, int32_t) {
    bool fresh;
    claim(keys, log2t, j, fresh);
    mine += fresh;
  });
  int32_t total;
  g.scan(mine, total);
  g.sync();
  return total;
}

// A lane's U entries of a small row (lane, lane + 32, ... below count; the
// others' keys INT32_MAX), each written at its rank among the row's count
// kept columns: the number below it, counted against every kept column,
// four a shared-memory read (keys padded with INT32_MAX to a multiple of 4).
template <int U, typename T>
__device__ __forceinline__ void write_ranked(int lane, const Out<T>& out, int32_t row, const int32_t* keys,
                                             const T* vals, int32_t count) {
  int32_t own[U], rank[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int32_t s = lane + 32 * u;
    own[u] = s < count ? keys[s] : INT32_MAX;
    rank[u] = 0;
  }
  const int4* k4 = reinterpret_cast<const int4*>(keys);
  for (int32_t c = 0; c < (count + 3) / 4; ++c) {
    const int4 q = k4[c];
#pragma unroll
    for (int u = 0; u < U; ++u) rank[u] += (q.x < own[u]) + (q.y < own[u]) + (q.z < own[u]) + (q.w < own[u]);
  }
  const long long base = out.sym[row];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int32_t s = lane + 32 * u;
    if (s < count) {
      out.cols[base + rank[u]] = own[u];
      out.vals[base + rank[u]] = vals[s];
      out.rows[base + rank[u]] = row;
    }
  }
}

// A small row's table (a warp, 2^log2t slots) to C: the kept entries (init
// (+) value != init) to the front with a ballot, in slot order, then each
// lane's written at its rank (no sort: a row holds at most kSmallMax).
// Returns the kept count.
template <int ADD, typename T>
__device__ int32_t emit_ranked(const WarpGroup& g, const Out<T>& out, int32_t row, int32_t* keys, T* vals,
                               int32_t slots) {
  const T init_v = out.init_of();
  const unsigned below = (1u << g.rank) - 1u;
  int32_t count = 0;
  for (int32_t c = 0; c < slots; c += 32) {  // a slot moves to no later place
    const int32_t s = c + g.rank;
    const int32_t k = keys[s];
    T fv = init_v;
    bool keep = false;
    if (k != kEmpty) {
      fv = apply_op<ADD>(init_v, vals[s]);
      keep = fv != init_v;
    }
    const unsigned ballot = __ballot_sync(kFullMask, keep);
    if (keep) {
      keys[count + __popc(ballot & below)] = k;
      vals[count + __popc(ballot & below)] = fv;
    }
    count += __popc(ballot);
    __syncwarp();
  }
  for (int32_t s = count + g.rank; s < ((count + 3) & ~3); s += 32) keys[s] = INT32_MAX;
  __syncwarp();
  switch ((count + 127) / 128) {  // each lane's entries, at most 4, 8, 12 or 16
    case 0: break;
    case 1: write_ranked<4>(g.rank, out, row, keys, vals, count); break;
    case 2: write_ranked<8>(g.rank, out, row, keys, vals, count); break;
    case 3: write_ranked<12>(g.rank, out, row, keys, vals, count); break;
    default: write_ranked<16>(g.rank, out, row, keys, vals, count); break;
  }
  return count;
}

// A row's products folded into a table of 2^log2t (key, value) slots.
template <typename Grp, typename T, int MUL, int ADD>
__device__ void fold_table(const Grp& g, const Operands& o, int32_t row, int32_t* keys, T* vals, int log2t,
                           Chunk<Grp::kSize, T, int32_t>& ch) {
  const int32_t slots = 1 << log2t;
  for (int32_t s = g.rank; s < slots; s += Grp::kSize) {
    keys[s] = kEmpty;
    vals[s] = monoid_identity<ADD, T>();
  }
  g.sync();
  walk_row<Grp, T, MUL, true, int32_t>(g, o, row, ch, [&](int32_t j, T prod) {
    bool fresh;
    atomic_fold<ADD>(vals + claim(keys, log2t, j, fresh), prod);
  });
  g.sync();
}

// ------------------------------------------------------------------ the medium bin's sort

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

__device__ __forceinline__ int digit_of(int32_t key, int pass) { return (key >> (8 * pass)) & (kRadixBins - 1); }

// A medium row's table, slots [0, slots), to its kept entries in [0, count)
// (init (+) value, for the entries where that is not init), in no order: a
// warp reserves its kept slots' places with one shared atomicAdd.  Each
// step reads kStage slots a thread, then writes below what the steps so far
// have read.  Counts each pass's digits of the kept keys into hist.
template <int ADD, typename T>
__device__ int32_t keep_table(int32_t* keys, T* vals, int32_t slots, T init_v, int passes,
                              int32_t (&hist)[kRadixMaxPasses][kRadixBins], int32_t& counter) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) counter = 0;
  for (int x = tid; x < passes * kRadixBins; x += kMediumThreads) hist[x / kRadixBins][x % kRadixBins] = 0;
  for (int32_t s0 = 0; s0 < slots; s0 += kMediumThreads * kStage) {
    int32_t k[kStage];
    T v[kStage];
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int32_t s = s0 + i * kMediumThreads + tid;
      k[i] = s < slots ? keys[s] : kEmpty;
      v[i] = s < slots ? vals[s] : init_v;
    }
    __syncthreads();  // this step's slots are read (and, the first time, counter is 0) before any is written
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const T fv = apply_op<ADD>(init_v, v[i]);
      const bool keep = k[i] != kEmpty && fv != init_v;
      const unsigned ballot = __ballot_sync(kFullMask, keep);
      if (ballot == 0u) continue;
      const int lead = __ffs(ballot) - 1;
      int32_t at = 0;
      if (lane == lead) at = atomicAdd(&counter, __popc(ballot));
      at = __shfl_sync(kFullMask, at, lead);
      if (keep) {
        const int32_t q = at + __popc(ballot & lanes_below(lane));
        keys[q] = k[i];
        vals[q] = fv;
        for (int p = 0; p < passes; ++p) {
          const int d = digit_of(k[i], p);
          const unsigned peers = __match_any_sync(ballot, d);
          if (lane == __ffs(peers) - 1) atomicAdd(&hist[p][d], __popc(peers));
        }
      }
    }
  }
  __syncthreads();
  return counter;
}

// One stable pass of the radix sort on digit `pass`: the count entries of
// (src_k, src_v) to (dst_k, dst_v), or, when to_c, to C at base + rank.
// hist[pass] holds the digits' counts.  Tiles of kMediumThreads x kStage entries,
// warp w's entries w x 32 kStage on: a warp ranks kStage rounds of 32 in
// order (peers by __match_any_sync, running counts in wcnt[w]); the digit's
// prefix over the warps and over the tiles before places them.
template <typename T>
__device__ void radix_pass(const BlockGroup<kMediumThreads>& g, const int32_t* src_k, const T* src_v, int32_t* dst_k,
                           T* dst_v, int32_t count, int pass, int32_t (&hist)[kRadixMaxPasses][kRadixBins],
                           uint16_t (&wcnt)[kMediumThreads / 32][kRadixBins], bool to_c, const Out<T>& out,
                           int32_t row) {
  static_assert(kMediumThreads >= kRadixBins, "a thread a digit");
  constexpr int kWarps = kMediumThreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int32_t total;
  const int32_t start = g.scan(tid < kRadixBins ? hist[pass][tid] : 0, total);
  if (tid < kRadixBins) hist[pass][tid] = start;  // from here on: where the digit's next entry goes
  __syncthreads();
  const long long base = to_c ? out.sym[row] : 0;
  for (int32_t t0 = 0; t0 < count; t0 += kMediumThreads * kStage) {
    const int32_t first = t0 + warp * 32 * kStage + lane;
    int32_t k[kStage];
    T v[kStage];
    int rank[kStage];
#pragma unroll
    for (int r = 0; r < kStage; ++r) {
      const int32_t i = first + 32 * r;
      const bool valid = i < count;
      k[r] = valid ? src_k[i] : 0;
      v[r] = valid ? src_v[i] : T(0);
      const unsigned active = __ballot_sync(kFullMask, valid);
      if (valid) {
        const int d = digit_of(k[r], pass);
        const unsigned peers = __match_any_sync(active, d);
        const int lead = __ffs(peers) - 1;
        int c = 0;
        if (lane == lead) {
          c = wcnt[warp][d];
          wcnt[warp][d] = static_cast<uint16_t>(c + __popc(peers));
        }
        rank[r] = __shfl_sync(peers, c, lead) + __popc(peers & lanes_below(lane));
      }
      __syncwarp();
    }
    __syncthreads();  // every warp has counted the tile
    if (tid < kRadixBins) {  // digit tid: each warp's first place, after the tiles and warps before
      int32_t at = hist[pass][tid];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int32_t c = wcnt[w][tid];
        wcnt[w][tid] = static_cast<uint16_t>(at);  // a place in the row: below kMediumMax
        at += c;
      }
      hist[pass][tid] = at;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kStage; ++r) {
      if (first + 32 * r < count) {
        const int32_t q = wcnt[warp][digit_of(k[r], pass)] + rank[r];
        if (to_c) {
          out.cols[base + q] = k[r];
          out.vals[base + q] = v[r];
          out.rows[base + q] = row;
        } else {
          dst_k[q] = k[r];
          dst_v[q] = v[r];
        }
      }
    }
    __syncwarp();
    for (int d = lane; d < kRadixBins; d += 32) wcnt[warp][d] = 0;  // only this warp reads its row
    __syncwarp();
  }
  __syncthreads();  // the pass is written before the next one reads it
}

// ------------------------------------------------------------------ kernels

// Small rows: a warp each.
__global__ void __launch_bounds__(kSmallWarps * 32)
symbolic_small(Operands o, Bins b, int32_t* row_nnz) {
  __shared__ int32_t keys[kSmallWarps][kSmallSlots];
  __shared__ Chunk<32, int32_t, int32_t> chunks[kSmallWarps];
  const int warp = threadIdx.x >> 5;
  const WarpGroup g{static_cast<int>(threadIdx.x & 31)};
  for (long long w = static_cast<long long>(blockIdx.x) * kSmallWarps + warp; w < b.nsmall;
       w += static_cast<long long>(gridDim.x) * kSmallWarps) {
    const int32_t row = b.rows[w];
    const long long products = b.row_products[row];
    int32_t nnz = 0;
    if (products > 0) {
      nnz = count_row(g, o, row, keys[warp], table_log2(products, 5, log2_ceil(kSmallSlots)), chunks[warp]);
    }
    if (g.rank == 0) row_nnz[row] = nnz;
  }
}

template <typename T, int MUL, int ADD>
__global__ void __launch_bounds__(kSmallWarps * 32)
numeric_small(Operands o, Bins b, Out<T> out) {
  __shared__ __align__(16) int32_t keys[kSmallWarps][kSmallSlots];
  __shared__ T vals[kSmallWarps][kSmallSlots];
  __shared__ Chunk<32, T, int32_t> chunks[kSmallWarps];
  const int warp = threadIdx.x >> 5;
  const WarpGroup g{static_cast<int>(threadIdx.x & 31)};
  for (long long w = static_cast<long long>(blockIdx.x) * kSmallWarps + warp; w < b.nsmall;
       w += static_cast<long long>(gridDim.x) * kSmallWarps) {
    const int32_t row = b.rows[w];
    const long long products = b.row_products[row];
    if (products > 0) {
      const int log2t = table_log2(products, 5, log2_ceil(kSmallSlots));
      fold_table<WarpGroup, T, MUL, ADD>(g, o, row, keys[warp], vals[warp], log2t, chunks[warp]);
      const int32_t kept = emit_ranked<ADD>(g, out, row, keys[warp], vals[warp], 1 << log2t);
      if (g.rank == 0) out.kept[row] = kept;
      __syncwarp();  // the table is read before the next row clears it
    } else if (g.rank == 0) {
      out.kept[row] = 0;
    }
  }
}

// Medium rows of one table size, rows[first, first + count): a CTA each,
// the table of 2^log2t slots in dynamic shared memory (its keys, then as
// many values in the numeric phase), so rows of small tables share an SM.
__global__ void __launch_bounds__(kSymbolicMediumThreads)
symbolic_medium(Operands o, Bins b, long long first, long long count, int log2t, int32_t* row_nnz) {
  extern __shared__ int4 dyn[];
  __shared__ long long scratch[32];
  __shared__ Chunk<kSymbolicMediumThreads, int32_t, int32_t> chunk;
  int32_t* keys = reinterpret_cast<int32_t*>(dyn);
  const BlockGroup<kSymbolicMediumThreads> g{static_cast<int>(threadIdx.x), scratch};
  for (long long w = blockIdx.x; w < count; w += gridDim.x) {
    const int32_t row = b.rows[first + w];
    const int32_t nnz = count_row(g, o, row, keys, log2t, chunk);
    if (g.rank == 0) row_nnz[row] = nnz;
  }
}

// The numeric phase of a medium row: the table folded, its kept entries to
// its front (in no order), then radix-sorted by column between the table's
// two halves (the kept entries are at most half its slots), the last pass
// into C.
template <typename T, int MUL, int ADD>
__global__ void __launch_bounds__(kMediumThreads)
numeric_medium(Operands o, Bins b, long long first, long long count, int log2t, Out<T> out) {
  extern __shared__ int4 dyn[];
  __shared__ long long scratch[32];
  __shared__ Chunk<kMediumThreads, T, int32_t> chunk;
  __shared__ int32_t hist[kRadixMaxPasses][kRadixBins];
  __shared__ uint16_t wcnt[kMediumThreads / 32][kRadixBins];
  __shared__ int32_t counter;
  const int32_t slots = 1 << log2t, half = slots >> 1;
  int32_t* keys = reinterpret_cast<int32_t*>(dyn);
  T* vals = reinterpret_cast<T*>(keys + slots);
  const BlockGroup<kMediumThreads> g{static_cast<int>(threadIdx.x), scratch};
  for (int x = threadIdx.x; x < (kMediumThreads / 32) * kRadixBins; x += kMediumThreads) {
    wcnt[x / kRadixBins][x % kRadixBins] = 0;
  }
  const T init_v = out.init_of();
  const int passes = b.radix_passes;
  for (long long w = blockIdx.x; w < count; w += gridDim.x) {
    const int32_t row = b.rows[first + w];
    fold_table<BlockGroup<kMediumThreads>, T, MUL, ADD>(g, o, row, keys, vals, log2t, chunk);
    const int32_t kept = keep_table<ADD>(keys, vals, slots, init_v, passes, hist, counter);
    for (int p = 0; p < passes; ++p) {  // the front half to the back one and back, the last pass to C
      const int32_t off_src = (p & 1) ? half : 0, off_dst = (p & 1) ? 0 : half;
      radix_pass<T>(g, keys + off_src, vals + off_src, keys + off_dst, vals + off_dst, kept, p, hist, wcnt,
                             p == passes - 1, out, row);
    }
    if (g.rank == 0) out.kept[row] = kept;
  }
}

// Calls launch(first, count, log2t, shared bytes) for each medium table size
// with rows, bytes_per_slot bytes a slot; the first error, or cudaSuccess.
template <typename Kernel, typename Launch>
cudaError_t for_each_medium(const Bins& b, Kernel kernel, size_t bytes_per_slot, Launch&& launch) {
  long long first = b.nsmall;
  for (int c = 0; c < kMediumClasses; ++c) {
    const long long count = b.nmedium[c];
    if (count == 0) continue;
    const int log2t = kMediumLog2Min + c;
    const size_t smem = (static_cast<size_t>(1) << log2t) * bytes_per_slot;
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    launch(first, count, log2t, smem);
    first += count;
  }
  return cudaSuccess;
}

// Large rows, symbolic phase: CTA s walks rows s, s + gridDim.x, ... with an
// occupancy bitmap of a window of large_words x 32 columns in shared memory,
// the columns in windows when n is wider (the row walked once a window).
__global__ void __launch_bounds__(kLargeThreads)
symbolic_large(Operands o, Bins b, long long n, int large_words, int32_t* row_nnz) {
  extern __shared__ int4 dyn[];
  __shared__ long long scratch[32];
  __shared__ Chunk<kLargeThreads, int32_t, long long> chunk;
  uint32_t* bits = reinterpret_cast<uint32_t*>(dyn);
  const BlockGroup<kLargeThreads> g{static_cast<int>(threadIdx.x), scratch};
  const long long window = 32LL * large_words;
  for (long long w = blockIdx.x; w < b.nlarge; w += gridDim.x) {
    const int32_t row = b.rows[b.nsmall + medium_rows(b) + w];
    long long nnz = 0;
    for (long long c0 = 0; c0 < n; c0 += window) {
      const long long words = min(static_cast<long long>(large_words), (n - c0 + 31) / 32);
      for (long long x = g.rank; x < words; x += kLargeThreads) bits[x] = 0u;
      __syncthreads();
      walk_row<BlockGroup<kLargeThreads>, int32_t, KC_PLUS, false, long long>(
          g, o, row, chunk, [&](int32_t j, int32_t) {
            const long long d = j - c0;
            if (d >= 0 && d < window) atomicOr(bits + (d >> 5), 1u << (d & 31));
          });
      __syncthreads();
      long long mine = 0;
      for (long long x = g.rank; x < words; x += kLargeThreads) mine += __popc(bits[x]);
      long long total;
      g.scan(mine, total);
      nnz += total;
    }
    if (g.rank == 0) row_nnz[row] = static_cast<int32_t>(nnz);
  }
}

// Large rows, numeric phase: cluster k of the grid walks rows k, k +
// clusters, ...; its CTA r takes products [r P / C, (r + 1) P / C) of a row
// of P and holds columns [c0 + r W, c0 + (r + 1) W) of each window of C x W
// columns, their values op_add's identity between windows, and, after them,
// a bitmap of the same columns, used only when init is NaN.  A product folds
// into its owner's value in distributed shared memory.  Three cluster
// barriers a window: the folds have landed; each CTA's count of kept
// columns is published; the counts are read and the columns written and
// reset before the next window's folds.
template <typename T, int MUL, int ADD>
__global__ void __launch_bounds__(kLargeThreads)
numeric_large(Operands o, Bins b, long long n, Out<T> out) {
  extern __shared__ int4 dyn[];
  __shared__ long long scratch[32];
  __shared__ Chunk<kLargeThreads, T, long long> chunk;
  __shared__ int32_t warp_kept[kLargeThreads / 32];
  __shared__ long long published;  // this CTA's kept columns in the window; the cluster reads it
  __shared__ long long cta_base;   // where in the row this CTA's first kept column goes
  __shared__ long long window_kept;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int log2w = b.large_log2w;
  const long long W = 1LL << log2w, span = W * C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kLargeThreads / 32;
  T* acc = reinterpret_cast<T*>(dyn);
  uint32_t* bits = reinterpret_cast<uint32_t*>(acc + W);
  const BlockGroup<kLargeThreads> g{tid, scratch};
  const T identity = monoid_identity<ADD, T>(), init_v = out.init_of();
  // NaN (+) identity is NaN, and NaN != NaN: an untouched column would be kept, so mark the touched ones
  const bool marks = init_v != init_v;
  const long long words = W >> 5, per_warp = (words + kWarps - 1) / kWarps;  // 32 columns a word
  for (long long x = tid; x < W; x += kLargeThreads) acc[x] = identity;
  for (long long x = tid; x < words; x += kLargeThreads) bits[x] = 0u;
  cluster.sync();  // every CTA of the cluster has started and cleared before any remote fold
  const long long clusters = gridDim.x / C;
  for (long long w = blockIdx.x / C; w < b.nlarge; w += clusters) {
    const int32_t row = b.rows[b.nsmall + medium_rows(b) + w];
    const long long products = b.row_products[row];
    const long long lo = products * rank / C, hi = products * (rank + 1) / C;
    const long long row_base = out.sym[row];
    long long kept = 0;
    for (long long c0 = 0; c0 < n; c0 += span) {
      walk_row<BlockGroup<kLargeThreads>, T, MUL, true, long long>(
          g, o, row, chunk,
          [&](int32_t j, T prod) {
            const long long d = j - c0;
            if (d >= 0 && d < span) {
              const unsigned owner = static_cast<unsigned>(d >> log2w);
              const long long at = d & (W - 1);
              atomic_fold<ADD>(cluster.map_shared_rank(acc, owner) + at, prod);
              if (marks) atomicOr(cluster.map_shared_rank(bits, owner) + (at >> 5), 1u << (at & 31));
            }
          },
          lo, hi);
      cluster.sync();  // every fold of the window has landed
      // this CTA's columns [mine0, mine0 + W), those below n; warp v takes words [v per_warp, ...)
      const long long mine0 = c0 + rank * W;
      const long long x0 = min(words, warp * per_warp), x1 = min(words, x0 + per_warp);
      int32_t count = 0;
      for (long long x = x0; x < x1; ++x) {
        const long long col = mine0 + 32 * x + lane;
        const bool keep = col < n && (!marks || (bits[x] >> lane & 1u)) &&
                          apply_op<ADD>(init_v, acc[32 * x + lane]) != init_v;
        count += __popc(__ballot_sync(kFullMask, keep));
      }
      if (lane == 0) warp_kept[warp] = count;
      __syncthreads();
      if (warp == 0) {  // each warp's first place among the CTA's kept columns, and their count
        const int32_t own = lane < kWarps ? warp_kept[lane] : 0;
        int32_t v = own;
#pragma unroll
        for (int o2 = 1; o2 < 32; o2 <<= 1) {
          const int32_t y = __shfl_up_sync(kFullMask, v, o2);
          if (lane >= o2) v += y;
        }
        if (lane < kWarps) warp_kept[lane] = v - own;
        if (lane == kWarps - 1) published = v;
      }
      cluster.sync();  // every CTA's count is published
      if (warp == 0) {  // the counts' prefix over the ranks places this CTA's columns
        long long v = lane < C ? *cluster.map_shared_rank(&published, static_cast<unsigned>(lane)) : 0;
        const long long mine = v;
#pragma unroll
        for (int o2 = 1; o2 < 32; o2 <<= 1) {
          const long long y = __shfl_up_sync(kFullMask, v, o2);
          if (lane >= o2) v += y;
        }
        if (lane == rank) cta_base = row_base + kept + v - mine;
        if (lane == C - 1) window_kept = v;
      }
      __syncthreads();
      long long q = cta_base + warp_kept[warp];
      for (long long x = x0; x < x1; ++x) {
        const long long col = mine0 + 32 * x + lane;
        const T v = acc[32 * x + lane];
        const T fv = apply_op<ADD>(init_v, v);
        const bool keep = col < n && (!marks || (bits[x] >> lane & 1u)) && fv != init_v;
        const unsigned ballot = __ballot_sync(kFullMask, keep);  // every lane has read bits[x]
        if (keep) {
          const long long at = q + __popc(ballot & lanes_below(lane));
          out.cols[at] = static_cast<int32_t>(col);
          out.vals[at] = fv;
          out.rows[at] = row;
        }
        acc[32 * x + lane] = identity;
        if (marks && lane == 0) bits[x] = 0u;
        q += __popc(ballot);
      }
      kept += window_kept;
      cluster.sync();  // the counts are read and the window's columns reset before the next folds
    }
    if (rank == 0 && tid == 0) out.kept[row] = static_cast<int32_t>(kept);
  }
}

// The compaction: rows whose place moved (ptr[row] < sym[row]) are copied out
// to tmp at their old place, then back at ptr[row]; then the padding.
__global__ void compact_out(long long m, const long long* sym, const long long* ptr, const int32_t* kept,
                            const int32_t* cols, const uint32_t* vals, int32_t* tmp_cols, uint32_t* tmp_vals) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x / 32);
  for (long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32; i < m; i += warps) {
    const long long s = sym[i];
    if (ptr[i] == s) continue;
    for (int32_t r = lane; r < kept[i]; r += 32) {
      tmp_cols[s + r] = cols[s + r];
      tmp_vals[s + r] = vals[s + r];
    }
  }
}

__global__ void compact_back(long long m, long long size, const long long* sym, const long long* ptr,
                             const int32_t* kept, const int32_t* tmp_cols, const uint32_t* tmp_vals, int32_t* cols,
                             uint32_t* vals, int32_t* rows, const uint32_t* init, uint32_t init_bits) {
  const int lane = threadIdx.x & 31;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = tid / 32; i < m; i += threads / 32) {
    const long long s = sym[i], d = ptr[i];
    if (d == s) continue;
    for (int32_t r = lane; r < kept[i]; r += 32) {
      cols[d + r] = tmp_cols[s + r];
      vals[d + r] = tmp_vals[s + r];
      rows[d + r] = static_cast<int32_t>(i);
    }
  }
  const uint32_t fill = init != nullptr ? *init : init_bits;
  for (long long q = ptr[m] + tid; q < size; q += threads) {
    cols[q] = 0;
    vals[q] = fill;
    rows[q] = static_cast<int32_t>(m);
  }
}

unsigned ctas_for(long long units, long long per_cta) {
  const long long want = (units + per_cta - 1) / per_cta;
  return static_cast<unsigned>(want < 1 ? 1 : (want < kMaxCtas ? want : kMaxCtas));
}

bool bins_ok(const Bins& b, long long m) {
  bool ok = b.nsmall >= 0 && b.nlarge >= 0;
  for (int c = 0; c < kMediumClasses; ++c) ok = ok && b.nmedium[c] >= 0;
  return ok && b.nsmall + medium_rows(b) + b.nlarge == m;
}

// The numeric phase's own settings: a cluster of a power of two CTAs up to
// kMaxCluster, W from 32 columns to what a CTA's shared memory may hold
// (the launch refuses more), 1 to 4 radix passes.
bool numeric_ok(const Bins& b) {
  return b.cluster >= 1 && b.cluster <= kMaxCluster && (b.cluster & (b.cluster - 1)) == 0 && b.large_log2w >= 5 &&
         b.large_log2w <= 20 && b.radix_passes >= 1 && b.radix_passes <= kRadixMaxPasses;
}

// Launches numeric_large as a grid of clusters: as many as fit on the card
// at once (cudaOccupancyMaxActiveClusters), at most one a large row.  A
// cluster that does not fit (its shared memory, or its size) is an error.
template <typename T, int MUL, int ADD>
cudaError_t launch_large(const Operands& o, const Bins& b, long long n, const Out<T>& out, cudaStream_t stream) {
  auto kernel = numeric_large<T, MUL, ADD>;
  const size_t smem = (sizeof(T) << b.large_log2w) + ((static_cast<size_t>(1) << b.large_log2w) >> 3);  // values, bits
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess && b.cluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(b.cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(b.cluster));
  config.blockDim = dim3(kLargeThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  if (err != cudaSuccess) return err;
  if (clusters <= 0) return cudaErrorLaunchOutOfResources;  // no cluster of this shape fits on the card
  const long long grid = clusters < b.nlarge ? clusters : b.nlarge;
  config.gridDim = dim3(static_cast<unsigned>(grid * b.cluster));
  return cudaLaunchKernelEx(&config, kernel, o, b, n, out);
}

struct NumericLaunch {
  Operands o;
  Bins b;
  long long n;
  const long long* sym;
  const void* init;
  uint32_t init_bits;
  void *cols, *vals, *rows, *kept;
  cudaStream_t stream;
  cudaError_t err = cudaSuccess;

  template <typename T, int MUL, int ADD>
  void run() {
    static_assert(sizeof(T) == sizeof(init_bits), "init travels as its 32 bits");
    T init_value;
    memcpy(&init_value, &init_bits, sizeof(T));
    const Out<T> out{sym, static_cast<const T*>(init), init_value, static_cast<int32_t*>(cols),
                     static_cast<T*>(vals), static_cast<int32_t*>(rows), static_cast<int32_t*>(kept)};
    if (b.nsmall > 0) {
      numeric_small<T, MUL, ADD><<<ctas_for(b.nsmall, kSmallWarps), kSmallWarps * 32, 0, stream>>>(o, b, out);
    }
    auto medium = numeric_medium<T, MUL, ADD>;
    err = for_each_medium(b, medium, sizeof(int32_t) + sizeof(T),
                          [&](long long first, long long count, int log2t, size_t smem) {
                            medium<<<ctas_for(count, 1), kMediumThreads, smem, stream>>>(o, b, first, count, log2t,
                                                                                        out);
                          });
    if (err == cudaSuccess && b.nlarge > 0) err = launch_large<T, MUL, ADD>(o, b, n, out, stream);
  }
};

Bins make_bins(const void* rows, long long nsmall, const long long (&nmedium)[kMediumClasses], long long nlarge,
               const void* row_products, int cluster = 0, int large_log2w = 0, int radix_passes = 0) {
  return Bins{static_cast<const int32_t*>(rows), nsmall, nlarge,
              {nmedium[0], nmedium[1], nmedium[2], nmedium[3]}, static_cast<const long long*>(row_products),
              cluster, large_log2w, radix_passes};
}

}  // namespace

// The bins: rows, nsmall, the four medium counts, nlarge, row_products;
// then each phase's own settings: the symbolic phase's large_words, the
// numeric phase's cluster, log2 W and radix passes.
extern "C" int spla_mxm_symbolic(long long m, long long n, const void* a_indptr, const void* a_cols,
                                 const void* b_indptr, const void* b_cols, const void* rows, long long nsmall,
                                 long long nm0, long long nm1, long long nm2, long long nm3, long long nlarge,
                                 const void* row_products, int large_words, void* row_nnz, void* stream) {
  const Bins b = make_bins(rows, nsmall, {nm0, nm1, nm2, nm3}, nlarge, row_products);
  if (!bins_ok(b, m) || (nlarge > 0 && large_words <= 0)) return static_cast<int>(cudaErrorInvalidValue);
  const Operands o{static_cast<const int32_t*>(a_indptr), static_cast<const int32_t*>(a_cols), nullptr,
                   static_cast<const int32_t*>(b_indptr), static_cast<const int32_t*>(b_cols), nullptr, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* out = static_cast<int32_t*>(row_nnz);
  if (nsmall > 0) symbolic_small<<<ctas_for(nsmall, kSmallWarps), kSmallWarps * 32, 0, s>>>(o, b, out);
  const cudaError_t err = for_each_medium(b, symbolic_medium, sizeof(int32_t),
                                          [&](long long first, long long count, int log2t, size_t smem) {
                                            symbolic_medium<<<ctas_for(count, 1), kSymbolicMediumThreads, smem,
                                                              s>>>(o, b, first, count, log2t, out);
                                          });
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nlarge > 0) {
    const size_t smem = static_cast<size_t>(large_words) * sizeof(uint32_t);
    const cudaError_t e = cudaFuncSetAttribute(symbolic_large, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    symbolic_large<<<ctas_for(nlarge, 1), kLargeThreads, smem, s>>>(o, b, n, large_words, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spla_mxm_numeric(int mul, int add, int dtype, long long m, long long n, const void* a_indptr,
                                const void* a_cols, const void* a_vals, const void* b_indptr, const void* b_cols,
                                const void* b_vals, const void* rows, long long nsmall, long long nm0,
                                long long nm1, long long nm2, long long nm3, long long nlarge,
                                const void* row_products, int cluster, int large_log2w, int radix_passes,
                                const void* sym, const void* init, unsigned init_bits, void* out_cols,
                                void* out_vals, void* out_rows, void* kept, void* stream) {
  const Bins b = make_bins(rows, nsmall, {nm0, nm1, nm2, nm3}, nlarge, row_products, cluster, large_log2w,
                           radix_passes);
  if (!bins_ok(b, m) || !numeric_ok(b)) return static_cast<int>(cudaErrorInvalidValue);
  if (!runtime_mul_ok(mul, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const Operands o{static_cast<const int32_t*>(a_indptr), static_cast<const int32_t*>(a_cols), a_vals,
                   static_cast<const int32_t*>(b_indptr), static_cast<const int32_t*>(b_cols), b_vals, mul};
  NumericLaunch launch{o, b, n, static_cast<const long long*>(sym), init, init_bits,
                       out_cols, out_vals, out_rows, kept, static_cast<cudaStream_t>(stream)};
  if (!dispatch_generic<true, true, false, false>(add, dtype, launch)) return -1;
  const cudaError_t last = cudaGetLastError();  // read, and so cleared, on every return
  return static_cast<int>(launch.err != cudaSuccess ? launch.err : last);
}

extern "C" int spla_mxm_compact(long long m, long long size, const void* sym, const void* ptr, const void* kept,
                                void* cols, void* vals, void* rows, void* tmp_cols, void* tmp_vals, const void* init,
                                unsigned init_bits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sy = static_cast<const long long*>(sym);
  const auto* pt = static_cast<const long long*>(ptr);
  const auto* kp = static_cast<const int32_t*>(kept);
  const unsigned ctas = ctas_for(m > size ? m * 32 : size, kThreads);
  if (m > 0) {
    compact_out<<<ctas_for(m * 32, kThreads), kThreads, 0, s>>>(
        m, sy, pt, kp, static_cast<const int32_t*>(cols), static_cast<const uint32_t*>(vals),
        static_cast<int32_t*>(tmp_cols), static_cast<uint32_t*>(tmp_vals));
  }
  compact_back<<<ctas, kThreads, 0, s>>>(m, size, sy, pt, kp, static_cast<const int32_t*>(tmp_cols),
                                         static_cast<const uint32_t*>(tmp_vals), static_cast<int32_t*>(cols),
                                         static_cast<uint32_t*>(vals), static_cast<int32_t*>(rows),
                                         static_cast<const uint32_t*>(init), init_bits);
  return static_cast<int>(cudaGetLastError());
}
