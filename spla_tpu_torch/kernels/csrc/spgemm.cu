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
// 32-byte sectors, mostly), and each row's table is filled, compacted and
// sorted in shared memory.  Three C calls (kernels/spgemm.py mxm):
//   * spla_mxm_symbolic: each row's distinct columns, into row_nnz; the
//     wrapper's prefix sum of them is C's layout (sym), whose total it reads;
//   * spla_mxm_numeric: each row's products folded with op_add into a table
//     of (column, value), the table compacted, sorted by column, and written
//     at sym[row] with the entries equal to init left out; kept[row] counts
//     what was written;
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
//   * medium (<= kMediumMax): a CTA a row, a table of 2^11 to 2^14 slots (the
//     least >= 2 x its products) in dynamic shared memory, a launch for each
//     size so that small tables share an SM; compacted, then a bitonic sort;
//   * large: a CTA a row with a dense accumulator of n values in device
//     memory (slot s of ws_vals for each of large_ctas CTAs in flight) and an
//     occupancy bitmap of large_words words in shared memory; where n is wider
//     than the bitmap the columns go in windows, the row walked once each.
//     The row is emitted by a walk of its bitmap, which leaves the
//     accumulator at op_add's identity for the next row.  This is the
//     reference's dense row accumulator (cpu_mxm.hpp:88-114).
// A group (a warp or a CTA) walks a row's products in chunks of its size of A
// entries: each member loads its entry's column, B range and value, a prefix
// sum over the group numbers the chunk's products, and the members take the
// products in turn, finding theirs by bisecting the prefix (so a product's
// loads are spread evenly however long B's rows are).  Tables use linear
// probing from a multiplicative hash, keys claimed with atomicCAS; values
// fold with atomicAdd (f32 and i32 PLUS), atomicMin / atomicMax (i32), and a
// CAS loop for f32 MIN / MAX (NaN propagates, as in torch.minimum).  The
// medium sort is bitonic over the compacted table, padded to a power of two.
// f32 PLUS sums in the order the atomics land: not bitwise equal to the plain
// version; everything else is.
//
// Coverage (compile time): mul in {PLUS, MULT, FIRST, SECOND, MIN, MAX} x
// add in {PLUS, MIN, MAX} x {f32, i32} (semiring.cuh's dispatch), each with a
// small, a medium and a large instance; the symbolic and compaction kernels
// read no values (one instance each).

#include <cstring>
#include <type_traits>

#include "semiring.cuh"

namespace {

constexpr int kSmallMax = 512;        // kept equal to kernels/spgemm.py SMALL_MAX
constexpr int kMediumMax = 8192;      // kept equal to kernels/spgemm.py MEDIUM_MAX
constexpr int kSmallSlots = 2 * kSmallMax;
constexpr int kSmallWarps = 4;        // small rows a CTA
constexpr int kMediumThreads = 256;
constexpr int kMediumLog2Min = 11;    // medium tables: 2^11 slots (> 2 x kSmallMax) ...
constexpr int kMediumClasses = 4;     // ... to 2^14 (2 x kMediumMax), one launch a size
constexpr int kLargeThreads = 512;
constexpr int32_t kEmpty = -1;        // a free table slot
constexpr unsigned kMaxCtas = 132 * 16;  // CTAs of a grid-stride loop over rows

struct Operands {
  const int32_t *a_indptr, *a_cols;
  const void* a_vals;
  const int32_t *b_indptr, *b_cols;
  const void* b_vals;
};

struct Bins {
  const int32_t* rows;            // small rows, then medium rows by table size, then large
  long long nsmall, nlarge;
  long long nmedium[kMediumClasses];  // medium rows of tables of 2^(kMediumLog2Min + c) slots
  const long long* row_products;  // [m]
  int large_ctas;
  int large_words;                // a large row's bitmap in shared memory: 32-bit words
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

// Calls fn(j, product) for every product of row `row` (mul(A[row, p], B[p, j])
// when VALUES, else a 0): A's entries in chunks of the group's size, the
// chunk's products spread over the members in order.
template <typename Grp, typename T, int MUL, bool VALUES, typename Off, typename Fn>
__device__ __forceinline__ void walk_row(const Grp& g, const Operands& o, int32_t row,
                                         Chunk<Grp::kSize, T, Off>& ch, Fn&& fn) {
  constexpr int G = Grp::kSize;
  const T* __restrict__ a_vals = static_cast<const T*>(o.a_vals);
  const T* __restrict__ b_vals = static_cast<const T*>(o.b_vals);
  const int32_t a0 = __ldg(o.a_indptr + row), a1 = __ldg(o.a_indptr + row + 1);
  for (int32_t c = a0; c < a1; c += G) {
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
    for (Off q = g.rank; q < total; q += G) {
      int r = 0;  // the last entry whose products start at or before q
#pragma unroll
      for (int step = G >> 1; step > 0; step >>= 1) {
        if (r + step < nent && ch.off[r + step] <= q) r += step;
      }
      const int32_t t = ch.b0[r] + static_cast<int32_t>(q - ch.off[r]);
      const int32_t j = __ldg(o.b_cols + t);
      T prod = T(0);
      if constexpr (VALUES) prod = apply_op<MUL>(ch.av[r], __ldg(b_vals + t));
      fn(j, prod);
    }
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

// *addr = op_add(*addr, v), atomically (shared or device memory).
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

// Sort keys[0, P) ascending (P a power of two), vals with them.
template <typename Grp, typename T>
__device__ void bitonic_sort(const Grp& g, int32_t* keys, T* vals, int32_t P) {
  for (int32_t k = 2; k <= P; k <<= 1) {
    for (int32_t s = k >> 1; s > 0; s >>= 1) {
      for (int32_t i = g.rank; i < P; i += Grp::kSize) {
        const int32_t l = i ^ s;
        if (l > i) {
          const int32_t ki = keys[i], kl = keys[l];
          if ((ki > kl) == ((i & k) == 0)) {
            keys[i] = kl;
            keys[l] = ki;
            const T t = vals[i];
            vals[i] = vals[l];
            vals[l] = t;
          }
        }
      }
      g.sync();
    }
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

// Write this group's slice of a row's entries, sorted, with those equal to
// init left out: entries [0, count) of keys / vals go to C at base.
template <typename Grp, int ADD, typename T>
__device__ int32_t emit_sorted(const Grp& g, const Out<T>& out, int32_t row, const int32_t* keys, const T* vals,
                               int32_t count) {
  const T init_v = out.init_of();
  const long long base = out.sym[row];
  int32_t kept = 0;
  for (int32_t c = 0; c < count; c += Grp::kSize) {
    const int32_t s = c + g.rank;
    T fv = init_v;
    bool keep = false;
    if (s < count) {
      fv = apply_op<ADD>(init_v, vals[s]);
      keep = fv != init_v;
    }
    int32_t total;
    const int32_t off = g.template scan<int32_t>(keep, total);
    if (keep) {
      const long long q = base + kept + off;
      out.cols[q] = keys[s];
      out.vals[q] = fv;
      out.rows[q] = row;
    }
    kept += total;
  }
  return kept;
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

// The numeric phase of one row in a table of 2^log2t (key, value) slots.
template <typename Grp, typename T, int MUL, int ADD>
__device__ void fold_row(const Grp& g, const Operands& o, const Out<T>& out, int32_t row, int32_t* keys, T* vals,
                         int log2t, Chunk<Grp::kSize, T, int32_t>& ch) {
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
  if constexpr (std::is_same_v<Grp, WarpGroup>) {
    const int32_t kept = emit_ranked<ADD>(g, out, row, keys, vals, slots);
    if (g.rank == 0) out.kept[row] = kept;
  } else {
    // the claimed slots to the front, in slot order: a slot moves to no later place
    int32_t count = 0;
    for (int32_t c = 0; c < slots; c += Grp::kSize) {
      const int32_t s = c + g.rank;
      const int32_t k = keys[s];
      const T v = vals[s];
      int32_t total;
      const int32_t off = g.template scan<int32_t>(k != kEmpty, total);
      g.sync();
      if (k != kEmpty) {
        keys[count + off] = k;
        vals[count + off] = v;
      }
      count += total;
      g.sync();
    }
    int32_t P = 1;
    while (P < count) P <<= 1;
    for (int32_t s = count + g.rank; s < P; s += Grp::kSize) keys[s] = INT32_MAX;
    g.sync();
    bitonic_sort(g, keys, vals, P);
    const int32_t kept = emit_sorted<Grp, ADD>(g, out, row, keys, vals, count);
    if (g.rank == 0) out.kept[row] = kept;
  }
  g.sync();  // the table is read before the next row clears it
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
      fold_row<WarpGroup, T, MUL, ADD>(g, o, out, row, keys[warp], vals[warp],
                                       table_log2(products, 5, log2_ceil(kSmallSlots)), chunks[warp]);
    } else if (g.rank == 0) {
      out.kept[row] = 0;
    }
  }
}

// Medium rows of one table size, rows[first, first + count): a CTA each,
// the table of 2^log2t slots in dynamic shared memory (its keys, then as
// many values in the numeric phase), so rows of small tables share an SM.
__global__ void __launch_bounds__(kMediumThreads)
symbolic_medium(Operands o, Bins b, long long first, long long count, int log2t, int32_t* row_nnz) {
  extern __shared__ int4 dyn[];
  __shared__ long long scratch[32];
  __shared__ Chunk<kMediumThreads, int32_t, int32_t> chunk;
  int32_t* keys = reinterpret_cast<int32_t*>(dyn);
  const BlockGroup<kMediumThreads> g{static_cast<int>(threadIdx.x), scratch};
  for (long long w = blockIdx.x; w < count; w += gridDim.x) {
    const int32_t row = b.rows[first + w];
    const int32_t nnz = count_row(g, o, row, keys, log2t, chunk);
    if (g.rank == 0) row_nnz[row] = nnz;
  }
}

template <typename T, int MUL, int ADD>
__global__ void __launch_bounds__(kMediumThreads)
numeric_medium(Operands o, Bins b, long long first, long long count, int log2t, Out<T> out) {
  extern __shared__ int4 dyn[];
  __shared__ long long scratch[32];
  __shared__ Chunk<kMediumThreads, T, int32_t> chunk;
  int32_t* keys = reinterpret_cast<int32_t*>(dyn);
  T* vals = reinterpret_cast<T*>(keys + (1 << log2t));
  const BlockGroup<kMediumThreads> g{static_cast<int>(threadIdx.x), scratch};
  for (long long w = blockIdx.x; w < count; w += gridDim.x) {
    fold_row<BlockGroup<kMediumThreads>, T, MUL, ADD>(g, o, out, b.rows[first + w], keys, vals, log2t, chunk);
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

// Large rows: CTA s walks rows s, s + large_ctas, ... with an occupancy
// bitmap of a window of large_words x 32 columns in shared memory, the
// columns in windows when n is wider (the row walked once a window); in the
// numeric phase its accumulator of n values (slot s of ws_vals) holds
// op_add's identity between rows.
__global__ void __launch_bounds__(kLargeThreads)
symbolic_large(Operands o, Bins b, long long n, int32_t* row_nnz) {
  extern __shared__ int4 dyn[];
  __shared__ long long scratch[32];
  __shared__ Chunk<kLargeThreads, int32_t, long long> chunk;
  uint32_t* bits = reinterpret_cast<uint32_t*>(dyn);
  const BlockGroup<kLargeThreads> g{static_cast<int>(threadIdx.x), scratch};
  const long long window = 32LL * b.large_words;
  for (long long w = blockIdx.x; w < b.nlarge; w += gridDim.x) {
    const int32_t row = b.rows[b.nsmall + medium_rows(b) + w];
    long long nnz = 0;
    for (long long c0 = 0; c0 < n; c0 += window) {
      const long long words = min(static_cast<long long>(b.large_words), (n - c0 + 31) / 32);
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

template <typename T, int MUL, int ADD>
__global__ void __launch_bounds__(kLargeThreads)
numeric_large(Operands o, Bins b, long long n, T* ws_vals, Out<T> out) {
  extern __shared__ int4 dyn[];
  __shared__ long long scratch[32];
  __shared__ Chunk<kLargeThreads, T, long long> chunk;
  uint32_t* bits = reinterpret_cast<uint32_t*>(dyn);
  const BlockGroup<kLargeThreads> g{static_cast<int>(threadIdx.x), scratch};
  const long long window = 32LL * b.large_words;
  T* acc = ws_vals + blockIdx.x * n;
  const T identity = monoid_identity<ADD, T>();
  for (long long x = g.rank; x < n; x += kLargeThreads) acc[x] = identity;
  const T init_v = out.init_of();
  for (long long w = blockIdx.x; w < b.nlarge; w += gridDim.x) {
    const int32_t row = b.rows[b.nsmall + medium_rows(b) + w];
    const long long base = out.sym[row];
    long long kept = 0;
    for (long long c0 = 0; c0 < n; c0 += window) {
      const long long words = min(static_cast<long long>(b.large_words), (n - c0 + 31) / 32);
      for (long long x = g.rank; x < words; x += kLargeThreads) bits[x] = 0u;
      __syncthreads();  // also orders the accumulator's reset before the walk
      walk_row<BlockGroup<kLargeThreads>, T, MUL, true, long long>(g, o, row, chunk, [&](int32_t j, T prod) {
        const long long d = j - c0;
        if (d >= 0 && d < window) {
          atomicOr(bits + (d >> 5), 1u << (d & 31));
          atomic_fold<ADD>(acc + j, prod);
        }
      });
      __syncthreads();
      // emit the window in column order, a word of the bitmap a thread, THREADS words at a time
      for (long long c = 0; c < words; c += kLargeThreads) {
        const long long x = c + g.rank;
        const uint32_t word = x < words ? bits[x] : 0u;
        const long long j0 = c0 + 32 * x;
        uint32_t keep = 0u;
        for (uint32_t rest = word; rest != 0u; rest &= rest - 1u) {
          const int bit = __ffs(rest) - 1;
          if (apply_op<ADD>(init_v, __ldcg(acc + j0 + bit)) != init_v) keep |= 1u << bit;
        }
        long long total;
        long long q = base + kept + g.template scan<long long>(__popc(keep), total);
        for (uint32_t rest = keep; rest != 0u; rest &= rest - 1u) {
          const int bit = __ffs(rest) - 1;
          out.cols[q] = static_cast<int32_t>(j0 + bit);
          out.vals[q] = apply_op<ADD>(init_v, __ldcg(acc + j0 + bit));
          out.rows[q] = row;
          ++q;
        }
        for (uint32_t rest = word; rest != 0u; rest &= rest - 1u) acc[j0 + __ffs(rest) - 1] = identity;
        kept += total;
      }
    }
    if (g.rank == 0) out.kept[row] = static_cast<int32_t>(kept);
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
  bool ok = b.nsmall >= 0 && b.nlarge >= 0 && (b.nlarge == 0 || (b.large_ctas > 0 && b.large_words > 0));
  for (int c = 0; c < kMediumClasses; ++c) ok = ok && b.nmedium[c] >= 0;
  return ok && b.nsmall + medium_rows(b) + b.nlarge == m;
}

struct NumericLaunch {
  Operands o;
  Bins b;
  long long n;
  void* ws_vals;
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
    err = for_each_medium(b, numeric_medium<T, MUL, ADD>, sizeof(int32_t) + sizeof(T),
                          [&](long long first, long long count, int log2t, size_t smem) {
                            numeric_medium<T, MUL, ADD><<<ctas_for(count, 1), kMediumThreads, smem, stream>>>(
                                o, b, first, count, log2t, out);
                          });
    if (err != cudaSuccess) return;
    if (b.nlarge > 0) {
      const size_t smem = static_cast<size_t>(b.large_words) * sizeof(uint32_t);
      err = cudaFuncSetAttribute(numeric_large<T, MUL, ADD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return;
      numeric_large<T, MUL, ADD><<<static_cast<unsigned>(b.large_ctas), kLargeThreads, smem, stream>>>(
          o, b, n, static_cast<T*>(ws_vals), out);
    }
  }
};

Bins make_bins(const void* rows, long long nsmall, const long long (&nmedium)[kMediumClasses], long long nlarge,
               const void* row_products, int large_ctas, int large_words) {
  return Bins{static_cast<const int32_t*>(rows), nsmall, nlarge,
              {nmedium[0], nmedium[1], nmedium[2], nmedium[3]}, static_cast<const long long*>(row_products),
              large_ctas, large_words};
}

}  // namespace

extern "C" int spla_mxm_symbolic(long long m, long long n, const void* a_indptr, const void* a_cols,
                                 const void* b_indptr, const void* b_cols, const void* rows, long long nsmall,
                                 long long nm0, long long nm1, long long nm2, long long nm3, long long nlarge,
                                 const void* row_products, int large_ctas, int large_words, void* row_nnz,
                                 void* stream) {
  const Bins b = make_bins(rows, nsmall, {nm0, nm1, nm2, nm3}, nlarge, row_products, large_ctas, large_words);
  if (!bins_ok(b, m)) return static_cast<int>(cudaErrorInvalidValue);
  const Operands o{static_cast<const int32_t*>(a_indptr), static_cast<const int32_t*>(a_cols), nullptr,
                   static_cast<const int32_t*>(b_indptr), static_cast<const int32_t*>(b_cols), nullptr};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* out = static_cast<int32_t*>(row_nnz);
  if (nsmall > 0) symbolic_small<<<ctas_for(nsmall, kSmallWarps), kSmallWarps * 32, 0, s>>>(o, b, out);
  const cudaError_t err = for_each_medium(b, symbolic_medium, sizeof(int32_t),
                                          [&](long long first, long long count, int log2t, size_t smem) {
                                            symbolic_medium<<<ctas_for(count, 1), kMediumThreads, smem, s>>>(
                                                o, b, first, count, log2t, out);
                                          });
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nlarge > 0) {
    const size_t smem = static_cast<size_t>(large_words) * sizeof(uint32_t);
    const cudaError_t e = cudaFuncSetAttribute(symbolic_large, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    symbolic_large<<<static_cast<unsigned>(large_ctas), kLargeThreads, smem, s>>>(o, b, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spla_mxm_numeric(int mul, int add, int dtype, long long m, long long n, const void* a_indptr,
                                const void* a_cols, const void* a_vals, const void* b_indptr, const void* b_cols,
                                const void* b_vals, const void* rows, long long nsmall, long long nm0,
                                long long nm1, long long nm2, long long nm3, long long nlarge,
                                const void* row_products, int large_ctas, int large_words, void* ws_vals,
                                const void* sym, const void* init, unsigned init_bits, void* out_cols,
                                void* out_vals, void* out_rows, void* kept, void* stream) {
  const Bins b = make_bins(rows, nsmall, {nm0, nm1, nm2, nm3}, nlarge, row_products, large_ctas, large_words);
  if (!bins_ok(b, m) || (nlarge > 0 && ws_vals == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const Operands o{static_cast<const int32_t*>(a_indptr), static_cast<const int32_t*>(a_cols), a_vals,
                   static_cast<const int32_t*>(b_indptr), static_cast<const int32_t*>(b_cols), b_vals};
  NumericLaunch launch{o, b, n, ws_vals, static_cast<const long long*>(sym), init, init_bits,
                       out_cols, out_vals, out_rows, kept, static_cast<cudaStream_t>(stream)};
  if (!dispatch<true>(mul, add, dtype, launch)) return -1;
  if (launch.err != cudaSuccess) return static_cast<int>(launch.err);
  return static_cast<int>(cudaGetLastError());
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
