// Kernel 8: phase probes of the pull SpMV (kernel 1, and kernel 7's ring and fold).
//
// Replaces tools/probe_spmv.py's Pallas probes of the fused TPU kernel
// (pallas_call :307, :385, :458, :527, :680, :738), which removed phases
// from the real kernel so that subtracting probe times attributes its cost.
// Here the probes take the grid and stream of kernel 1's first design (a
// warp per row, 8 rows a CTA, lanes striding the row; `warp_row` is that
// kernel whole) or kernel 7's ring and fold, and drop phases:
//
//   stream        indptr, cols and values read on the warp-per-row grid; per
//                 row the value sum and the XOR of the columns
//   gather        + x[cols] and the products; each thread's sum goes to
//                 shared memory and one warp folds the CTA's 256 sums, no
//                 per-row fold or store
//   fullfix       + the warp fold of each row; the 8 row sums go to shared
//                 memory and one thread adds them, no per-row store
//   alu           a dependent mul-add chain per entry slot, no loads but
//                 indptr; per row the lanes' chains summed
//   xgather       x gathered at indices derived from the entry position, no
//                 cols/values stream; per row the sum
//   ring_copy     kernel 7's ring copying cols and values; per unit the
//                 XOR of both streams' words (checksum only)
//   ring_alu      kernel 7's ring loop with no copies and the mul-add chain
//                 per entry slot; per unit the threads' chains summed
//   ring_copy_alu ring_copy's copies and ring_alu's chains; per unit the
//                 chains' sum and the XOR of the columns
//   ring_fold     kernel 7's fold (MULT/PLUS f32, staged_fold.cuh) on column
//                 and value slots that stay resident: each CTA copies the
//                 first words of cols and values into its slot once, and
//                 every stage folds those words in place of its own (only
//                 the units' row pointers go through the ring); per row the
//                 sum, as kernel 7 writes it (the fold's own time; TPU probe
//                 make_manual(real=True), manual_real)
//   warp_row      + the per-row store: the warp-per-row MULT/PLUS f32 SpMV
//                 of kernel 1 before its redesign (TPU probe k_full :99),
//                 out = x-weighted row sums
//   flat_stream   no rows: the entry stream in tiles of 4096 entries, a CTA
//                 a tile, each thread 4 aligned 16-byte loads of cols and of
//                 values in flight; per tile the value sum and the XOR of
//                 the columns (the stream's floor)
//   flat_gather   flat_stream's loads + x[cols] and the products; per tile
//                 the sum (the floor of the stream with its x gathers)
//
// Every phase writes an output its plain version (kernels/probe.py)
// reproduces, so no load can be dropped by the compiler: f32 sums within a
// tolerance, XOR checksums bitwise.  Bound: bytes for the streaming phases,
// f32 operations for the chains.

#include "staged_fold.cuh"

// kept equal to spla_tpu_torch.kernels.probe.PHASES
enum ProbePhase : int {
  PH_STREAM = 0, PH_GATHER = 1, PH_FULLFIX = 2, PH_ALU = 3, PH_XGATHER = 4,
  PH_RING_COPY = 5, PH_RING_ALU = 6, PH_RING_COPY_ALU = 7, PH_WARP_ROW = 8, PH_FLAT_STREAM = 9,
  PH_FLAT_GATHER = 10, PH_RING_FOLD = 11
};
constexpr int kFlatTile = 4096;  // entries of a flat tile; kept equal to probe.FLAT_TILE
constexpr int kChain = 8;  // mul-add pairs per entry slot; kept equal to probe.CHAIN

// Rounded mul then rounded add, never contracted to an FMA, so the plain
// version reproduces each chain bitwise.
__device__ __forceinline__ float chain(float s) {
#pragma unroll
  for (int i = 0; i < kChain; ++i) s = __fadd_rn(__fmul_rn(s, 1.0001f), 2.0f);
  return s;
}

// xgather's index of entry position k: a multiplicative hash, mod n.
__device__ __forceinline__ long long spread_index(long long k, long long n) {
  const uint32_t h = static_cast<uint32_t>(k) * 2654435761u;
  return static_cast<long long>(h % static_cast<unsigned long long>(n));
}

template <int PHASE>
__global__ void __launch_bounds__(kThreads)
spmv_probe_kernel(long long m, long long n, const int32_t* __restrict__ indptr,
                  const int32_t* __restrict__ cols, const float* __restrict__ values,
                  const float* __restrict__ x, float* __restrict__ out_f, int32_t* __restrict__ out_i) {
  constexpr bool kCta = PHASE == PH_GATHER || PHASE == PH_FULLFIX;
  __shared__ float part[kThreads];  // gather: a sum a thread; fullfix: a sum a warp
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  float acc = PHASE == PH_ALU ? static_cast<float>(lane) : 0.f;
  uint32_t chk = 0;
  if (row < m) {  // uniform across the warp
    const int32_t end = indptr[row + 1];
    for (int32_t k = indptr[row] + lane; k < end; k += 32) {
      if constexpr (PHASE == PH_STREAM) {
        acc += values[k];
        chk ^= static_cast<uint32_t>(cols[k]);
      } else if constexpr (kCta) {
        acc += values[k] * x[cols[k]];
      } else if constexpr (PHASE == PH_ALU) {
        acc = chain(acc);
      } else {
        acc += x[spread_index(k, n)];
      }
    }
  }
  if constexpr (PHASE == PH_GATHER) {
    part[threadIdx.x] = acc;  // 0 past the last row
  } else {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(kFullMask, acc, off);
      chk ^= __shfl_xor_sync(kFullMask, chk, off);
    }
    if (lane == 0) {
      if constexpr (PHASE == PH_FULLFIX) {
        part[threadIdx.x >> 5] = acc;  // 0 past the last row
      } else if (row < m) {
        out_f[row] = acc;
        if constexpr (PHASE == PH_STREAM) out_i[row] = static_cast<int32_t>(chk);
      }
    }
  }
  if constexpr (PHASE == PH_GATHER) {
    __syncthreads();
    if (threadIdx.x < 32) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += part[lane + 32 * w];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
      if (lane == 0) out_f[blockIdx.x] = v;
    }
  } else if constexpr (PHASE == PH_FULLFIX) {
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = part[0];
      for (int w = 1; w < kWarps; ++w) v += part[w];
      out_f[blockIdx.x] = v;
    }
  }
}

// Kernel 1's first design, for MULT/PLUS f32 with no masks and init 0: a warp per
// row, lanes striding it, a shuffle fold, lane 0 stores.
__global__ void __launch_bounds__(kThreads)
spmv_probe_warp_row_kernel(long long m, const int32_t* __restrict__ indptr, const int32_t* __restrict__ cols,
                           const float* __restrict__ values, const float* __restrict__ x,
                           float* __restrict__ out) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= m) return;  // row is uniform across the warp
  float acc = 0.f;
  bool any = false;
  const int32_t end = indptr[row + 1];
  for (int32_t k = indptr[row] + lane; k < end; k += 32) {
    acc += values[k] * x[cols[k]];
    any = true;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFullMask, acc, off);
  any = __any_sync(kFullMask, any);
  if (lane == 0) out[row] = any ? 0.f + acc : 0.f;
}

// A CTA per tile of kFlatTile entries; thread t takes the 4-entry chunks t,
// t + 256, t + 512, t + 768 of its tile, all loads issued before any use.
// Entries at and past nnz = indptr[m] are skipped; a chunk that reaches
// them is read entry by entry.  cols and values are 16-byte aligned.
template <bool GATHER>
__global__ void __launch_bounds__(kThreads)
spmv_probe_flat_kernel(long long m, const int32_t* __restrict__ indptr, const int32_t* __restrict__ cols,
                       const float* __restrict__ values, const float* __restrict__ x,
                       float* __restrict__ out_f, int32_t* __restrict__ out_i) {
  constexpr int kChunks = kFlatTile / 4 / kThreads;
  __shared__ float red_f[kWarps];
  __shared__ uint32_t red_i[kWarps];
  const long long nnz = indptr[m];
  const long long tile0 = static_cast<long long>(blockIdx.x) * kFlatTile;
  int4 c[kChunks];
  float4 v[kChunks];
#pragma unroll
  for (int u = 0; u < kChunks; ++u) {
    const long long e = tile0 + 4LL * (threadIdx.x + u * kThreads);
    if (e + 4 <= nnz) {
      c[u] = __ldcs(reinterpret_cast<const int4*>(cols + e));
      v[u] = __ldcs(reinterpret_cast<const float4*>(values + e));
    } else {  // the tail: entry by entry, -1 past nnz
      c[u] = make_int4(e < nnz ? cols[e] : -1, e + 1 < nnz ? cols[e + 1] : -1, e + 2 < nnz ? cols[e + 2] : -1,
                       -1);
      v[u] = make_float4(e < nnz ? values[e] : 0.f, e + 1 < nnz ? values[e + 1] : 0.f,
                         e + 2 < nnz ? values[e + 2] : 0.f, 0.f);
    }
  }
  float acc = 0.f;
  uint32_t chk = 0;
#pragma unroll
  for (int u = 0; u < kChunks; ++u) {
    const int32_t cc[4] = {c[u].x, c[u].y, c[u].z, c[u].w};
    const float vv[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
    if constexpr (GATHER) {
      float xv[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) xv[t] = cc[t] >= 0 ? __ldg(x + cc[t]) : 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) acc += vv[t] * xv[t];
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        acc += vv[t];
        if (cc[t] >= 0) chk ^= static_cast<uint32_t>(cc[t]);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(kFullMask, acc, off);
    chk ^= __shfl_xor_sync(kFullMask, chk, off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_f[warp] = acc;
    red_i[warp] = chk;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = red_f[0];
    uint32_t sum = red_i[0];
    for (int w = 1; w < kWarps; ++w) {
      total += red_f[w];
      sum ^= red_i[w];
    }
    out_f[blockIdx.x] = total;
    if (!GATHER) out_i[blockIdx.x] = static_cast<int32_t>(sum);
  }
}

template <int PHASE>
struct RingProbeStage {
  static constexpr bool kCopy = PHASE != PH_RING_ALU;
  static constexpr bool kAlu = PHASE != PH_RING_COPY;
  Plan p;
  uint32_t* ring_cols;
  uint32_t* ring_vals;
  int slot_w;
  const int32_t* cols;
  const float* values;
  float* out_f;
  int32_t* out_i;
  float* red_f;
  uint32_t* red_i;
  float acc;  // carried across a unit's stages
  uint32_t chk;

  __device__ void copy(int slot, const Stage& s) {
    if (!kCopy) return;
    copy_words(ring_cols + slot * slot_w, cols, s.e0, s.e1);
    copy_words(ring_vals + slot * slot_w, values, s.e0, s.e1);
  }

  __device__ void consume(int slot, const Stage& s) {
    const int len = s.e1 - s.e0;
    if (s.first()) {
      acc = static_cast<float>(threadIdx.x);
      chk = 0;
    }
    if (kCopy) {
      const uint32_t* sc = ring_cols + slot * slot_w + line_offset(cols, s.e0);
      const uint32_t* sv = ring_vals + slot * slot_w + line_offset(values, s.e0);
      for (int k = threadIdx.x; k < len; k += kThreads) {
        chk ^= sc[k];
        if (kAlu) acc = chain(acc);
        else chk ^= sv[k];
      }
    } else {
      for (int k = threadIdx.x; k < len; k += kThreads) acc = chain(acc);
    }
    if (!s.last()) return;
    float v = acc;
    uint32_t h = chk;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_xor_sync(kFullMask, v, off);
      h ^= __shfl_xor_sync(kFullMask, h, off);
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
      red_f[warp] = v;
      red_i[warp] = h;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = red_f[0];
      uint32_t sum = red_i[0];
      for (int w = 1; w < kWarps; ++w) {
        total += red_f[w];
        sum ^= red_i[w];
      }
      if (kAlu) out_f[s.unit] = total;
      if (kCopy) out_i[s.unit] = static_cast<int32_t>(sum);
    }
  }
};

template <int SLOTS, int PHASE>
__global__ void __launch_bounds__(kThreads)
spmv_ring_probe_kernel(Plan p, const int32_t* __restrict__ cols, const float* __restrict__ values,
                       float* __restrict__ out_f, int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) uint32_t ring[];
  __shared__ float red_f[kWarps];
  __shared__ uint32_t red_i[kWarps];
  const int slot_w = slot_words(p.stage);
  RingProbeStage<PHASE> body{p, ring, ring + SLOTS * slot_w, slot_w, cols, values, out_f, out_i,
                             red_f, red_i, 0.f, 0u};
  ring_loop<SLOTS>(p, body);
}

// ring_fold's stage body: kernel 7's MULT/PLUS f32 fold on the words kept
// in slot 0 in place of each stage's own; only the units' row pointers go
// through the ring.
struct ResidentFold {
  StagedFold<KC_MULT, KC_PLUS, false> f;

  __device__ void copy(int slot, const Stage& s) { f.copy_rows(slot, s); }
  __device__ void consume(int slot, const Stage& s) { f.fold(slot, s, f.ring_cols, f.ring_vals); }
};

// ring_fold: the first `resident` words of cols and values are copied into
// slot 0 once, as the oldest commit group, so they have landed before the
// first stage is folded.  The same shared memory and launch bounds as
// kernel 7.
template <int SLOTS>
__global__ void __launch_bounds__(kThreads, 6)
spmv_ring_fold_kernel(Plan p, StagedArgs a, int resident) {
  extern __shared__ __align__(16) uint32_t ring[];
  ResidentFold body{staged_fold<SLOTS, KC_MULT, KC_PLUS, false>(p, a, ring)};
  copy_words(body.f.ring_cols, a.cols, 0, resident);
  copy_words(body.f.ring_vals, a.values, 0, resident);
  cp_async_commit();
  ring_loop<SLOTS>(p, body);
}

namespace {

template <int PHASE>
int launch_probe(long long m, long long n, const void* indptr, const void* cols, const void* values,
                 const void* x, void* out_f, void* out_i, cudaStream_t stream) {
  spmv_probe_kernel<PHASE><<<blocks_for_warps(m), kThreads, 0, stream>>>(
      m, n, static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(cols),
      static_cast<const float*>(values), static_cast<const float*>(x), static_cast<float*>(out_f),
      static_cast<int32_t*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

struct RingArgs {
  Plan p;
  const void *cols, *values, *x;
  int resident;
  void *out_f, *out_i;
  cudaStream_t stream;
};

template <int SLOTS, int PHASE>
int launch_ring(const RingArgs& r) {
  static thread_local GridCache cache;
  unsigned grid = 0;
  if constexpr (PHASE == PH_RING_FOLD) {
    const auto kernel = spmv_ring_fold_kernel<SLOTS>;
    const size_t smem = ring_bytes<false>(SLOTS, r.p.stage);
    const cudaError_t err = ring_grid(kernel, smem, r.p.nunits, cache, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    const StagedArgs a{static_cast<const int32_t*>(r.cols), static_cast<const float*>(r.values),
                       static_cast<const float*>(r.x), nullptr, nullptr, nullptr, 0.f,
                       static_cast<float*>(r.out_f), nullptr, 0, false};
    kernel<<<grid, kThreads, smem, r.stream>>>(r.p, a, r.resident);
  } else {
    const auto kernel = spmv_ring_probe_kernel<SLOTS, PHASE>;
    const size_t smem = sizeof(uint32_t) * SLOTS * slot_words(r.p.stage) * (PHASE == PH_RING_ALU ? 0 : 2);
    const cudaError_t err = ring_grid(kernel, smem, r.p.nunits, cache, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, r.stream>>>(r.p, static_cast<const int32_t*>(r.cols),
                                               static_cast<const float*>(r.values),
                                               static_cast<float*>(r.out_f), static_cast<int32_t*>(r.out_i));
  }
  return static_cast<int>(cudaGetLastError());
}

template <int PHASE>
int ring_by_slots(int slots, const RingArgs& r) {
  switch (slots) {
    case 2: return launch_ring<2, PHASE>(r);
    case 3: return launch_ring<3, PHASE>(r);
    case 4: return launch_ring<4, PHASE>(r);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The warp-per-row and flat phases.  out_f: f32 [m] (stream, alu, xgather,
// warp_row), [ceil(m / 8)] (gather, fullfix, one a CTA) or [ceil(capacity /
// 4096)] (flat_*, n is then the capacity); out_i: int32 [m] (stream),
// [tiles] (flat_stream) or null.
extern "C" int spla_spmv_probe(int phase, long long m, long long n, const void* indptr,
                               const void* cols, const void* values, const void* x, void* out_f,
                               void* out_i, void* stream) {
  if (m == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (phase) {
    case PH_STREAM: return launch_probe<PH_STREAM>(m, n, indptr, cols, values, x, out_f, out_i, s);
    case PH_GATHER: return launch_probe<PH_GATHER>(m, n, indptr, cols, values, x, out_f, out_i, s);
    case PH_FULLFIX: return launch_probe<PH_FULLFIX>(m, n, indptr, cols, values, x, out_f, out_i, s);
    case PH_ALU: return launch_probe<PH_ALU>(m, n, indptr, cols, values, x, out_f, out_i, s);
    case PH_XGATHER: return launch_probe<PH_XGATHER>(m, n, indptr, cols, values, x, out_f, out_i, s);
    case PH_FLAT_STREAM:
    case PH_FLAT_GATHER: {
      const auto kernel = phase == PH_FLAT_GATHER ? spmv_probe_flat_kernel<true> : spmv_probe_flat_kernel<false>;
      const long long tiles = (n + kFlatTile - 1) / kFlatTile;
      if (tiles == 0) return 0;
      kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
          m, static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(cols),
          static_cast<const float*>(values), static_cast<const float*>(x), static_cast<float*>(out_f),
          static_cast<int32_t*>(out_i));
      return static_cast<int>(cudaGetLastError());
    }
    case PH_WARP_ROW:
      spmv_probe_warp_row_kernel<<<blocks_for_warps(m), kThreads, 0, s>>>(
          m, static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(cols),
          static_cast<const float*>(values), static_cast<const float*>(x), static_cast<float*>(out_f));
      return static_cast<int>(cudaGetLastError());
    default: return -1;
  }
}

// The ring phases, on kernel 7's plan (units, unit_hub, hub_units; part,
// part_any and done as kernel 7's, for ring_fold).  out_f: f32 [nunits]
// (ring_alu, ring_copy_alu), f32 [m] (ring_fold) or null; out_i: int32
// [nunits] (ring_copy, ring_copy_alu) or null; x: f32 [n] (ring_fold);
// resident: the words of cols and values ring_fold keeps in its slot (both
// 16-byte aligned).
extern "C" int spla_spmv_probe_ring(int phase, int slots, int stage, long long nunits, const void* units,
                                    const void* unit_hub, const void* hub_units, void* part, void* part_any,
                                    void* done, const void* indptr, const void* cols, const void* values,
                                    const void* x, int resident, void* out_f, void* out_i, void* stream) {
  if (nunits == 0) return 0;
  if (stage < 2 || stage > kMaxStage) return static_cast<int>(cudaErrorInvalidValue);
  const RingArgs r{{static_cast<const int4*>(units), static_cast<const int32_t*>(unit_hub),
                    static_cast<const int32_t*>(hub_units), static_cast<const int32_t*>(indptr), part,
                    static_cast<uint8_t*>(part_any), static_cast<int32_t*>(done), nunits, stage},
                   cols, values, x, resident, out_f, out_i, static_cast<cudaStream_t>(stream)};
  switch (phase) {
    case PH_RING_COPY: return ring_by_slots<PH_RING_COPY>(slots, r);
    case PH_RING_ALU: return ring_by_slots<PH_RING_ALU>(slots, r);
    case PH_RING_COPY_ALU: return ring_by_slots<PH_RING_COPY_ALU>(slots, r);
    case PH_RING_FOLD: return ring_by_slots<PH_RING_FOLD>(slots, r);
    default: return -1;
  }
}
