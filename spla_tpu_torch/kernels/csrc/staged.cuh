// The stage ring of kernel 7 (spmv_staged.cu), shared with kernel 8's ring
// probes (spmv_probe.cu).
//
// Work comes in units, built by spla_tpu_torch.kernels.staged.staged_plan:
// unit u holds rows [r0, r1) and entries [e0, e1) (units[u] = {r0, r1, e0,
// e1}).  A unit of several rows (at most kBlockRows) holds fewer than
// `stage` entries and is one stage.  A unit of one row is a chunk of at most
// staged.CHUNK_STAGES stages of that row, cut into stages of `stage` entries; a
// row of several chunks is a "hub" (unit_hub[u] = its rank among them,
// else -1), whose chunks are consecutive units, hub_units[hub] = {first
// unit, chunk count}.
//
// A persistent grid of CTAs strides over the units (CTA c takes units c,
// c + gridDim.x, ...), so each CTA walks one sequence of stages.  Its ring of
// SLOTS shared-memory slots keeps SLOTS - 1 stages in flight (cp.async, one
// commit group per stage) while it folds the current one: the counterpart of
// the make_async_copy ring of spla_tpu/pallas/spmv.py
// fused_cell_spmv_apply_manual (:2168-2202), whose single program walks all
// tile batches.  The prologue primes at most SLOTS - 1 stages and commits an
// empty group for each stage a CTA does not have, so a CTA with fewer stages
// than slots never reads past its sequence (the TPU kernel primes all its
// slots unconditionally, :2180-2181, and fails on a format of one batch).
//
// The producer reads each unit's descriptor once, one unit ahead of its
// copies, and leaves each stage's descriptor in shared memory beside its
// slot, so the fold of a stage waits on no global load of the plan.
#pragma once

#include "semiring.cuh"

constexpr int kMaxStage = 1024;  // kept equal to spla_tpu_torch.kernels.staged.MAX_STAGE
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = kMaxStage / kThreads;  // entries of a full stage each thread takes
constexpr int kBlockRows = kThreads;  // rows of a unit of several rows; kept equal to staged.BLOCK_ROWS

// Words of one ring slot: a copy starts at the 16-byte line holding the
// stage's first entry (up to 3 words early) and ends on a whole line; slots
// stay 16-byte aligned.
__host__ __device__ constexpr int slot_words(int stage) { return (stage + 11) & ~3; }
// Words of a slot's indptr slice: the kBlockRows + 1 row pointers of a unit of several rows.
constexpr int kRowWords = slot_words(kBlockRows + 1);

__device__ __forceinline__ void cp_async16(uint32_t* smem, uintptr_t gmem, int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  // bytes < 16 zero-fills the rest of the line and reads nothing past `bytes`
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Position, in its slot, of the stage's first word e of `base`.
__device__ __forceinline__ int line_offset(const void* base, long long e) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(static_cast<const uint32_t*>(base) + e) & 15u) >> 2);
}

// This thread's share of the copies of words [e0, e1) of `base` into `slot`.
// The first line may begin before e0: that is inside the same allocation,
// whose start is aligned far beyond 16 bytes.
__device__ __forceinline__ void copy_words(uint32_t* slot, const void* base, long long e0, long long e1) {
  if (e1 <= e0) return;
  const uint32_t* words = static_cast<const uint32_t*>(base);
  const uintptr_t line0 = reinterpret_cast<uintptr_t>(words + e0) & ~static_cast<uintptr_t>(15);
  const uintptr_t end = reinterpret_cast<uintptr_t>(words + e1);
  const int lines = static_cast<int>((end - line0 + 15) >> 4);
  for (int i = threadIdx.x; i < lines; i += blockDim.x) {
    const uintptr_t src = line0 + 16 * static_cast<uintptr_t>(i);
    const uintptr_t left = end - src;
    cp_async16(slot + 4 * i, src, left < 16 ? static_cast<int>(left) : 16);
  }
}

struct Plan {
  const int4* units;          // [nunits]: r0, r1, e0, e1
  const int32_t* unit_hub;    // [nunits]: the hub of a chunk of a row of several chunks, else -1
  const int32_t* hub_units;   // [nhub, 2]: each hub's first unit and its chunk count
  const int32_t* indptr;
  void* part;                 // [nunits] 32-bit words: a hub chunk's fold (value kernels)
  uint8_t* part_any;          // [nunits]: whether it folded anything
  int32_t* done;              // [nhub]: chunks of each hub finished; zero between launches
  long long nunits;
  int stage;
};

// One stage of a CTA's sequence: rows [r0, r1), entries [e0, e1), part
// `part` of `nparts` of unit `unit`.
struct Stage {
  int32_t r0, r1, e0, e1;
  int32_t unit, part, nparts;

  __device__ bool first() const { return part == 0; }
  __device__ bool last() const { return part == nparts - 1; }
  __device__ bool several_rows() const { return r1 - r0 > 1; }
};

// The producer's position: unit `unit` (descriptor q), part `part`.
struct Cursor {
  long long unit;
  int part, nparts;
  int4 q;

  __device__ void load(const Plan& p) {
    part = 0;
    if (unit >= p.nunits) return;
    q = __ldg(p.units + unit);
    const int len = q.w - q.z;
    nparts = len > 0 ? (len + p.stage - 1) / p.stage : 1;
  }
  __device__ bool done(const Plan& p) const { return unit >= p.nunits; }
  __device__ void next(const Plan& p) {
    if (++part < nparts) return;
    unit += gridDim.x;
    load(p);
  }
  __device__ Stage stage(const Plan& p) const {
    const int32_t e0 = q.z + part * p.stage;
    return {q.x, q.y, e0, min(e0 + p.stage, q.w), static_cast<int32_t>(unit), part, nparts};
  }
};

// Walk this CTA's stages through the ring.  `body.copy(slot, stage)` issues
// this thread's copies of a stage; `body.consume(slot, stage)` folds it and
// may call __syncthreads() (every thread takes the same branch for a stage).
template <int SLOTS, typename Body>
__device__ __forceinline__ void ring_loop(const Plan& p, Body& body) {
  static_assert(SLOTS >= 2, "a ring needs a slot in flight and one being folded");
  __shared__ Stage meta[SLOTS];
  Cursor prod{static_cast<long long>(blockIdx.x)};
  prod.load(p);
  int pending = 0;  // stages copied and not yet folded (uniform across the CTA)
#pragma unroll
  for (int s = 0; s < SLOTS - 1; ++s) {
    if (!prod.done(p)) {
      const Stage st = prod.stage(p);
      if (threadIdx.x == 0) meta[s] = st;
      body.copy(s, st);
      prod.next(p);
      ++pending;
    }
    cp_async_commit();
  }
  int slot = 0, fill = SLOTS - 1;
  while (pending > 0) {
    // `fill` was folded in the previous step, behind its closing barrier
    if (!prod.done(p)) {
      const Stage st = prod.stage(p);
      if (threadIdx.x == 0) meta[fill] = st;
      body.copy(fill, st);
      prod.next(p);
      ++pending;
    }
    cp_async_commit();
    cp_async_wait<SLOTS - 1>();  // this thread's copies of the current stage have landed
    __syncthreads();             // and every thread's, and the stage's descriptor
    const Stage st = meta[slot];
    body.consume(slot, st);
    __syncthreads();
    --pending;
    slot = slot + 1 == SLOTS ? 0 : slot + 1;
    fill = fill + 1 == SLOTS ? 0 : fill + 1;
  }
  cp_async_wait<0>();
}

// Launch geometry of a ring kernel: the occupancy limit times the SMs, at
// most one CTA per unit.  The occupancy is asked once per kernel instance,
// device and shared-memory size (each instance keeps its own cache).
struct GridCache {
  int device = -1;
  size_t smem = 0;
  long long ctas = 0;
};

template <typename Kernel>
cudaError_t ring_grid(Kernel kernel, size_t smem, long long nunits, GridCache& cache, unsigned* grid) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != cache.device || smem != cache.smem) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
    cache = {device, smem, static_cast<long long>(per_sm) * sms};
  }
  *grid = static_cast<unsigned>(nunits < cache.ctas ? nunits : cache.ctas);
  return cudaSuccess;
}
