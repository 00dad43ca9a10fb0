// The stage ring of kernel 7 (spmv_staged.cu), shared with kernel 8's ring
// probes (spmv_probe.cu).
//
// Rows are grouped into row blocks (built by spla_tpu_torch.kernels.staged
// .staged_plan): block b holds rows [block_rows[b], block_rows[b + 1]).  A
// block of several rows holds fewer than `stage` entries; a block of one row
// may hold more and is then cut into parts of `stage` entries.  Each
// (block, part) is one stage of the entry stream.
//
// A persistent grid of CTAs strides over the blocks (CTA c takes blocks c,
// c + gridDim.x, ...), so each CTA walks one sequence of stages.  Its ring of
// SLOTS shared-memory slots keeps SLOTS - 1 stages in flight (cp.async, one
// commit group per stage) while it folds the current one: the counterpart of
// the make_async_copy ring of spla_tpu/pallas/spmv.py
// fused_cell_spmv_apply_manual (:2168-2202), whose single program walks all
// tile batches.  The prologue primes at most SLOTS - 1 stages and commits an
// empty group for each stage a CTA does not have, so a CTA with fewer stages
// than slots never reads past its sequence (the TPU kernel primes all its
// slots unconditionally, :2180-2181, and fails on a format of one batch).
#pragma once

#include "semiring.cuh"

constexpr int kMaxStage = 1024;  // kept equal to spla_tpu_torch.kernels.staged.MAX_STAGE
constexpr int kWarps = kThreads / 32;

// Words of one ring slot: a copy starts at the 16-byte line holding the
// stage's first entry (up to 3 words early) and ends on a whole line; slots
// stay 16-byte aligned.
__host__ __device__ constexpr int slot_words(int stage) { return (stage + 11) & ~3; }

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

struct RowBlocks {
  const int32_t* block_rows;  // [nblocks + 1]
  const int32_t* indptr;
  long long nblocks;
  int stage;
};

// A CTA's position in its stage sequence: block `blk`, part `part`.
struct Cursor {
  long long blk;
  int part, nparts;
  int32_t r0, r1;
  long long b0, b1;  // the block's entries

  __device__ void load(const RowBlocks& p) {
    part = 0;
    if (blk >= p.nblocks) return;
    r0 = p.block_rows[blk];
    r1 = p.block_rows[blk + 1];
    b0 = p.indptr[r0];
    b1 = p.indptr[r1];
    const long long len = b1 - b0;
    nparts = len > 0 ? static_cast<int>((len + p.stage - 1) / p.stage) : 1;
  }
  __device__ bool done(const RowBlocks& p) const { return blk >= p.nblocks; }
  __device__ void next(const RowBlocks& p) {
    if (++part < nparts) return;
    blk += gridDim.x;
    load(p);
  }
  __device__ long long e0(const RowBlocks& p) const { return b0 + static_cast<long long>(part) * p.stage; }
  __device__ long long e1(const RowBlocks& p) const {
    const long long e = e0(p) + p.stage;
    return e < b1 ? e : b1;
  }
  __device__ bool last() const { return part == nparts - 1; }
};

// Walk this CTA's stages through the ring.  `body.copy(slot, cursor)` issues
// this thread's copies of a stage; `body.consume(slot, cursor)` folds it and
// may call __syncthreads() (every thread takes the same branch for a stage).
template <int SLOTS, typename Body>
__device__ __forceinline__ void ring_loop(const RowBlocks& p, Body& body) {
  static_assert(SLOTS >= 2, "a ring needs a slot in flight and one being folded");
  Cursor prod{static_cast<long long>(blockIdx.x)};
  Cursor cons{static_cast<long long>(blockIdx.x)};
  prod.load(p);
  cons.load(p);
#pragma unroll
  for (int s = 0; s < SLOTS - 1; ++s) {
    if (!prod.done(p)) {
      body.copy(s, prod);
      prod.next(p);
    }
    cp_async_commit();
  }
  int slot = 0, fill = SLOTS - 1;
  while (!cons.done(p)) {
    // `fill` was folded in the previous step, behind its closing barrier
    if (!prod.done(p)) {
      body.copy(fill, prod);
      prod.next(p);
    }
    cp_async_commit();
    cp_async_wait<SLOTS - 1>();  // this thread's copies of the current stage have landed
    __syncthreads();             // and every thread's
    body.consume(slot, cons);
    __syncthreads();
    cons.next(p);
    slot = slot + 1 == SLOTS ? 0 : slot + 1;
    fill = fill + 1 == SLOTS ? 0 : fill + 1;
  }
  cp_async_wait<0>();
}

// Launch geometry of a ring kernel: the occupancy limit times the SMs, at
// most one CTA per block.
template <typename Kernel>
cudaError_t ring_grid(Kernel kernel, size_t smem, long long nblocks, unsigned* grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  const long long most = static_cast<long long>(per_sm) * sms;
  *grid = static_cast<unsigned>(nblocks < most ? nblocks : most);
  return cudaSuccess;
}
