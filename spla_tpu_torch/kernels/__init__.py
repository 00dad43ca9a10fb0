"""Hand-written Hopper kernels of the masked SpMV, traversal and SpGEMM paths.

* ``spmv`` — kernel 1, the CSR pull SpMV (CUDA, ``csrc/spmv_pull.cuh``):
  its templated instances (``csrc/spmv_pull.cu``; with an x-validity mask
  ``csrc/spmv_pull_masked.cu``) and its generic family, whose mul is a
  kernel argument (``csrc/spmv_pull_generic.cu``,
  ``csrc/spmv_pull_generic_masked.cu``); a masked call first packs the
  mask into a bitmap (``pack_valid_bits``, ``csrc/spmv_pull.cu``);
* ``traversal`` — kernel 2, the frontier push SpMV, and the level loop's
  push levels fused with kernel 3's update (CUDA, ``csrc/spmv_push.cu``);
* ``level_update`` — kernel 3, the BFS/SSSP level update with frontier
  compaction, and the update of an SSSP push level's touched vertices
  (CUDA, ``csrc/level_update.cu``); ``frontier`` holds the level loop's
  state, whose lists both keep (``csrc/frontier.cuh``);
* ``mxmt`` — kernels 4 and 5, the masked SpGEMM-T intersections: the
  summed products (triangle counting) and one folded value per mask
  entry (CUDA, ``csrc/mxmt.cu``);
* ``spgemm`` — kernel 9, the row-wise Gustavson SpGEMM of ``mxm``: a
  symbolic phase, then each row's products folded in a hash table in
  shared memory (a warp or a CTA a row) or a dense accumulator (a CTA a
  long row), its entries sorted by column (CUDA, ``csrc/spgemm.cu``);
* ``resident`` — kernel 6, a whole BFS or SSSP in one persistent
  cooperative launch with a grid-wide barrier between levels (CUDA,
  ``csrc/resident.cu``);
* ``staged`` — kernel 7, the pull SpMV with its column and value streams
  staged through a ring of shared-memory slots by asynchronous copies
  (CUDA, ``csrc/spmv_staged.cuh``): its templated instances
  (``csrc/spmv_staged.cu``) and its generic family (``csrc/spmv_staged_generic.cu``),
  taken under ``staged.MANUAL_DMA``;
* ``probe`` — kernel 8, the phase probes of kernels 1 and 7 (CUDA,
  ``csrc/spmv_probe.cu``): kernel 1's warp-per-row design before its
  redesign (phase ``warp_row``) and its parts, kernel 7's ring and its
  fold, and the row-free floors of the stream and of its x gathers; run by
  ``tools/probe_spmv.py``; and ``mxmt_gather``, kernels 4 and 5's walk of
  the mask with no probe of A (CUDA, ``csrc/mxmt.cu``): the floor of their
  gathers of B's rows.

Each wrapper runs its plain PyTorch version for CPU tensors, and launches
its kernel or raises for CUDA tensors.  ``LAUNCHES`` counts the kernel
launches of each wrapper (``sssp_push_level`` counts its two;
``spgemm_mxm`` one a call of its three steps); a launch of kernel 1's
generic family counts as ``spmv_pull_generic``, one of kernel 7's as
``spmv_pull_staged_generic``; ``valid_bits`` counts the packs of kernel 1's
x-validity masks into bitmaps, one a masked kernel-1 call.  Its one entry
that counts no launch, ``pull_segments``, counts the segments of x kernel
1's launches walked in turn (its plan's S a value launch, 1 a structural
one).  A kernel's launch
plan is a fact of the tensors it reads, built once and kept in the port's
one store of derived facts (``formats.derived``).  Importing these modules
builds and loads nothing.
"""

PROBE_PHASES = ("stream", "gather", "fullfix", "alu", "xgather", "ring_copy", "ring_alu",
                "ring_copy_alu", "warp_row", "flat_stream", "flat_gather",
                "ring_fold")  # kernel 8's phases, in the order of enum ProbePhase

LAUNCHES = {"spmv_pull": 0, "spmv_pull_generic": 0, "pull_segments": 0, "valid_bits": 0, "spmv_push": 0, "level_update": 0, "bfs_push_level": 0,
            "sssp_push_level": 0,
            "mxmt_reduce": 0, "mxmt_masked": 0, "mxmt_gather": 0, "spgemm_mxm": 0,
            "bfs_resident": 0, "sssp_resident": 0, "spmv_pull_staged": 0, "spmv_pull_staged_generic": 0,
            **{f"spmv_probe_{phase}": 0 for phase in PROBE_PHASES}}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
