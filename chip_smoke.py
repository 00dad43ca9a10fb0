#!/usr/bin/env python3
"""Bring-up check of spla_tpu_torch on one NVIDIA GPU (written for the H100).

Run from the repository root:  python3 chip_smoke.py

Phases:
  1. device: the card's name and power limit (no CUDA device: exit non-zero);
  2. build: compile the CUDA kernels from kernels/csrc and print ptxas' lines
     and kernel 6's grid, cluster size and registers;
  3. each kernel against its plain PyTorch version, on the card, at the
     slice's shapes (tolerances stated in ``check_close``); kernel 1 every
     instance, with and without masks and swapped, and its structural
     variant on the n = 2^21 graph, the hub graph, powerlaw_graph(2^21, 16)
     and n = 2^16 graphs whose degrees pick each team size and the hub
     path, printing each plan; kernel 6 (the
     whole BFS / SSSP in one cooperative launch) bitwise on the road grids
     of bench_suite.py, from vertex 0 and from the far corner, on a barbell
     graph (narrow and wide rounds in turn), on random_graph(2^18, 16) and,
     against its closed form, on a path of 4,096 vertices; kernel 7 (the
     staged-stream SpMV) against its plain version and kernel 1, every f32
     instance, on kernel 1's graphs: at 2, 3 and 4 slots on the n = 2^21
     graph, the hub graph, a graph of one stage and the n = 2^16 graphs, at
     its default slots on the powerlaw graph, and a repeated call bitwise;
     each of kernel 8's phase probes against its plain version; kernels 4
     and 5, every instance, and their gather floor (``kernels.probe.
     mxmt_gather``) on the n = 2^15 SpGEMM graph and the hub graph, with
     each plan (team, windows, hub chunks) and the registers of the timed
     instances; the level loop's push levels (kernel 2's push fused with
     kernel 3's update) and pull updates, level by level against their
     plain versions, on the n = 2^20 random graph, the road grids and
     bench_suite's skewed graph (from its longest row); kernel 9 (the
     Gustavson SpGEMM of mxm) against its plain version, every instance on
     graphs.spgemm_bins (rows in all three of its bins), MULT/PLUS f32 and
     PLUS/MIN i32 on graphs.spgemm_bins(2^20) (large rows of ~4.2 M
     products over four cluster windows), MULT/PLUS f32 on
     the mxm_mprod_s graph (random_graph(2^13, 16, seed=5), also against
     scipy's A @ A), the n = 2^20 traversal graph and the skewed graph,
     PLUS/MIN f32 (init +inf) and MULT/PLUS, PLUS/MIN, PLUS/MAX i32 on the
     2^13 graph, and a ±1 i32 PLUS case whose sums cancel (the init drop),
     printing each plan;
  4. the slices through the public entry points, each with the launch
     counts set to 0 just before it and read just after:
     * SpMV: mxv_masked / vxm_masked / vxm_masked_dense on the bench.py
       graph (n = 2^21, 16 entries a row), bfs / sssp / pr on the
       bench_suite.py graph (n = 2^20, degree 16), against scipy's oracles
       (pr: a float64 PageRank, within rtol 1e-5) and the plain path, in
       every traversal mode;
     * push: kernel 2's public spmv_push (MIN-plus) and
       spmv_push_structural at the depth-3 frontier of the n = 2^20 graph,
       against their plain versions;
     * skewed: bfs / sssp on bench_suite.py's skewed graph (n = 2^18,
       zipf(2.1) out-degrees, bench_suite.py:441-448) in every mode, which
       the skew gate keeps on the level loop, and bfs on the side-3072 road
       grid, which the byte budget sends there, against scipy;
     * SpGEMM-T: tc on the bench_suite.py SpGEMM graph (n = 2^15, degree
       24) against scipy and on the traversal graph against the plain path;
       mxmT_masked at n = 2^20 against the plain path;
     * road: bfs on the side-1024 Morton grid and sssp on the side-512 one
       (bench_suite.py:226-253,323-334), which take the resident route,
       against scipy and bitwise against the level loop; then the bfs and
       sssp example CLIs on the side-512 grid, and the pr and tc ones on a
       small random graph, each checked by its naive oracle;
     * staged: with ``kernels.staged.MANUAL_DMA`` set, mxv_masked at
       n = 2^21 and bfs / sssp / pr on the n = 2^20 graph's level loop,
       against the plain path, scipy and the unstaged runs; then
       ``tools/ab_spmv.py --manual 3 --check`` under SPLA_MANUAL_DMA=1
       SPLA_MANUAL_SLOTS=3 in a subprocess;
     * probes: ``tools/probe_spmv.py``'s run at n = 2^21, degree 16, and
       the gather floor of kernels 4 and 5 on tc's n = 2^20 call;
     * mxm: the public ops.mxm, MULT/PLUS f32, on the 2^13 graph (against
       scipy) and the n = 2^20 graph (against the plain version), and once
       with products_cap, which takes the torch path;
     * ops: the plain-PyTorch op layer at full size, every call under
       torch.cuda.set_sync_debug_mode("error") but bsr_from_csr_host (host
       code): on A, the n = 2^21 SpMV graph's entries (rows sorted by
       column, duplicates summed, capacity 33,554,432), m_transpose,
       m_eadd(A, Aᵀ, PLUS), m_emult(A, Aᵀ, MIN), the row and column sums and
       the longest row and column extracted; kron(random_graph(2^11, 16,
       seed=7), B) with B 1,024 x 1,024 of 1,024 entries (n = 2^21); every
       vector op on two sparse vectors of 2^17 entries and dense ones at
       n = 2^21; bsr_spmv and bsr_spmm (X of 64 columns) on a band of
       half-width 64 at n = 2^17 in 128-tiles; against scipy and numpy
       (A + Aᵀ, A.minimum(Aᵀ), scipy.sparse.kron, float64 sums), exact but
       for the PLUS folds;
     * facade: the pyspla-style objects, every one made with no device= (so
       on cuda:0, which the slice checks): bench_suite.py's facade chain
       uncut (random_graph(2^18, 8, seed=7) scaled by 0.85 / in-degree,
       built by Matrix.build of three MemViews; ten Vector.vxm from a
       vector with 1.0 at every 256th vertex, then reduce(PLUS)) against
       scipy's float64 chain, Matrix.mxv on the same graph, Vector.eadd /
       emult / map / reduce and Matrix.transpose / reduce_by_row on the
       chain's objects against numpy, Matrix.mxm (MULT/PLUS f32) on the
       mxm_mprod_s graph against scipy's A @ A, Matrix.mxmT masked by A
       on the n = 2^15 SpGEMM-T graph in i32 (exact) and f32 against
       scipy, the pi example at its default 10^6 samples (within 0.01 of
       pi), the convert example on a written side-512 road grid (reloaded
       equal), ``python -m spla_tpu_torch`` in a subprocess (it must name
       the card), a Schedule of callback tasks (three vxm, then a reduce,
       in order) and one chain under the time profiler and torch.profiler
       (vector_vxm ten times; the record_function names in the trace);
     * dist: the sharded layer (spla_tpu_torch.parallel, tools/dist_times.py).
       (a) A world of one NCCL rank in this process, every dist function at
       the main path's size: dist_masked_spmv on the n = 2^21 graph,
       dist_pagerank / _overlap / _pallas / _pallas_overlap, dist_bfs /
       _pallas / _pallas_overlap and dist_sssp / _pallas / _pallas_overlap
       on the n = 2^20 graph, dist_bfs with the default ladder on the
       side-1024 road grid, dist_tc at n = 2^15 and 2^20, dist_mxm on the
       mxm_mprod_s graph, against scipy, the float64 PageRank and the
       single-card entry points
       (BFS, TC and structure bitwise; f32 within section 2's tolerances),
       each launching kernel 1 (kernel 4 for dist_tc) and no torch path.
       (b) DIST_RANKS gloo ranks spawned on cuda:0, every collective staged
       through host memory, each rank launching kernels 1 and 4 on its
       shards of tools/dist_times.py SMALL's graphs (n = 2^17), their rows
       stacked equal to the world of one on the same graphs, BFS / SSSP stats
       equal to the JAX package's at S = 4 (recorded in dist_times.JAX_STATS_S4);
  5. the launch counts of phase 4: each slice's kernels must be above 0;
     the road slice reads the host once per run; the staged slice launches
     no kernel 1; the ops slice none at all; the facade slice kernel 1 24
     times, kernel 9 once and kernel 5 twice, and no torch path; the dist
     slice kernels 1 and 4, and no torch path;
  6. times on the card: each kernel against its plain version (CUDA events),
     SpMV in GB/s of the bench.py byte model, the masked SpGEMM-T in
     products/s (bench_suite.py masked_spgemm_mprod_s), BFS / SSSP / PR /
     TC wall time; kernels 4 and 5 (structural, MULT i32, MULT/PLUS i32)
     beside their gather floor on the n = 2^15, n = 2^20 and hub graphs,
     and the walls of tc and mxmT_masked; road BFS / SSSP walls on the
     resident route and on the level loop, with road_bfs_gteps and
     road_sssp_ms (bench_suite.py:265,346); the level loop on the road
     grids (sides 1024, 512 and 3072) a level, split into count reads and
     the host's own time, with the device's time a push level from one
     torch.profiler run each (tools/level_times.py), the push levels' rows,
     and the skewed graph's walls; kernels 2 and 3 also as a CUDA graph of
     20 calls (their device time);
     kernel 6's rounds, wide rounds and us a round on the road, path,
     barbell and random 2^18 graphs, and on the side-3072 grid with the
     byte budget lifted, checked against scipy;
     kernel 1 beside its first, warp-per-row design (kernel 8's warp_row),
     kernel 7 at 2, 3 and 4 slots, kernel 8's ring_copy, ring_fold and
     flat_gather, and cuSPARSE (one ``torch.sparse_csr_tensor @ x`` call,
     the library's time) on the n = 2^21, powerlaw and hub graphs, with
     kernel 1 at each team size; the probe table in ns per entry;
     ab_spmv's chained kernel 1, split2, split4 and kernel 7 steps;
     kernel 9 against its plain version and cuSPARSE (one
     ``torch.sparse.mm`` of two CSR tensors; a failure is printed as that
     graph's result) on the 2^13, 2^20 and skewed graphs, and mxm_mprod_s
     (bench_suite.py:524-557: products over the time of chained calls) at
     n = 2^13; each call of the ops slice beside its bound and, for
     m_transpose, m_eadd and bsr_spmm, one PyTorch call computing the same
     function (``to_sparse_csc()``, the sum of two CSR tensors, a BSR
     tensor times X; a failure printed as its result); facade_chain_ratio
     (bench_suite.py:349-412: the facade chain's wall over that of the same
     chain of ops.best_spmv_fn on DenseVecs, medians of 7 interleaved
     pairs) and one vxm's host cost against ops.vxm_masked_dense's;
     the dist slice's walls at world 1 beside the single-card walls on the
     same graphs, with each function's iterations, host reads, logical
     comm bytes and kernel launches, one profiled
     dist_pagerank_pallas_overlap call (device busy and idle share, and how
     long kernel 1 ran beside NCCL's kernels), and (b)'s host-staged walls.

Each kernel's row in the JSON line carries ``bound_ms``: the larger of its
bytes (each input read once, each output written once, at this run's
shapes and data) over 3.35 TB/s and its f32 operations over 67 TFLOP/s
(``bound``).

The four lines before the last are JSON objects of the dist slice's
times, of the facade chain's times, of the ops' times and of the kernels;
the last line is ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero.
Imports neither jax nor spla_tpu.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as cg
import torch

from spla_tpu_torch import Descriptor, DenseVec, algorithms as alg, formats as F, kernels, op
from spla_tpu_torch import FLOAT, INT, MemView, get_library, make_schedule
from spla_tpu_torch import facade as FC, parallel as PAR
from spla_tpu_torch.examples import convert as CONVERT, pi as PI
from spla_tpu_torch.profiling import profiler
from spla_tpu_torch.schedule import make_sched_task_callback
from spla_tpu_torch.interop import csr_from_numpy
from spla_tpu_torch.io import MtxLoader
from spla_tpu_torch.kernels import PROBE_PHASES, frontier as KF, level_update as K3, mxmt as K45
from spla_tpu_torch.kernels import probe as K8, resident as K6, spgemm as K9, spmv as K1, staged as K7
from spla_tpu_torch.kernels import traversal as K2
from spla_tpu_torch.kernels.build import build_log, load_library
from spla_tpu_torch.parallel import comm as COMM, dist_ops as DOPS
from spla_tpu_torch import ops as O
from spla_tpu_torch.ops import (DISPATCH_STATS, count_mxmT_products, m_reduce, masked_spmv, mxm,
                                mxmT_masked, mxv_masked, vxm_masked, vxm_masked_dense)
from spla_tpu_torch.ops.spgemm import mxmT_masked_plain
from spla_tpu_torch.tools import ab_spmv as AB, level_times as LT, ops_times as OT, probe_spmv as PROBE
from spla_tpu_torch.tools import dist_times as DT, resident_levels as RL
from spla_tpu_torch.tools.graphs import (HUB_ROWS, barbell_graph, build_graph, hub_graph, hub_spgemm,
                                         path_graph, powerlaw_graph, random_graph, road_graphs, road_grid,
                                         skewed_graph, spgemm_bins)

N_SPMV, DEG_SPMV = 1 << 21, 16      # bench.py:37 build_graph
N_GRAPH, DEG_GRAPH = 1 << 20, 16    # bench_suite.py:24 random_graph, bench_suite.py:122
N_TC, DEG_TC, SEED_TC = 1 << 15, 24, 3  # bench_suite.py:513-514
N_FEW = 256  # kernel 7's fewer-stages-than-slots graph: 256 entries, one unit
N_SMALL, SMALL_DEGREES = 1 << 16, (1, 6, 16, 24, 64, 300)  # kernel 1: teams of 2-32 lanes, hub rows
N_HUB_TC, HUB_LEN_TC = 1 << 17, 1 << 16
N_MXM, DEG_MXM, SEED_MXM = 1 << 13, 16, 5  # bench_suite.py:528 mxm_mprod_s
MXM_CHAIN = 6  # bench_suite.py:541 mreps
SIDE_BFS, SIDE_SSSP, SEED_ROAD = 1024, 512, 9  # bench_suite.py:226,323,326
SIDE_BIG = 3072  # bench_suite.py:269-319 road_big_bfs_gteps
N_SKEW = 1 << 18  # bench_suite.py:441-448 skewed_spmv_gbps / skewed_bfs_gteps
CHECK_LEVELS = 60  # levels of each run that phase 3 holds against the plain versions
N_CLI_SMALL = 2000  # the pr and tc CLIs' graph: their naive oracles are Python loops
N_FACADE, DEG_FACADE, SEED_FACADE = 1 << 18, 8, 7  # bench_suite.py:355-356 facade_chain_ratio
FACADE_CHAIN = 10  # bench_suite.py:371 CH
FACADE_PAIRS = 7  # interleaved facade / functional chain pairs; the ratio is of their medians
FACADE_HOST_CALLS = 50  # calls whose host time gives one vxm's host cost
PI_TOL = 0.01  # pi at 10^6 samples: about 6 standard errors
SIDE_CONVERT = 512
TIMED_RUNS = 20
DIST_RANKS = 4  # the gloo world on cuda:0 (part b of the dist slice)
DEVICE_MS = {}  # kernel: its device time, where measured apart from the eager time
PLAIN_RUNS_BIG = 3  # the plain SpGEMM-T at n = 2^20 expands 285M products per call
PLAIN_RUNS_ROAD = 2  # kernel 6's plain versions read the host once per level
PROBE_ITERS = 20
AB_ITERS = 50
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_S = 67e12  # H100 SXM f32 outside the tensor cores (NVIDIA data sheet)
ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"

MULS = ("PLUS", "MULT", "FIRST", "SECOND", "MIN", "MAX")
ADDS = ("PLUS", "MIN", "MAX")
KERNELS = {
    "spmv_pull": ("cuda", "spla_tpu_torch/kernels/csrc/spmv_pull.cu", "spla_tpu/pallas/spmv.py:2055"),
    "spmv_push": ("cuda", "spla_tpu_torch/kernels/csrc/spmv_push.cu", "spla_tpu/pallas/spmv.py:2346"),
    "level_update": ("cuda", "spla_tpu_torch/kernels/csrc/level_update.cu", "spla_tpu/pallas/spmv.py:2789"),
    # the push levels: kernel 2's push fused with kernel 3's update, the counterparts of the
    # sparse grid of fused_spmv2d_adaptive followed by the chunk-sparse level updates
    "bfs_push_level": ("cuda", "spla_tpu_torch/kernels/csrc/spmv_push.cu", "spla_tpu/pallas/spmv.py:2925"),
    "sssp_push_level": ("cuda", "spla_tpu_torch/kernels/csrc/spmv_push.cu", "spla_tpu/pallas/spmv.py:2858"),
    "mxmt_reduce": ("cuda", "spla_tpu_torch/kernels/csrc/mxmt.cu", "spla_tpu/pallas/mxmt.py:335"),
    "mxmt_masked": ("cuda", "spla_tpu_torch/kernels/csrc/mxmt.cu", "spla_tpu/pallas/mxmt.py:362"),
    # a diagnostic with no TPU counterpart: kernels 4 and 5's walk with no probe of A,
    # the floor of their gathers (it bounds mxmt_reduce and mxmt_masked)
    "mxmt_gather": ("cuda", "spla_tpu_torch/kernels/csrc/mxmt.cu", None),
    "spgemm_mxm": ("cuda", "spla_tpu_torch/kernels/csrc/spgemm.cu", "spla_tpu/pallas/spmv.py:2055"),
    "bfs_resident": ("cuda", "spla_tpu_torch/kernels/csrc/resident.cu", "spla_tpu/pallas/spmv.py:2709"),
    "sssp_resident": ("cuda", "spla_tpu_torch/kernels/csrc/resident.cu",
                      "spla_tpu/pallas/spmv.py:2716"),
    "spmv_pull_staged": ("cuda", "spla_tpu_torch/kernels/csrc/spmv_staged.cu",
                         "spla_tpu/pallas/spmv.py:2140"),
    # kernel 8's phases, each against the TPU probe it answers for
    **{f"spmv_probe_{phase}": ("cuda", "spla_tpu_torch/kernels/csrc/spmv_probe.cu", f"tools/probe_spmv.py:{line}")
       for phase, line in (("stream", 121), ("gather", 146), ("fullfix", 109), ("alu", 176), ("xgather", 190),
                           ("ring_copy", 248), ("ring_alu", 248), ("ring_copy_alu", 248), ("warp_row", 99),
                           ("flat_stream", 498), ("flat_gather", 146), ("ring_fold", 248))},
}
# the kernels each slice of phase 4 must launch, each kernel's row from the first slice naming it
PATHS = {"spmv": ("spmv_pull", "level_update", "bfs_push_level", "sssp_push_level"),
         "push": ("spmv_push",), "skewed": ("bfs_push_level", "sssp_push_level", "level_update"),
         "spgemm": ("mxmt_reduce", "mxmt_masked"), "road": ("bfs_resident", "sssp_resident"),
         "staged": ("spmv_pull_staged",),
         "probes": (*(f"spmv_probe_{phase}" for phase in PROBE_PHASES), "mxmt_gather"),
         "mxm": ("spgemm_mxm",), "facade": ("spmv_pull", "spgemm_mxm", "mxmt_masked"),
         "dist": ("spmv_pull", "mxmt_reduce")}


def phase(title):
    print(f"== {title}", flush=True)


# ---------------------------------------------------------------- graphs


def csr(indptr, rows, cols, vals, n, fill=0):
    return csr_from_numpy((n, n), indptr, cols, vals, rows, rows.size, fill, DEVICE)


def signed_mask(a, dtype, seed):
    """a's pattern with values drawn from {-1, 1, 2}: GTZERO deselects a third."""
    m = a.copy()
    m.data = np.random.default_rng(seed).choice([-1, 1, 2], a.nnz).astype(dtype)
    return F.csr_from_scipy(m, device=DEVICE)


def valued(a, seed, lo, hi):
    """(f32, i32) CSR of a's pattern with values uniform in [lo, hi) and
    integers in [-1000, 1000)."""
    rng = np.random.default_rng(seed)
    f, i = a.copy().astype(np.float32), a.copy().astype(np.int32)
    f.data = rng.uniform(lo, hi, a.nnz).astype(np.float32)
    i.data = rng.integers(-1000, 1000, a.nnz, dtype=np.int32)
    return F.csr_from_scipy(f, device=DEVICE), F.csr_from_scipy(i, device=DEVICE)


# ---------------------------------------------------------------- checks


def check_close(what, got, ref, exact, ref64=None):
    """int, bool, MIN, MAX and structural results: bitwise (NaN equal to NaN).
    f32 PLUS: within rtol=1e-5 of a float64 reference, atol = 1e-6 max|ref|
    (the summation order differs).  Returns the max abs error against ``ref``."""
    if exact:
        torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True, msg=what)
        return 0.0
    nan = torch.isnan(ref64)
    if not torch.equal(torch.isnan(got), nan):
        raise AssertionError(f"{what}: NaN positions differ")
    fin = torch.isfinite(ref64)
    if not torch.equal(got[~fin & ~nan].double(), ref64[~fin & ~nan]):
        raise AssertionError(f"{what}: infinite entries differ")
    atol = 1e-6 * float(ref64[fin].abs().max()) if bool(fin.any()) else 0.0
    err = (got[fin].double() - ref64[fin]).abs()
    bad = err > 1e-5 * ref64[fin].abs() + atol
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} entries off, max err {float(err.max())}")
    d = (got[fin] - ref[fin]).abs()
    return float(d.max()) if d.numel() else 0.0


def as64(M):
    return replace(M, values=M.values.double(), fill=M.fill.double())


def check_pull(label, M, x, op_mul, op_add, init, x_valid, row_sel, swap=False):
    got, has = K1.spmv_pull(M, x, op_mul, op_add, init, x_valid, row_sel, want_has=True, swap=swap)
    ref, ref_has = K1.spmv_pull_plain(M, x, op_mul, op_add, init, x_valid, row_sel, swap)
    if not torch.equal(has, ref_has):
        raise AssertionError(f"{label}: has differs")
    exact = M.values.dtype != torch.float32 or op_add.name != "PLUS"
    ref64 = None
    if not exact:
        ref64, _ = K1.spmv_pull_plain(as64(M), x.double(), op_mul, op_add, float(init),
                                      x_valid, row_sel, swap)
    return check_close(label, got, ref, exact, ref64)


def plan_line(M):
    plan = K1.pull_plan(M)
    return (f"team of {plan.team} lanes, {plan.nhub} hub rows (> {K1.HUB_LEN} entries) in "
            f"{plan.nchunks} chunks")


def check_pull_graph(label, M, Mi, rng):
    """Kernel 1 on one graph: all 36 (mul, add, dtype) instances with no
    masks, with both masks, and with both masks and swapped operands; the
    structural variant with and without row_sel.  Returns the max error."""
    n = M.shape[1]
    x = torch.from_numpy(rng.random(n, dtype=np.float32)).to(DEVICE)
    x[7], x[11], x[13] = float("nan"), float("inf"), float("-inf")
    xi = torch.from_numpy(rng.integers(-1000, 1000, n, dtype=np.int32)).to(DEVICE)
    x_valid = torch.from_numpy(rng.random(n) < 0.9).to(DEVICE)
    row_sel = torch.from_numpy(rng.random(M.shape[0]) < 0.7).to(DEVICE)
    err = 0.0
    for dtype, A, xx in (("f32", M, x), ("i32", Mi, xi)):
        T = op.FLOAT if dtype == "f32" else op.INT
        for mul in MULS:
            for add in ADDS:
                om, oa = getattr(T, mul), getattr(T, add)
                for xv, rs, swap in ((None, None, False), (x_valid, row_sel, False), (x_valid, row_sel, True)):
                    what = f"spmv_pull {label} {mul}/{add} {dtype} masks={xv is not None} swap={swap}"
                    err = max(err, check_pull(what, A, xx, om, oa, oa.identity, xv, rs, swap))
    sparse_valid = x > 0.999  # few hits: rows are walked to their end
    for xv, rs in ((x_valid, None), (x_valid, row_sel), (sparse_valid, row_sel)):
        check_close(f"spmv_pull {label} structural", K1.spmv_pull_structural(M, xv, rs),
                    K1.spmv_pull_structural_plain(M, xv, rs), True)
    print(f"kernel 1 on {label} (n={M.shape[0]}, nnz={int(M.nnz)}; {plan_line(M)}): 36 (mul, add, dtype) "
          f"instances x 3 mask/order settings and the structural variant match the plain version",
          flush=True)
    return err


def check_kernels(G):
    errs = {k: 0.0 for k in KERNELS}
    rng = np.random.default_rng(5)
    graphs = [("n=2^21", "M", "Mi"), ("hub", "H", "Hi"), ("powerlaw", "P", "Pi"),
              *((f"deg {d}", f"S{d}", f"S{d}i") for d in SMALL_DEGREES)]
    for label, f32, i32 in graphs:
        errs["spmv_pull"] = max(errs["spmv_pull"], check_pull_graph(label, G[f32], G[i32], rng))
    teams = {K1.pull_plan(G[f"S{d}"]).team for d in SMALL_DEGREES}
    if teams != {2, 4, 8, 16, 32} or not K1.pull_plan(G[f"S{SMALL_DEGREES[-1]}"]).nhub:
        raise AssertionError(f"the small graphs must pick every team size and hub rows: {teams}")

    # kernel 2 on the traversal graph
    n = N_GRAPH
    A, Ai = G["Aw"], G["Aint"]
    d = torch.from_numpy(rng.uniform(0, 10, n).astype(np.float32)).to(DEVICE)
    di = torch.from_numpy(rng.integers(-1000, 1000, n, dtype=np.int32)).to(DEVICE)
    for k in (1, 1000, n // 20):
        front = torch.from_numpy(np.sort(rng.choice(n, k, replace=False)).astype(np.int32)).to(DEVICE)
        check_close(f"spmv_push OR k={k}", K2.spmv_push_structural(A, front),
                    K2.spmv_push_structural_plain(A, front), True)
        check_close(f"spmv_push MIN-plus k={k}",
                    K2.spmv_push(A, front, d, op.PLUS_FLOAT, op.MIN_FLOAT, float("inf")),
                    K2.spmv_push_plain(A, front, d, op.PLUS_FLOAT, op.MIN_FLOAT, float("inf")), True)
        if k == 1000:
            for dtype, M, xx in (("f32", A, d), ("i32", Ai, di)):
                T = op.FLOAT if dtype == "f32" else op.INT
                for mul in MULS:
                    for add in ("MIN", "MAX"):
                        om, oa = getattr(T, mul), getattr(T, add)
                        check_close(f"spmv_push {mul}/{add} {dtype}",
                                    K2.spmv_push(M, front, xx, om, oa, oa.identity),
                                    K2.spmv_push_plain(M, front, xx, om, oa, oa.identity), True)
        print(f"kernel 2: frontier of {k}: OR and MIN-plus match"
              + (", and all 24 (mul, MIN|MAX, dtype) instances" if k == 1000 else ""), flush=True)

    # kernel 3
    hits = torch.from_numpy(rng.random(n) < 0.1).to(DEVICE)
    v0 = torch.from_numpy(np.where(rng.random(n) < 0.5, 0, rng.integers(1, 6, n)).astype(np.int32))
    front0 = torch.from_numpy((v0.numpy() == 0) & (rng.random(n) < 0.05))
    outs = []
    for fn in (K3.bfs_level_update, K3.bfs_level_update_plain):
        v, f = v0.clone().to(DEVICE), front0.clone().to(DEVICE)
        lst = torch.empty(n, dtype=torch.int32, device=DEVICE)
        cnt = torch.zeros(1, dtype=torch.int32, device=DEVICE)
        fn(hits, v, f, 6, lst, cnt)
        outs.append((v, f, int(cnt), torch.sort(lst[: int(cnt)]).values))
    for a, b, name in zip(outs[0], outs[1], ("v", "front", "count", "list")):
        check_close(f"bfs_level_update {name}", torch.as_tensor(a), torch.as_tensor(b), True)
    hv = torch.from_numpy(np.where(rng.random(n) < 0.7, np.inf, rng.uniform(0, 10, n)).astype(np.float32))
    sv = torch.from_numpy(np.where(rng.random(n) < 0.3, np.inf, rng.uniform(0, 10, n)).astype(np.float32))
    outs = []
    for fn in (K3.sssp_level_update, K3.sssp_level_update_plain):
        v, ch = sv.clone().to(DEVICE), torch.zeros(n, dtype=torch.bool, device=DEVICE)
        lst = torch.empty(n, dtype=torch.int32, device=DEVICE)
        cnt = torch.zeros(1, dtype=torch.int32, device=DEVICE)
        fn(hv.to(DEVICE), v, ch, lst, cnt)
        outs.append((v, ch, int(cnt), torch.sort(lst[: int(cnt)]).values))
    for a, b, name in zip(outs[0], outs[1], ("v", "changed", "count", "list")):
        check_close(f"sssp_level_update {name}", torch.as_tensor(a), torch.as_tensor(b), True)
    print(f"kernel 3: BFS and SSSP updates match (count {outs[0][2]})", flush=True)
    return errs


def plain_level(kind, S, At, push):
    """One level of the level loop by the plain versions alone (on the card)."""
    inf = float("inf")
    if kind == "bfs":
        if push:
            K2.bfs_push_level_plain(S)
        else:
            K3.bfs_pull_update_plain(S, K1.spmv_pull_structural_plain(At, S.mask, S.v == 0))
    elif push:
        K2.sssp_push_level_plain(S)
    else:
        hits, _ = K1.spmv_pull_plain(At, S.v, op.PLUS_FLOAT, op.MIN_FLOAT, inf, x_valid=S.mask)
        K3.sssp_pull_update_plain(S, hits)


def same_state(what, S, R):
    """A level's state on the kernels' run S against the plain run R: v and
    the mask bitwise, the next list as a set, its size word, and S's degree
    offsets those of its own list order."""
    check_close(f"{what} v", S.v, R.v, True)
    check_close(f"{what} mask", S.mask, R.mask, True)
    KF.read_count(S), KF.read_count(R)
    if (S.k, S.edges) != (R.k, R.edges):
        raise AssertionError(f"{what}: list of {S.k} vertices, {S.edges} edges; plain {R.k}, {R.edges}")
    cur = S.level % 2
    lst = S.lists[cur, :S.k]
    check_close(f"{what} list", torch.sort(lst).values, torch.sort(R.lists[cur, :R.k]).values, True)
    eoff, total = KF.degree_offsets(S.A.indptr, lst)
    check_close(f"{what} offsets", S.eoff[cur, :S.k], eoff, True)
    if total != S.edges:
        raise AssertionError(f"{what}: offsets sum to {total}, the size word says {S.edges}")


def check_push_levels(G):
    """The push levels (kernel 2's push fused with kernel 3's update) and the
    pull levels' stream update against their plain versions, level by level,
    for the first CHECK_LEVELS levels of BFS and SSSP runs on the n = 2^20
    random graph, the road grids and the skewed graph (from its longest
    row, so that a hub row is in the frontier): two levels of three push,
    the third pulls, so that each kind of level hands over to the other."""
    levels = {"bfs_push_level": 0, "sssp_push_level": 0}
    for label, kind, A, source in (("random", "bfs", G["Aint"], 0), ("random", "sssp", G["Aw"], 0),
                                   ("road", "bfs", G["Road"], 0), ("road", "sssp", G["RoadW"], 0),
                                   ("skewed", "bfs", G["Skew"], G["skew_hub"]),
                                   ("skewed", "sssp", G["Skew"], G["skew_hub"])):
        At = alg._default_At(A)
        make = KF.bfs_state if kind == "bfs" else KF.sssp_state
        step = alg.bfs_level if kind == "bfs" else alg.sssp_level
        S, R = make(A, source), make(A, source)
        level = pushed = 0
        while S.k > 0 and level < CHECK_LEVELS:
            push = level % 3 != 2
            step(S, At, push)
            plain_level(kind, R, At, push)
            same_state(f"{label} {kind} level {level}", S, R)
            pushed += push
            level += 1
        levels[f"{kind}_push_level"] += pushed
        print(f"{kind} on {label} from {source}: {level} levels ({pushed} push) equal their plain "
              f"versions: depths or distances, mask, list, size word and offsets", flush=True)
    print(f"push levels held against their plain versions: {levels}", flush=True)
    return {k: 0.0 for k in levels}


def check_resident(G):
    """Kernel 6 against its plain versions at full size: on the road grids
    from vertex 0 and from the far corner, on the barbell graph (rounds on
    the lead cluster and on the whole grid, in turn) and on
    random_graph(2^18, 16) from vertex 0 (most rounds wide): results
    bitwise, BFS stats (rounds, capped, wide rounds) equal, SSSP's cap
    flags clear and its rounds at most the plain version's (its rounds see
    decreases made earlier in the same round).  On the path graph (4,096
    rounds of one vertex, which the plain versions read one by one on the
    host) against its closed form: depths arange + 1, distances the f32
    running sums of its weights, no wide round."""
    errs = {"bfs_resident": 0.0, "sssp_resident": 0.0}
    runs = [("road", "Road", "RoadW", (0, -1)), ("barbell", "Barbell", "Barbell", (0,)),
            ("random 2^18", "Rand18", "Rand18", (0,))]
    for label, bfs_key, sssp_key, sources in runs:
        for kind, M, fn, plain in (("bfs", G[bfs_key], K6.bfs_resident, K6.bfs_resident_plain),
                                   ("sssp", G[sssp_key], K6.sssp_resident, K6.sssp_resident_plain)):
            n = M.shape[0]
            for src in (i % n for i in sources):
                got, stats = fn(M, src)
                ref, ref_stats = plain(M, src)
                check_close(f"{kind}_resident {label} from {src}", got, ref, True)
                k_rounds, k_capped, k_wide = stats.tolist()
                p_rounds, p_capped, p_wide = ref_stats.tolist()
                bad = k_capped or p_capped or k_rounds > p_rounds or k_wide > k_rounds
                if kind == "bfs" and stats.tolist() != ref_stats.tolist():
                    bad = True
                if bad:
                    raise AssertionError(f"{kind}_resident {label} from {src}: stats {stats.tolist()}, "
                                         f"plain {ref_stats.tolist()}")
                if label == "barbell" and not 0 < k_wide < k_rounds:
                    raise AssertionError(f"{kind}_resident barbell: {k_wide} wide rounds of {k_rounds}")
                print(f"kernel 6 ({kind}) {label} n={n} from {src} ({K6.resident_plan(M)}): equal to the "
                      f"plain version bitwise; {k_rounds} rounds, {k_wide} wide (plain {p_rounds}, "
                      f"{p_wide})", flush=True)
    P, w = G["Path"], G["PathW"]
    n = P.shape[0]
    v, v_stats = K6.bfs_resident(P, 0)
    d, d_stats = K6.sssp_resident(P, 0)
    check_close("bfs_resident path", v, torch.arange(1, n + 1, dtype=torch.int32, device=DEVICE), True)
    want = torch.from_numpy(np.concatenate([[0], np.cumsum(w)]).astype(np.float32)).to(DEVICE)
    check_close("sssp_resident path", d, want, True)
    if v_stats.tolist() != [n, 0, 0] or d_stats.tolist() != [n, 0, 0]:
        raise AssertionError(f"kernel 6 on the path: stats {v_stats.tolist()}, {d_stats.tolist()}")
    print(f"kernel 6 path n={n}: depths arange + 1 and distances the f32 running sums, {n} rounds, "
          f"none wide", flush=True)
    return errs


def check_masked(label, mask, A, om, oa, sel, struct_only=False):
    got, has = K45.mxmt_masked(mask, A, A, om, oa, oa.identity, sel, struct_only)
    ref, ref_has = K45.mxmt_masked_plain(mask, A, A, om, oa, oa.identity, sel, struct_only)
    if not torch.equal(has, ref_has):
        raise AssertionError(f"{label}: has differs")
    exact = struct_only or A.values.dtype != torch.float32 or oa.name != "PLUS"
    ref64 = None
    if not exact:
        ref64, _ = K45.mxmt_masked_plain(mask, as64(A), as64(A), om, oa, 0.0, sel)
    return check_close(label, got, ref, exact, ref64)


def check_reduce(label, mask, A, om, sel, struct_only=False):
    """Kernel 4 against its plain version: int64 totals bitwise, float64
    totals (of the same f32 products, added in another order) within
    check_close's tolerance."""
    got = K45.mxmt_reduce(mask, A, A, om, sel, struct_only).reshape(1)
    ref = K45.mxmt_reduce_plain(mask, A, A, om, sel, struct_only).reshape(1)
    exact = ref.dtype == torch.int64
    return check_close(label, got, ref, exact, None if exact else ref)


def mxmt_plan_line(mask, B):
    p = K45.mxmt_plan(mask, B)
    return (f"teams of {K45.TEAM} lanes, {-(-p.stored // K45.WINDOW)} windows of {K45.WINDOW} stored entries, "
            f"{p.nhub} entries whose B row is over {K45.HUB_LEN} in {p.nchunks} chunks of at most "
            f"{K45.HUB_CHUNK}")


def mxmt_resources(mode, dtype, mul, add):
    """ptxas' registers and shared memory of one csrc/mxmt.cu instance
    (mxmt_kernel<mode, dtype, mul, add>; dtype "i" or "f"), from the build
    log."""
    ints = [f"Li{'n' if v < 0 else ''}{abs(v)}E" for v in (mode, mul, add)]
    name, found = f"mxmt_kernelI{ints[0]}{dtype}{''.join(ints[1:])}E", False
    for line in build_log().splitlines():
        if "Compiling entry function" in line:
            found = name in line
        elif found and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            return f"{regs} registers, {smem.group(1) if smem else 0} bytes of shared memory"
    raise AssertionError(f"{name} not in the build log")


def check_mxmt(G):
    """Kernels 5 and 4, every instance, on the SpGEMM graph (n = 2^15) with a
    mask that GTZERO partly deselects, and on the hub graph; the structural
    instances with every stored entry selected (no selection) too.  Prints
    each plan and the registers of the instances timed in phase 6."""
    errs = {"mxmt_reduce": 0.0, "mxmt_masked": 0.0, "mxmt_gather": 0.0}
    for graph in ("T", "HT"):
        for dtype in ("f32", "i32"):
            T = op.FLOAT if dtype == "f32" else op.INT
            A, mask = G[f"{graph}w_{dtype}"], G[f"{graph}m_{dtype}"]
            sel = T.GTZERO(mask.values) & mask.valid_mask()
            valid = mask.valid_mask()
            for add in ADDS:
                oa = getattr(T, add)
                for mul in MULS:
                    e = check_masked(f"mxmt_masked {graph} {mul}/{add} {dtype}", mask, A,
                                     getattr(T, mul), oa, sel)
                    errs["mxmt_masked"] = max(errs["mxmt_masked"], e)
                check_masked(f"mxmt_masked {graph} structural/{add} {dtype}", mask, A, None, oa,
                             valid, struct_only=True)
                got = K45.mxmt_masked(mask, A, A, None, oa, oa.identity, None, True)
                for g, r, name in zip(got, K45.mxmt_masked(mask, A, A, None, oa, oa.identity, valid, True),
                                      ("out", "has")):
                    check_close(f"mxmt_masked {graph} structural/{add} {dtype} no selection {name}", g, r, True)
            for mul in MULS:
                e = check_reduce(f"mxmt_reduce {graph} {mul} {dtype}", mask, A, getattr(T, mul), sel)
                errs["mxmt_reduce"] = max(errs["mxmt_reduce"], e)
        mask, A = G[f"{graph}m_i32"], G[f"{graph}w_i32"]
        check_reduce(f"mxmt_reduce {graph} structural", mask, A, None, mask.valid_mask(), struct_only=True)
        check_close(f"mxmt_reduce {graph} structural no selection",
                    K45.mxmt_reduce(mask, A, A, None, struct_only=True).reshape(1),
                    K45.mxmt_reduce_plain(mask, A, A, None, struct_only=True).reshape(1), True)
        for values in (True, False):
            check_close(f"mxmt_gather {graph} values={values}", K8.mxmt_gather(mask, A, values),
                        K8.mxmt_gather_plain(mask, A, values), True)
        what = (f"n={N_TC} degree {DEG_TC}" if graph == "T"
                else f"hub graph n={N_HUB_TC}, {HUB_ROWS} rows of {HUB_LEN_TC} drawn columns")
        print(f"kernels 4 and 5 on the {what} (plan: {mxmt_plan_line(mask, A)}): 36 + 6 structural "
              f"instances of kernel 5 and 12 + 1 of kernel 4 match the plain versions, and the gather floor "
              f"its plain version", flush=True)
    for label, mask in (("tc n=2^15", G["T"]), ("tc n=2^20", G["Aint"])):
        print(f"kernels 4 and 5 plan on {label}: {mxmt_plan_line(mask, mask)}", flush=True)
    for what, key in (("kernel 4 structural", (0, "i", -1, 0)), ("kernel 4 MULT i32", (0, "i", 1, 0)),
                      ("kernel 5 MULT/PLUS i32", (1, "i", 1, 0)), ("gather, values", (2, "i", 0, 0))):
        print(f"{what}: {mxmt_resources(*key)}", flush=True)
    return errs


def mxm_plan_line(A, B):
    p = K9.mxm_plan(A, B)
    n = B.shape[1]
    sms = torch.cuda.get_device_properties(A.values.device).multi_processor_count
    cluster, width, windows = K9.cluster_shape(n, sms, K9.LARGE_SHARED_BYTES)
    tables = dict(zip(K9.MEDIUM_SLOTS, p.medium_counts))
    return (f"{p.products} products; {p.nsmall} small rows (a warp, <= {K9.SMALL_MAX} products), "
            f"{p.nmedium} medium (a CTA of 512 threads, <= {K9.MEDIUM_MAX}; by table size "
            f"{tables}; {K9.radix_passes(n)} radix passes), {p.nlarge} large (clusters of {cluster} CTAs, "
            f"{width} columns a CTA, {windows} windows of {cluster * width}; symbolic bitmaps of "
            f"{min((n + 31) // 32, K9.LARGE_WORDS)} words)")


def same_mxm(label, got, ref, exact, ref64=None):
    """Kernel 9's C against a reference C: structure (indptr, columns, rows,
    nnz, capacity) bitwise, values by check_close.  Returns the max abs
    error of the values against ``ref``."""
    if got.capacity != ref.capacity:
        raise AssertionError(f"{label}: capacity {got.capacity}, want {ref.capacity}")
    for f in ("indptr", "cols", "row_ids", "nnz"):
        check_close(f"{label} {f}", getattr(got, f), getattr(ref, f), True)
    return check_close(f"{label} values", got.values, ref.values, exact, ref64)


def check_mxm_pair(label, A, B, om, oa, init, ref64=None):
    """Kernel 9 on (A, B) against its plain version; f32 PLUS within
    check_close's tolerance of ``ref64`` (default: the plain version over
    float64 values)."""
    got = K9.mxm(A, B, om, oa, init)
    ref = K9.mxm_plain(A, B, om, oa, init)
    exact = A.values.dtype != torch.float32 or oa.name != "PLUS"
    if not exact and ref64 is None:
        ref64 = K9.mxm_plain(as64(A), as64(B), om, oa, float(init)).values
    return same_mxm(label, got, ref, exact, ref64), got, ref


def check_mxm(G):
    """Kernel 9 against its plain version: every instance on
    graphs.spgemm_bins, and two f32 adds there with init NaN (which
    the large bin must not keep for an untouched column); MULT/PLUS f32
    on the mxm_mprod_s graph (also
    against scipy), the n = 2^20 graph and the skewed graph; PLUS/MIN f32
    with init +inf and the three i32 adds on the 2^13 graph; ±1 i32 sums
    that cancel.  Keeps the n = 2^20 plain result for phase 4."""
    err = 0.0
    A, B = G["Bins_f32"]
    Ai, Bi = G["Bins_i32"]
    print(f"kernel 9 plan on graphs.spgemm_bins(): {mxm_plan_line(A, B)}", flush=True)
    for dtype, (X, Y) in (("f32", (A, B)), ("i32", (Ai, Bi))):
        T = op.FLOAT if dtype == "f32" else op.INT
        for add in ADDS:
            oa = getattr(T, add)
            for mul in MULS:
                e, _, _ = check_mxm_pair(f"mxm bins {mul}/{add} {dtype}", X, Y, getattr(T, mul), oa, oa.identity)
                err = max(err, e)
    for om, oa in ((op.PLUS_FLOAT, op.MIN_FLOAT), (op.MULT_FLOAT, op.PLUS_FLOAT)):  # only reached columns kept
        check_mxm_pair(f"mxm bins {om.name}/{oa.name} f32 init NaN", A, B, om, oa, float("nan"))
    print("kernel 9: all 36 instances match the plain version on graphs.spgemm_bins (small, medium and "
          "large rows), and PLUS/MIN and MULT/PLUS f32 with init NaN", flush=True)
    A, B = G["Bins20_f32"]
    print(f"kernel 9 plan on graphs.spgemm_bins(2^20): {mxm_plan_line(A, B)}", flush=True)
    err = max(err, check_mxm_pair("mxm bins n=2^20 MULT/PLUS f32", A, B, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)[0])
    Ai, Bi = G["Bins20_i32"]
    check_mxm_pair("mxm bins n=2^20 PLUS/MIN i32", Ai, Bi, op.PLUS_INT, op.MIN_INT, np.iinfo(np.int32).max)
    print("kernel 9 on graphs.spgemm_bins(2^20): MULT/PLUS f32 and PLUS/MIN i32 match the plain version",
          flush=True)
    M = G["MX13"]
    print(f"kernel 9 plan on random_graph(2^13, 16, seed={SEED_MXM}): {mxm_plan_line(M, M)}", flush=True)
    ref = (G["MX13_sp"].astype(np.float64) @ G["MX13_sp"].astype(np.float64)).tocsr()
    ref.sort_indices()
    e, got, _ = check_mxm_pair("mxm n=2^13 MULT/PLUS f32", M, M, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0,
                               torch.from_numpy(ref.data).to(DEVICE))
    err = max(err, e)
    check_close("mxm n=2^13 indptr against scipy", got.indptr.cpu().long(), torch.from_numpy(ref.indptr).long(),
                True)
    check_close("mxm n=2^13 columns against scipy", got.cols.cpu(), torch.from_numpy(ref.indices), True)
    G["MX13_ref"] = ref
    err = max(err, check_mxm_pair("mxm n=2^13 PLUS/MIN f32", G["MX13inf"], G["MX13inf"], op.PLUS_FLOAT,
                                  op.MIN_FLOAT, float("inf"))[0])
    Mi = G["MX13i"]
    for om, oa, init in ((op.MULT_INT, op.PLUS_INT, 0), (op.PLUS_INT, op.MIN_INT, np.iinfo(np.int32).max),
                         (op.PLUS_INT, op.MAX_INT, np.iinfo(np.int32).min)):
        check_mxm_pair(f"mxm n=2^13 {om.name}/{oa.name} i32", Mi, Mi, om, oa, init)
    Mpm = G["MX13pm"]
    _, got, ref = check_mxm_pair("mxm n=2^13 MULT/PLUS ±1 i32", Mpm, Mpm, op.MULT_INT, op.PLUS_INT, 0)
    dropped = got.capacity - int(got.nnz)
    if dropped <= 0:
        raise AssertionError("mxm ±1: no sum cancelled, so no init-valued result was dropped")
    print(f"kernel 9 at n=2^13: MULT/PLUS f32 matches scipy's A @ A ({G['MX13_ref'].nnz} entries); PLUS/MIN "
          f"f32, MULT/PLUS, PLUS/MIN and PLUS/MAX i32 match the plain version bitwise; ±1 i32 drops {dropped} "
          f"init-valued sums of {got.capacity}", flush=True)
    for label, M in (("n=2^20", G["Aw"]), ("skewed", G["Skew"])):
        print(f"kernel 9 plan on the {label} graph: {mxm_plan_line(M, M)}", flush=True)
        got = K9.mxm(M, M, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
        ref = K9.mxm_plain(M, M, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
        err = max(err, same_mxm(f"mxm {label} MULT/PLUS f32", got, ref, False, ref.values.double()))
        print(f"kernel 9 on the {label} graph: C of {int(got.nnz)} entries matches the plain version", flush=True)
        if label == "n=2^20":
            G["mxm_big_plain"] = ref
        del got, ref
    return {"spgemm_mxm": err}


def check_staged(G):
    """Kernel 7 against its plain version and kernel 1: all 18 f32 (mul,
    add) instances, both operand orders, with and without masks, and the
    structural variant, on kernel 1's graphs: at 2, 3 and 4 slots on the
    n = 2^21 graph, the hub graph (rows of 2^17 entries, 32 chunks each), a
    graph of one stage (fewer stages than slots) and the n = 2^16 graphs of
    degrees 1 to 300, at the default slots on the powerlaw graph; a
    repeated call gives the same bits.  Then each kernel-8 phase against
    its plain version on the n = 2^21 graph (f32 sums within rtol 1e-5, XOR
    checksums bitwise)."""
    errs = {"spmv_pull_staged": 0.0}
    rng = np.random.default_rng(10)
    if K7.staged_plan(G["Few"]).nunits != 1:
        raise AssertionError("the fewer-stages graph must be one unit")
    default = (K7.resolve_slots(None),)
    graphs = [("M", K7.SLOT_COUNTS), ("H", K7.SLOT_COUNTS), ("Few", K7.SLOT_COUNTS), ("P", default),
              *((f"S{d}", K7.SLOT_COUNTS) for d in SMALL_DEGREES)]
    for gname, slot_counts in graphs:
        M = G[gname]
        n = M.shape[0]
        x = torch.from_numpy(rng.random(n, dtype=np.float32)).to(DEVICE)
        x[7], x[11], x[13] = float("nan"), float("inf"), float("-inf")
        x_valid = torch.from_numpy(rng.random(n) < 0.9).to(DEVICE)
        row_sel = torch.from_numpy(rng.random(n) < 0.7).to(DEVICE)
        for mul in MULS:
            for add in ADDS:
                om, oa = getattr(op.FLOAT, mul), getattr(op.FLOAT, add)
                exact = add != "PLUS"
                for xv, rs, swap in ((None, None, False), (x_valid, row_sel, True)):
                    label = f"spmv_pull_staged {gname} {mul}/{add} masks={xv is not None}"
                    ref, ref_has = K7.spmv_pull_staged_plain(M, x, om, oa, oa.identity, xv, rs, swap)
                    k1, k1_has = K1.spmv_pull(M, x, om, oa, oa.identity, xv, rs, want_has=True, swap=swap)
                    ref64 = None if exact else K7.spmv_pull_staged_plain(
                        as64(M), x.double(), om, oa, float(oa.identity), xv, rs, swap)[0]
                    for slots in slot_counts:
                        got, has = K7.spmv_pull_staged(M, x, om, oa, oa.identity, xv, rs, want_has=True,
                                                       swap=swap, slots=slots)
                        if not (torch.equal(has, ref_has) and torch.equal(has, k1_has)):
                            raise AssertionError(f"{label} slots={slots}: has differs")
                        e = check_close(f"{label} slots={slots}", got, ref, exact, ref64)
                        check_close(f"{label} slots={slots} vs kernel 1", got, k1, exact, ref64)
                        errs["spmv_pull_staged"] = max(errs["spmv_pull_staged"], e)
        first = K7.spmv_pull_staged(M, x, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)[0]
        check_close(f"spmv_pull_staged {gname} repeated",
                    K7.spmv_pull_staged(M, x, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)[0], first, True)
        for slots in slot_counts:
            for xv, rs in ((x_valid, None), (x_valid, row_sel), (x > 0.999, row_sel)):
                hits = K7.spmv_pull_staged_structural(M, xv, rs, slots=slots)
                check_close(f"spmv_pull_staged {gname} structural slots={slots}", hits,
                            K7.spmv_pull_staged_structural_plain(M, xv, rs), True)
                check_close(f"spmv_pull_staged {gname} structural slots={slots} vs kernel 1", hits,
                            K1.spmv_pull_structural(M, xv, rs), True)
        plan = K7.staged_plan(M)
        print(f"kernel 7 on {gname} (n={n}, {plan.nunits} units, {plan.nhub} rows of several chunks): 18 "
              f"(mul, add) instances x 2 mask settings and the structural variant at {slot_counts} slots "
              f"match the plain version and kernel 1; a repeated call gives the same bits", flush=True)
    M = G["M"]
    x = torch.from_numpy(rng.random(M.shape[1], dtype=np.float32)).to(DEVICE)
    for phase in PROBE_PHASES:
        got, ref = K8.spmv_probe(phase, M, x), K8.spmv_probe_plain(phase, M, x)
        err = 0.0
        for g, r in zip(got, ref):
            if (g is None) != (r is None):
                raise AssertionError(f"spmv_probe {phase}: outputs differ in kind")
            if g is None:
                continue
            if g.dtype == torch.int32:
                check_close(f"spmv_probe {phase} checksum", g, r, True)
            else:
                torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5, msg=f"spmv_probe {phase}")
                err = max(err, float((g - r).abs().max()))
        errs[f"spmv_probe_{phase}"] = err
    print(f"kernel 8: the {len(PROBE_PHASES)} phases match their plain versions at n={M.shape[0]}",
          flush=True)
    return errs


# ---------------------------------------------------------------- the slice


def run_slice(G):
    """Phase 4's main-path calls; returns their results."""
    rng = np.random.default_rng(6)
    n = N_SPMV
    x = DenseVec(torch.from_numpy(np.random.default_rng(1).random(n, dtype=np.float32)).to(DEVICE),
                 torch.tensor(0.0, device=DEVICE))
    mask = DenseVec(torch.from_numpy((rng.random(n) < 0.7).astype(np.float32)).to(DEVICE),
                    torch.tensor(0.0, device=DEVICE))
    sparse_vals = np.where(rng.random(n) < 0.05, rng.uniform(0, 10, n), np.inf).astype(np.float32)
    xs = F.dense_to_sparse_vec(DenseVec(torch.from_numpy(sparse_vals).to(DEVICE),
                                        torch.tensor(float("inf"), device=DEVICE)))
    R = {"x": x, "mask": mask, "xs": xs}
    R["mxv"] = mxv_masked(mask, G["M"], x, op.MULT_FLOAT, op.PLUS_FLOAT, op.NQZERO_FLOAT, 0.0)
    R["mxv_minplus"] = mxv_masked(mask, G["Minf"], x, op.PLUS_FLOAT, op.MIN_FLOAT,
                                  op.NQZERO_FLOAT, float("inf"))
    R["vxm_dense"] = vxm_masked_dense(mask, x, G["M"], op.MULT_FLOAT, op.PLUS_FLOAT,
                                      op.NQZERO_FLOAT, 0.0)
    R["vxm"] = vxm_masked(mask, xs, G["Minf"], op.PLUS_FLOAT, op.MIN_FLOAT, op.NQZERO_FLOAT,
                          float("inf"))
    modes = {"default": None, "push_only": Descriptor(push_only=True),
             "pull_only": Descriptor(pull_only=True)}
    for name, d in modes.items():
        R[f"bfs {name}"] = alg.bfs(G["Aint"], 0, d, At=G["Aint"])
        R[f"sssp {name}"] = alg.sssp(G["Aw"], 0, d)
        R[f"pr {name}"] = alg.pr(G["Ap"], 0.85, 1e-6, d)
    torch.cuda.synchronize()
    return R


def check_slice(G, R):
    x, mask, xs = R["x"], R["mask"], R["xs"]
    sel = op.NQZERO_FLOAT
    ref, _ = masked_spmv(G["M"], x.values, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0, mask_vals=mask.values,
                         op_select=sel)
    ref64, _ = masked_spmv(as64(G["M"]), x.values.double(), op.MULT_FLOAT, op.PLUS_FLOAT, 0.0,
                           mask_vals=mask.values, op_select=sel)
    check_close("mxv_masked MULT/PLUS", R["mxv"].values, ref, False, ref64)
    ref, _ = masked_spmv(G["Minf"], x.values, op.PLUS_FLOAT, op.MIN_FLOAT, float("inf"),
                         mask_vals=mask.values, op_select=sel)
    check_close("mxv_masked PLUS/MIN", R["mxv_minplus"].values, ref, True)

    def swapped(f):
        return lambda a, b: f(b, a)

    ref, _ = masked_spmv(G["M"], x.values, swapped(op.MULT_FLOAT), op.PLUS_FLOAT, 0.0,
                         x_valid=x.stored_mask(), mask_vals=mask.values, op_select=sel)
    ref64, _ = masked_spmv(as64(G["M"]), x.values.double(), swapped(op.MULT_FLOAT), op.PLUS_FLOAT,
                           0.0, x_valid=x.stored_mask(), mask_vals=mask.values, op_select=sel)
    check_close("vxm_masked_dense MULT/PLUS", R["vxm_dense"].values, ref, False, ref64)
    xd = F.sparse_to_dense_vec(xs)
    ref, has = masked_spmv(G["Minf"], xd.values, swapped(op.PLUS_FLOAT), op.MIN_FLOAT, float("inf"),
                           x_valid=xd.stored_mask(), mask_vals=mask.values, op_select=sel)
    exp = F.compact(ref, has, N_SPMV, R["vxm"].fill)
    for f in ("indices", "values", "nnz"):
        check_close(f"vxm_masked PLUS/MIN {f}", getattr(R["vxm"], f), getattr(exp, f), True)
    print(f"mxv_masked, vxm_masked_dense, vxm_masked (nnz {int(exp.nnz)}) match the plain path",
          flush=True)

    src = 0
    lev = cg.shortest_path(G["A_sp"], method="D", unweighted=True, indices=src)
    lev_ref = torch.from_numpy(np.where(np.isfinite(lev), lev + 1, 0).astype(np.int32)).to(DEVICE)
    dist_ref = torch.from_numpy(cg.dijkstra(G["Aw_sp"], indices=src)).to(DEVICE)
    G["bfs_ref"], G["sssp_ref"] = lev_ref, dist_ref  # the staged path's oracles
    G["pr_ref64"] = p64 = pr_ref64(G["Ap"], 0.85, 1e-6)  # the staged and dist paths' oracle too
    for name in ("default", "push_only", "pull_only"):
        check_close(f"bfs {name}", R[f"bfs {name}"].values, lev_ref, True)
        check_close(f"bfs {name} = default", R[f"bfs {name}"].values, R["bfs default"].values, True)
        d = R[f"sssp {name}"].values
        check_close(f"sssp {name} = default", d, R["sssp default"].values, True)
        if not torch.equal(torch.isinf(d), torch.isinf(dist_ref)):
            raise AssertionError(f"sssp {name}: unreachable set differs from dijkstra")
        fin = torch.isfinite(dist_ref)
        torch.testing.assert_close(d[fin].double(), dist_ref[fin], rtol=1e-5, atol=0,
                                   msg=f"sssp {name} vs dijkstra")
        err = check_close(f"pr {name}", R[f"pr {name}"].values, p64.float(), False, p64)
    reached = int((lev_ref > 0).sum())
    print(f"bfs: depths equal scipy's shortest_path + 1 in all 3 modes ({reached} reached, "
          f"{int(lev_ref.max())} levels)", flush=True)
    print("sssp: equal to dijkstra within rtol 1e-5 and identical in all 3 modes", flush=True)
    print(f"pr: within rtol 1e-5 of a float64 PageRank in all 3 modes (max abs diff {err:.3g})", flush=True)


def pr_ref64(A, alpha, eps):
    """PageRank in float64 with the plain torch SpMV (the loop of algorithms.pr)."""
    n = A.shape[0]
    A = as64(A)
    p = torch.full((n,), 1.0 / n, dtype=torch.float64, device=DEVICE)
    err, it = eps + 0.1, 0
    while err > eps and it < 10_000:
        ap, _ = masked_spmv(A, p, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
        p_new = ap + (1.0 - alpha) / n
        err = float(torch.sqrt(torch.sum((p_new - p) ** 2)))
        p, it = p_new, it + 1
    return p


def run_spgemm(G):
    """Phase 4's SpGEMM-T calls; returns their results."""
    R = {"tc small": alg.tc(G["T"]), "tc big": alg.tc(G["Aint"])}
    A, W = G["Aint"], G["Aw"]
    R["mxmT"] = mxmT_masked(A, A, A, op.MULT_INT, op.PLUS_INT, op.GTZERO_INT, 0)
    R["mxmT minplus"] = mxmT_masked(W, W, W, op.PLUS_FLOAT, op.MIN_FLOAT, op.GTZERO_FLOAT,
                                    float("inf"))
    torch.cuda.synchronize()
    return R


def same_csr(label, got, ref):
    for f in ("indptr", "cols", "row_ids", "values", "nnz"):
        check_close(f"{label} {f}", getattr(got, f), getattr(ref, f), True)


def check_spgemm(G, R):
    t = G["T_sp"]
    want = int(t.multiply(t @ t).sum())
    if R["tc small"] != want:
        raise AssertionError(f"tc n={N_TC}: {R['tc small']}, scipy's A .* (A @ A) sums to {want}")
    A, W = G["Aint"], G["Aw"]
    ref = mxmT_masked_plain(A, A, A, op.MULT_INT, op.PLUS_INT, op.GTZERO_INT, 0, struct_only=True)
    plain_tc = int(m_reduce(0, ref, op.PLUS_INT).value)
    if R["tc big"] != plain_tc:
        raise AssertionError(f"tc n={N_GRAPH}: {R['tc big']}, the plain path {plain_tc}")
    print(f"tc: {R['tc small']} at n={N_TC} (scipy {want}), {R['tc big']} at n={N_GRAPH} "
          f"(plain path {plain_tc}); triangles x6", flush=True)
    same_csr("mxmT_masked MULT/PLUS i32", R["mxmT"],
             mxmT_masked_plain(A, A, A, op.MULT_INT, op.PLUS_INT, op.GTZERO_INT, 0))
    same_csr("mxmT_masked PLUS/MIN f32", R["mxmT minplus"],
             mxmT_masked_plain(W, W, W, op.PLUS_FLOAT, op.MIN_FLOAT, op.GTZERO_FLOAT, float("inf")))
    print(f"mxmT_masked at n={N_GRAPH}: MULT/PLUS i32 (nnz {int(R['mxmT'].nnz)}) and PLUS/MIN f32 "
          f"(nnz {int(R['mxmT minplus'].nnz)}) equal the plain path bitwise", flush=True)


def run_mxm(G):
    """Phase 4's mxm slice: the public ops.mxm, MULT/PLUS f32, on the
    mxm_mprod_s graph and the n = 2^20 graph (kernel 9), and once with
    products_cap on the 2^13 graph (the torch path)."""
    M = G["MX13"]
    R = {"small": mxm(M, M, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0),
         "big": mxm(G["Aw"], G["Aw"], op.MULT_FLOAT, op.PLUS_FLOAT, 0.0),
         "capped": mxm(M, M, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0, products_cap=K9.mxm_plan(M, M).products)}
    torch.cuda.synchronize()
    return R


def check_mxm_slice(G, R):
    ref = G["MX13_ref"]
    got = R["small"]
    check_close("ops.mxm n=2^13 indptr against scipy", got.indptr.cpu().long(), torch.from_numpy(ref.indptr).long(),
                True)
    check_close("ops.mxm n=2^13 columns against scipy", got.cols.cpu(), torch.from_numpy(ref.indices), True)
    check_close("ops.mxm n=2^13 values against scipy", got.values, got.values, False,
                torch.from_numpy(ref.data).to(DEVICE))
    same_mxm("ops.mxm n=2^13 products_cap (torch path)", R["capped"], got, False,
             torch.from_numpy(ref.data).to(DEVICE))
    plain = G.pop("mxm_big_plain")
    same_mxm("ops.mxm n=2^20", R["big"], plain, False, plain.values.double())
    print(f"ops.mxm: n=2^13 ({int(got.nnz)} entries) equals scipy's A @ A, n=2^20 ({int(R['big'].nnz)} entries) "
          f"the plain version; products_cap took the torch path with the same C", flush=True)


def run_push(G):
    """Phase 4's push slice: kernel 2's public entries at a real frontier,
    the vertices at depth 3 of a BFS from vertex 0 on the n = 2^20 graph
    (the spmv slice's scipy depths)."""
    front = torch.nonzero(G["bfs_ref"] == 3).flatten().to(torch.int32)
    d = torch.from_numpy(np.random.default_rng(13).uniform(0, 10, N_GRAPH).astype(np.float32)).to(DEVICE)
    R = {"front": front, "d": d,
         "minplus": K2.spmv_push(G["Aw"], front, d, op.PLUS_FLOAT, op.MIN_FLOAT, float("inf")),
         "structural": K2.spmv_push_structural(G["Aw"], front)}
    torch.cuda.synchronize()
    return R


def check_push(G, R):
    front, d = R["front"], R["d"]
    check_close("spmv_push MIN-plus (push slice)", R["minplus"],
                K2.spmv_push_plain(G["Aw"], front, d, op.PLUS_FLOAT, op.MIN_FLOAT, float("inf")), True)
    check_close("spmv_push OR (push slice)", R["structural"], K2.spmv_push_structural_plain(G["Aw"], front),
                True)
    print(f"spmv_push MIN-plus and OR at the depth-3 frontier of {front.numel()} vertices equal the plain "
          f"versions", flush=True)


def run_skewed(G):
    """Phase 4's skewed slice: the level loop where users meet it.  The
    public bfs and sssp on bench_suite's skewed graph (the skew gate keeps
    them off the resident route), in every mode, and bfs on the side-3072
    road grid with the byte budget, which sends it to the level loop."""
    R = {}
    for name, d in (("default", None), ("push_only", Descriptor(push_only=True)),
                    ("pull_only", Descriptor(pull_only=True))):
        R[f"bfs {name}"] = alg.bfs(G["Skew"], 0, d)
        R[f"sssp {name}"] = alg.sssp(G["Skew"], 0, d)
    R["road3072"] = alg.bfs(G["Road3072"], 0, At=G["Road3072"])
    torch.cuda.synchronize()
    return R


def check_skewed(G, R):
    a = G["Skew_sp"]
    lev = cg.shortest_path(a, method="D", unweighted=True, indices=0)
    lev_ref = torch.from_numpy(np.where(np.isfinite(lev), lev + 1, 0).astype(np.int32)).to(DEVICE)
    dist_ref = torch.from_numpy(cg.dijkstra(a, indices=0)).to(DEVICE)
    fin = torch.isfinite(dist_ref)
    for name in ("default", "push_only", "pull_only"):
        check_close(f"skewed bfs {name}", R[f"bfs {name}"].values, lev_ref, True)
        d = R[f"sssp {name}"].values
        check_close(f"skewed sssp {name} = default", d, R["sssp default"].values, True)
        if not torch.equal(torch.isinf(d), ~fin):
            raise AssertionError(f"skewed sssp {name}: unreachable set differs from dijkstra")
        torch.testing.assert_close(d[fin].double(), dist_ref[fin], rtol=1e-5, atol=0,
                                   msg=f"skewed sssp {name} vs dijkstra")
    print(f"skewed bfs: depths equal scipy's in all 3 modes ({int((lev_ref > 0).sum())} reached, "
          f"{int(lev_ref.max())} levels); skewed sssp: dijkstra within rtol 1e-5, identical in all 3 "
          f"modes", flush=True)
    lev = cg.shortest_path(G["Road3072_sp"], method="D", unweighted=True, indices=0)
    check_close("road bfs side 3072, level loop", R["road3072"].values,
                torch.from_numpy((lev + 1).astype(np.int32)).to(DEVICE), True)
    print(f"road bfs side {SIDE_BIG} on the level loop: depths equal scipy's", flush=True)


def run_road(G):
    """Phase 4's road-slice calls: the public bfs and sssp on the road grids,
    which take the resident route."""
    R = {"bfs": alg.bfs(G["Road"], 0, At=G["Road"]), "sssp": alg.sssp(G["RoadW"], 0, At=G["RoadW"])}
    torch.cuda.synchronize()
    return R


@contextlib.contextmanager
def resident_budget(nbytes):
    """``algorithms.RESIDENT_BYTES`` set to ``nbytes`` inside the block (0:
    the level loop)."""
    saved = alg.RESIDENT_BYTES
    alg.RESIDENT_BYTES = nbytes
    try:
        yield
    finally:
        alg.RESIDENT_BYTES = saved


def check_road(G, R):
    lev = cg.shortest_path(G["Road_sp"], method="D", unweighted=True, indices=0)
    lev_ref = torch.from_numpy(np.where(np.isfinite(lev), lev + 1, 0).astype(np.int32)).to(DEVICE)
    check_close("road bfs", R["bfs"].values, lev_ref, True)
    G["road_bfs_ref"] = lev_ref  # the dist slice's oracle
    levels = int(lev_ref.max())
    if levels != 2 * SIDE_BFS - 1:
        raise AssertionError(f"road bfs: {levels} levels, want {2 * SIDE_BFS - 1}")
    d = R["sssp"].values
    dist_ref = torch.from_numpy(cg.dijkstra(G["RoadW_sp"], indices=0)).to(DEVICE)
    if not bool(torch.isfinite(dist_ref).all()) or not bool(torch.isfinite(d).all()):
        raise AssertionError("road sssp: the grid is connected, every distance must be finite")
    torch.testing.assert_close(d.double(), dist_ref, rtol=1e-5, atol=0, msg="road sssp vs dijkstra")
    with resident_budget(0):
        check_close("road bfs = level loop", R["bfs"].values,
                    alg.bfs(G["Road"], 0, At=G["Road"]).values, True)
        check_close("road sssp = level loop", d, alg.sssp(G["RoadW"], 0, At=G["RoadW"]).values, True)
    print(f"road bfs n={G['Road'].shape[0]}: depths equal scipy's shortest_path + 1 ({levels} "
          f"levels) and the level loop; road sssp n={G['RoadW'].shape[0]}: equal to dijkstra "
          f"within rtol 1e-5 and to the level loop bitwise", flush=True)
    run_clis(G)


def write_mtx(path, a):
    coo = a.tocoo()
    MtxLoader(verbose=False, n_rows=a.shape[0], n_cols=a.shape[1], rows=coo.row, cols=coo.col,
              vals=coo.data.astype(np.float64)).save(path)


def run_clis(G):
    """The four example CLIs, side by side, on the card only (--run-cpu
    false), each checked by its naive oracle: bfs and sssp on the side-512
    road grid, pr and tc on a small random graph."""
    with tempfile.TemporaryDirectory() as tmp:
        road, small = Path(tmp) / "road512.mtx", Path(tmp) / "small.mtx"
        write_mtx(road, G["RoadW_sp"])
        write_mtx(small, random_graph(N_CLI_SMALL, 8, seed=11))
        runs = {name: [sys.executable, "-m", f"spla_tpu_torch.examples.{name}", "--mtxpath", str(path),
                       "--run-cpu", "false", "--run-ref", "true", "--niters", "2", "--verbose", "false"]
                for name, path in (("bfs", road), ("sssp", road), ("pr", small), ("tc", small))}
        t0 = time.perf_counter()
        procs = {name: subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True) for name, cmd in runs.items()}
        try:
            outs = {name: p.communicate(timeout=600)[0] for name, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for name, p in procs.items():
        out = outs[name]
        if p.returncode != 0 or "verify acc: OK" not in out:
            raise AssertionError(f"example {name}: exit {p.returncode}\n{out[-3000:]}")
        laps = [line for line in out.splitlines() if line.startswith("acc(ms)")]
        print(f"example {name}: exit 0, verify acc: OK, {laps[0] if laps else ''}", flush=True)
    print(f"the four example CLIs ran in {time.perf_counter() - t0:.1f} s", flush=True)


@contextlib.contextmanager
def manual_dma(on=True):
    """``kernels.staged.MANUAL_DMA`` (what SPLA_MANUAL_DMA=1 sets) inside the block."""
    saved = K7.MANUAL_DMA
    K7.MANUAL_DMA = on
    try:
        yield
    finally:
        K7.MANUAL_DMA = saved


def run_staged(G):
    """Phase 4's staged path: under MANUAL_DMA, mxv_masked at n = 2^21 and
    pr / sssp / bfs on the n = 2^20 graph (the level loop), then ab_spmv
    under SPLA_MANUAL_DMA=1 SPLA_MANUAL_SLOTS=3 in a subprocess."""
    rng = np.random.default_rng(12)
    n = N_SPMV
    x = DenseVec(torch.from_numpy(rng.random(n, dtype=np.float32)).to(DEVICE),
                 torch.tensor(0.0, device=DEVICE))
    mask = DenseVec(torch.from_numpy((rng.random(n) < 0.7).astype(np.float32)).to(DEVICE),
                    torch.tensor(0.0, device=DEVICE))
    R = {"x": x, "mask": mask}
    with manual_dma(), resident_budget(0):
        R["mxv"] = mxv_masked(mask, G["M"], x, op.MULT_FLOAT, op.PLUS_FLOAT, op.NQZERO_FLOAT, 0.0)
        R["mxv_minplus"] = mxv_masked(mask, G["Minf"], x, op.PLUS_FLOAT, op.MIN_FLOAT,
                                      op.NQZERO_FLOAT, float("inf"))
        R["bfs"] = alg.bfs(G["Aint"], 0, At=G["Aint"])
        R["sssp"] = alg.sssp(G["Aw"], 0)
        R["pr"] = alg.pr(G["Ap"], 0.85, 1e-6)
    torch.cuda.synchronize()
    env = dict(os.environ, SPLA_MANUAL_DMA="1", SPLA_MANUAL_SLOTS="3")
    R["ab"] = subprocess.run([sys.executable, "-m", "spla_tpu_torch.tools.ab_spmv", "--manual", "3",
                              "--check", "--iters", str(AB_ITERS)], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=600)
    return R


def check_staged_path(G, R):
    x, mask, sel = R["x"], R["mask"], op.NQZERO_FLOAT
    ref, _ = masked_spmv(G["M"], x.values, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0, mask_vals=mask.values,
                         op_select=sel)
    ref64, _ = masked_spmv(as64(G["M"]), x.values.double(), op.MULT_FLOAT, op.PLUS_FLOAT, 0.0,
                           mask_vals=mask.values, op_select=sel)
    check_close("staged mxv_masked MULT/PLUS", R["mxv"].values, ref, False, ref64)
    ref, _ = masked_spmv(G["Minf"], x.values, op.PLUS_FLOAT, op.MIN_FLOAT, float("inf"),
                         mask_vals=mask.values, op_select=sel)
    check_close("staged mxv_masked PLUS/MIN", R["mxv_minplus"].values, ref, True)
    check_close("staged bfs vs scipy", R["bfs"].values, G["bfs_ref"], True)
    if not torch.equal(torch.isinf(R["sssp"].values), torch.isinf(G["sssp_ref"])):
        raise AssertionError("staged sssp: unreachable set differs from dijkstra")
    fin = torch.isfinite(G["sssp_ref"])
    torch.testing.assert_close(R["sssp"].values[fin].double(), G["sssp_ref"][fin], rtol=1e-5, atol=0,
                               msg="staged sssp vs dijkstra")
    with resident_budget(0):
        check_close("staged bfs = unstaged", R["bfs"].values, alg.bfs(G["Aint"], 0, At=G["Aint"]).values,
                    True)
        check_close("staged sssp = unstaged", R["sssp"].values, alg.sssp(G["Aw"], 0).values, True)
        unstaged = alg.pr(G["Ap"], 0.85, 1e-6).values
    err = check_close("staged pr", R["pr"].values, unstaged, False, G["pr_ref64"])
    print(f"staged path: mxv_masked (MULT/PLUS, PLUS/MIN) match the plain path; bfs equals scipy "
          f"and the unstaged run, sssp dijkstra (rtol 1e-5) and the unstaged run bitwise; pr within "
          f"rtol 1e-5 of a float64 PageRank, {err:.3g} from the unstaged run", flush=True)
    proc = R["ab"]
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"ab_spmv --manual 3: exit {proc.returncode}\n{proc.stdout[-2000:]}"
                             f"{proc.stderr[-3000:]}")
    ab = json.loads(lines[-1])
    if not (ab["manual_dma"] and ab["manual_slots"] == 3 and ab["launches"]["spmv_pull_staged"] > 0
            and ab["launches"]["spmv_pull"] == 0 and set(ab["checked"]) == {"variant", "op_layer"}):
        raise AssertionError(f"ab_spmv under SPLA_MANUAL_DMA=1: {lines[-1]}")
    print(f"ab_spmv under SPLA_MANUAL_DMA=1 SPLA_MANUAL_SLOTS=3: {lines[-1]}", flush=True)


def run_probes(G):
    """Phase 4's probes path: the probe_spmv tool at n = 2^21, degree 16, and
    the gather floor of kernels 4 and 5 on tc's n = 2^20 call, with and
    without values."""
    A = G["Aint"]
    return {"probe": PROBE.run(N_SPMV, DEG_SPMV, PROBE_ITERS, device=DEVICE),
            "gather": {v: K8.mxmt_gather(A, A, v) for v in (True, False)}}


def check_probes(G, R):
    ns = R["probe"]["ns_per_entry"]
    if set(ns) != set(PROBE.PROBES) or not all(np.isfinite(v) and v > 0 for v in ns.values()):
        raise AssertionError(f"probe_spmv: {ns}")
    print(f"probe_spmv: {len(ns)} probes timed", flush=True)
    A = G["Aint"]
    for v, got in R["gather"].items():
        check_close(f"mxmt_gather n=2^20 values={v}", got, K8.mxmt_gather_plain(A, A, v), True)
    print(f"mxmt_gather at n={N_GRAPH}: equal to its plain version with and without values", flush=True)


@contextlib.contextmanager
def no_sync():
    """torch.cuda.set_sync_debug_mode("error") inside the block: a host read
    or a copy from the host raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def run_ops(G):
    """Phase 4's ops slice (``tools/ops_times.py``'s calls), every call under
    set_sync_debug_mode("error") but bsr_from_csr_host (host code by
    design): Aᵀ = m_transpose(A), the band's BSR, then each call."""
    I = G["ops"]
    with no_sync():
        I["At"] = O.m_transpose(I["A"], op.IDENTITY_FLOAT)
    I["band"] = F.bsr_from_csr_host(I["Band"], block=OT.BLOCK)
    calls = OT.calls(I)
    with no_sync():
        R = {name: call() for name, call in calls.items()}
    torch.cuda.synchronize()
    return R


def same_stored(what, got, ref, capacity):
    """A CsrMatrix result against a scipy CSR: capacity, nnz, indptr, columns
    and values of the stored entries, bitwise."""
    nnz = ref.nnz
    if got.capacity != capacity or int(got.nnz) != nnz:
        raise AssertionError(f"{what}: capacity {got.capacity}, nnz {int(got.nnz)}; want {capacity}, {nnz}")
    for name, g, r in (("indptr", got.indptr, ref.indptr), ("columns", got.cols[:nnz], ref.indices),
                       ("values", got.values[:nnz], ref.data)):
        check_close(f"{what} {name}", g.cpu().long() if name != "values" else g.cpu(),
                    torch.from_numpy(r.astype(np.int64) if name != "values" else r), True)


def same_vec(what, got, idx, vals, capacity):
    """A SparseVec result against numpy's indices and values, bitwise."""
    k = idx.size
    if got.capacity != capacity or int(got.nnz) != k:
        raise AssertionError(f"{what}: capacity {got.capacity}, nnz {int(got.nnz)}; want {capacity}, {k}")
    check_close(f"{what} indices", got.indices[:k].cpu().long(), torch.from_numpy(idx.astype(np.int64)), True)
    check_close(f"{what} values", got.values[:k].cpu(), torch.from_numpy(vals.astype(np.float32)), True)
    if bool((got.indices[k:] != got.n).any()):
        raise AssertionError(f"{what}: padding indices are not n")


def check_ops(G, R):
    """Each result against scipy / numpy: structures and element-wise values
    bitwise, PLUS folds within check_close's tolerance of float64."""
    I = G["ops"]
    a, n = I["A_sp"], OT.N
    cap = I["A"].capacity
    at = a.T.tocsr()
    at.sort_indices()
    same_stored("m_transpose", I["At"], at, cap)
    same_stored("m_transpose (the timed call)", R["m_transpose"], at, cap)
    sym = (a + a.T).tocsr()
    sym.eliminate_zeros()
    sym.sort_indices()
    same_stored("m_eadd(A, Aᵀ, PLUS) against A + Aᵀ", R["m_eadd"], sym, 2 * cap)
    recip = a.minimum(a.T).tocsr()
    recip.eliminate_zeros()
    recip.sort_indices()
    same_stored("m_emult(A, Aᵀ, MIN) against A.minimum(Aᵀ)", R["m_emult"], recip, 2 * cap)
    a64 = a.astype(np.float64)
    for what, got, axis in (("m_reduce_by_row", R["m_reduce_by_row"], 1),
                            ("m_reduce_by_column", R["m_reduce_by_column"], 0)):
        ref64 = torch.from_numpy(np.asarray(a64.sum(axis=axis)).ravel()).to(DEVICE)
        check_close(f"{what} PLUS", got.values, ref64.float(), False, ref64)
    i, j = I["row"], I["col"]
    same_vec(f"m_extract_row({i})", R["m_extract_row"], a.indices[a.indptr[i]:a.indptr[i + 1]],
             a.data[a.indptr[i]:a.indptr[i + 1]], n)
    same_vec(f"m_extract_column({j})", R["m_extract_column"], at.indices[at.indptr[j]:at.indptr[j + 1]],
             at.data[at.indptr[j]:at.indptr[j + 1]], n)
    k = sp.kron(I["KronA_sp"], I["KronB_sp"], format="csr")
    k.sort_indices()
    same_stored("kron against scipy.sparse.kron", R["kron"], k, I["KronA"].capacity * I["KronB"].capacity)
    V = I["Vec_np"]
    du, dv, dd, dd2 = (np.zeros(n, np.float32) for _ in range(4))
    du[V["iu"]], dv[V["iv"]], dd[:], dd2[:] = V["vu"], V["vv"], V["d"], V["d2"]
    su, sv = np.zeros(n, bool), np.zeros(n, bool)
    su[V["iu"]], sv[V["iv"]] = True, True
    ucap = R["v_map"].capacity
    union = np.nonzero(su | sv)[0]
    same_vec("v_eadd PLUS", R["v_eadd"], union, (du + dv)[union], 2 * ucap)
    union = np.nonzero(su | (dd != 0))[0]
    same_vec("v_eadd MIN sparse-dense", R["v_eadd sparse-dense"], union, np.minimum(du, dd)[union], ucap + n)
    both = np.nonzero(su & sv)[0]
    same_vec("v_emult MULT", R["v_emult"], both, (du * dv)[both], 2 * ucap)
    same_vec("v_map AINV", R["v_map"], np.sort(V["iu"]), -du[np.sort(V["iu"])], ucap)
    check_close("v_assign_masked", R["v_assign_masked"].values.cpu(),
                torch.from_numpy(np.where(su & (du > 0), np.float32(0.25), dd)), True)
    new = np.where(sv, np.minimum(dd, dv), dd)
    r, fdb = R["v_eadd_fdb"]
    check_close("v_eadd_fdb r", r.values.cpu(), torch.from_numpy(new), True)
    changed = np.nonzero(new != dd)[0]
    same_vec("v_eadd_fdb feedback", fdb, changed, new[changed], R["v_map"].capacity)
    new = np.minimum(dd, dd2)
    r, fdb = R["v_eadd_fdb dense"]
    check_close("v_eadd_fdb dense r", r.values.cpu(), torch.from_numpy(new), True)
    check_close("v_eadd_fdb dense feedback", fdb.values.cpu(), torch.from_numpy(np.where(new != dd, new, 0)),
                True)
    for what, got, ref in (("v_reduce PLUS", R["v_reduce"], du.astype(np.float64).sum()),
                           ("v_reduce dense PLUS", R["v_reduce dense"], dd.astype(np.float64).sum())):
        ref64 = torch.tensor([ref], dtype=torch.float64, device=DEVICE)
        check_close(what, got.value.reshape(1), ref64.float(), False, ref64)
    for what, got, want in (("v_count_mf", R["v_count_mf"], V["iu"].size),
                            ("v_count_mf dense", R["v_count_mf dense"], int((dd != 0).sum()))):
        if got.value.dtype != torch.uint32 or int(got.value.to(torch.int64)) != want:
            raise AssertionError(f"{what}: {got.value}, want {want} (uint32)")
    band = I["Band_sp"].astype(np.float64)
    ref64 = torch.from_numpy(band @ V["x"].astype(np.float64)).to(DEVICE)
    check_close("bsr_spmv", R["bsr_spmv"], ref64.float(), False, ref64)
    ref64 = torch.from_numpy(band @ V["X"].astype(np.float64)).to(DEVICE)
    check_close("bsr_spmm", R["bsr_spmm"], ref64.float(), False, ref64)
    b = I["band"]
    print(f"ops: A n={n} nnz={a.nnz} (capacity {cap}); Aᵀ, A + Aᵀ ({sym.nnz} entries), A.minimum(Aᵀ) "
          f"({recip.nnz}), kron ({k.nnz}, n={k.shape[0]}) equal scipy's; row and column sums within "
          f"1e-5 of float64; row {i} ({int(R['m_extract_row'].nnz)} entries) and column {j} "
          f"({int(R['m_extract_column'].nnz)}) extracted; the vector chain at n={n} equals numpy; "
          f"bsr_spmv / bsr_spmm (n={OT.N_BAND}, {int(b.nnzb)} blocks of {b.block}, X of {OT.SPMM_COLS} columns) "
          f"within 1e-5 of float64; every call with no host sync", flush=True)


# ---------------------------------------------------------------- the facade


def facade_matrix(a, dtype):
    """A facade Matrix of the scipy matrix ``a`` on the default device,
    built through the bulk path (``Matrix.build`` of three MemViews)."""
    coo = a.tocoo()
    M = FC.Matrix(a.shape, dtype)
    M.build(MemView(coo.row), MemView(coo.col), MemView(coo.data.astype(dtype.np_dtype)))
    return M


def facade_chain(r, mask, M, steps=FACADE_CHAIN):
    """bench_suite.py:374-378: ``steps`` chained vxm, then reduce(PLUS) read on the host."""
    for _ in range(steps):
        r = r.vxm(mask, M, FLOAT.MULT, FLOAT.PLUS, FLOAT.ALWAYS)
    return r, float(r.reduce(FLOAT.PLUS).get())


def run_facade(G):
    """Phase 4's facade slice: every object made with no device= (so on
    the accelerator), bench_suite.py's facade chain uncut, mxv, the vector
    and matrix ops on the chain's objects, mxm, mxmT (i32 and f32), the pi
    example at its default n, convert on a side-512 road grid, the banner
    in a subprocess, a Schedule of callback tasks, and one chain under the
    time profiler and torch.profiler."""
    I = G["facade"]
    n = N_FACADE
    R = {"seconds": {}}
    t0 = time.perf_counter()
    M = facade_matrix(I["S"], FLOAT)
    r0 = FC.Vector.from_lists(I["start"], np.ones(I["start"].size, np.float32), n, FLOAT)
    mask = FC.Vector(n, FLOAT)
    r, R["chain_sum"] = facade_chain(r0, mask, M)
    R["chain"] = r.to_numpy()
    R["mxv"] = M.mxv(mask, r0, FLOAT.MULT, FLOAT.PLUS, FLOAT.ALWAYS).to_numpy()
    R["eadd"] = r.eadd(FLOAT.PLUS, r0).to_numpy()
    R["emult"] = r.emult(FLOAT.MULT, r0).to_numpy()
    R["map"] = r.map(FLOAT.AINV).to_numpy()
    R["reduce_max"] = r.reduce(FLOAT.MAX).get()
    R["transpose"] = M.transpose().read()
    R["reduce_by_row"] = M.reduce_by_row(FLOAT.PLUS).to_numpy()
    A13 = facade_matrix(G["MX13_sp"], FLOAT)
    R["mxm"] = A13.mxm(A13, FLOAT.MULT, FLOAT.PLUS).read()
    objs = [M, r0, mask, r, A13]
    for name, t in (("i32", INT), ("f32", FLOAT)):
        objs.append(facade_matrix(I[f"T_{name}"], t))
        R[f"mxmT_{name}"] = objs[-1].mxmT(objs[-1], objs[-1], t.MULT, t.PLUS, t.ALWAYS).read()
    R["devices"] = {str(o.device) for o in objs}
    torch.cuda.synchronize()
    t0 = lap(R, "chain, mxv, vector and matrix ops, mxm, mxmT", t0)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        PI.run([])
    print(out.getvalue(), end="", flush=True)
    R["pi"] = float(re.search(r"Pi is roughly ([0-9.]+)", out.getvalue()).group(1))
    t0 = lap(R, "pi", t0)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp) / "road512.mtx", Path(tmp) / "road512.out.mtx"
        write_mtx(src, road_grid(SIDE_CONVERT))
        CONVERT.run(["--in", str(src), "--out", str(dst), "--offset-indices", "true", "--make-undirected",
                     "false", "--remove-loops", "false"])
        kw = {"make_undirected": False, "remove_loops": False}
        R["convert"] = (MtxLoader(verbose=False).load(src, **kw), MtxLoader(verbose=False).load(dst, **kw))
    t0 = lap(R, "convert", t0)
    R["banner"] = subprocess.run([sys.executable, "-m", "spla_tpu_torch"], cwd=ROOT, capture_output=True,
                                 text=True, timeout=300)
    t0 = lap(R, "banner", t0)
    order, box = [], {"r": r0}

    def step(k):
        order.append(k)
        box["r"] = box["r"].vxm(mask, M, FLOAT.MULT, FLOAT.PLUS, FLOAT.ALWAYS)

    def total():
        order.append("reduce")
        return box["r"].reduce(FLOAT.PLUS).get()

    sched = make_schedule()
    first = sched.add_step(make_sched_task_callback(lambda: step(0)))
    for k in range(1, 3):
        sched.add_task(first, make_sched_task_callback(lambda k=k: step(k)))
    sched.add_step(make_sched_task_callback(total))
    R["schedule"] = (order, sched.submit(), box["r"].to_numpy())
    lib = get_library()
    profiler.reset()
    lib.set_time_profiling(True)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            facade_chain(r0, mask, M)
        R["profile"] = (profiler.stats(), lib.time_profile_dump(), {e.key for e in prof.key_averages()})
    finally:
        lib.set_time_profiling(False)
        profiler.reset()
    torch.cuda.synchronize()
    lap(R, "schedule, profiled chain", t0)
    return R


def lap(R, what, t0):
    R["seconds"][what] = time.perf_counter() - t0
    return time.perf_counter()


def check_facade(G, R):
    """The facade slice against scipy and numpy: the chain within rtol 1e-5
    of scipy's float64 chain (check_close), the element-wise ops and the
    transpose bitwise, sums within 1e-5 of float64, mxm and mxmT (f32)
    within 1e-5 of scipy and mxmT (i32) exact; pi within PI_TOL; convert's
    file equal to its input; the banner names the card; the schedule's
    tasks ran in order; the profile holds vector_vxm ten times."""
    I = G["facade"]
    if R["devices"] != {"cuda:0"}:
        raise AssertionError(f"facade objects made with no device= live on {R['devices']}, not cuda:0")
    s64 = I["S"].astype(np.float64)
    st64 = s64.T.tocsr()
    x = np.zeros(N_FACADE)
    x[I["start"]] = 1.0
    x0 = x.copy()
    for _ in range(FACADE_CHAIN):
        x = st64 @ x

    def near(what, got, ref64):
        ref64 = torch.from_numpy(np.asarray(ref64, np.float64))
        return check_close(what, torch.from_numpy(np.asarray(got)), ref64.float(), False, ref64)

    near(f"facade chain of {FACADE_CHAIN} vxm", R["chain"], x)
    near("facade chain reduce(PLUS)", [R["chain_sum"]], [x.sum()])
    near("facade mxv", R["mxv"], s64 @ x0)
    chain = R["chain"]
    r0 = x0.astype(np.float32)
    for what, got, ref in (("eadd PLUS", R["eadd"], chain + r0), ("emult MULT", R["emult"], chain * r0),
                           ("map AINV", R["map"], -chain)):
        check_close(f"facade {what}", torch.from_numpy(got), torch.from_numpy(ref.astype(np.float32)), True)
    if R["reduce_max"] != float(chain.max()):
        raise AssertionError(f"facade reduce(MAX) {R['reduce_max']}, want {chain.max()}")
    near("facade reduce_by_row(PLUS)", R["reduce_by_row"], np.asarray(s64.sum(axis=1)).ravel())
    st = I["S"].T.tocsr()
    st.sort_indices()
    rows, cols, vals = R["transpose"]
    want = st.tocoo()
    for what, g, w in (("rows", rows, want.row), ("cols", cols, want.col), ("values", vals, want.data)):
        check_close(f"facade transpose {what}", torch.from_numpy(np.asarray(g)),
                    torch.from_numpy(np.asarray(w).astype(np.asarray(g).dtype)), True)

    def same_entries(what, got, ref, exact):
        ref = ref.tocsr()
        ref.eliminate_zeros()
        ref.sort_indices()
        ref = ref.tocoo()
        rows, cols, vals = got
        if rows.size != ref.nnz:
            raise AssertionError(f"{what}: {rows.size} entries, want {ref.nnz}")
        for name, g, w in (("rows", rows, ref.row), ("cols", cols, ref.col)):
            check_close(f"{what} {name}", torch.from_numpy(g.astype(np.int64)), torch.from_numpy(w.astype(np.int64)),
                        True)
        if exact:
            check_close(f"{what} values", torch.from_numpy(vals), torch.from_numpy(ref.data.astype(vals.dtype)), True)
        else:
            near(f"{what} values", vals, ref.data)

    a13 = G["MX13_sp"].astype(np.float64)
    same_entries("facade mxm MULT/PLUS f32 n=2^13", R["mxm"], a13 @ a13, False)
    for name in ("i32", "f32"):
        t = I[f"T_{name}"].astype(np.float64)
        pattern = t.copy()
        pattern.data[:] = 1.0
        same_entries(f"facade mxmT {name} n=2^15", R[f"mxmT_{name}"], (t @ t.T).multiply(pattern), name == "i32")
    if abs(R["pi"] - np.pi) > PI_TOL:
        raise AssertionError(f"pi example: {R['pi']}, more than {PI_TOL} from pi")
    src, dst = R["convert"]
    if (src.n_rows, src.n_cols) != (dst.n_rows, dst.n_cols) or not all(
            np.array_equal(getattr(src, f), getattr(dst, f)) for f in ("rows", "cols", "vals")):
        raise AssertionError("convert: the written file does not load back equal")
    banner = R["banner"]
    if banner.returncode != 0 or torch.cuda.get_device_name(0) not in banner.stdout:
        raise AssertionError(f"python -m spla_tpu_torch: exit {banner.returncode}\n{banner.stdout}{banner.stderr}")
    order, results, sched_r = R["schedule"]
    y = x0.copy()
    for _ in range(3):
        y = st64 @ y
    if order != [0, 1, 2, "reduce"] or results[:3] != [None] * 3:
        raise AssertionError(f"schedule: tasks ran as {order}")
    near("schedule's three vxm", sched_r, y)
    near("schedule's reduce", [results[3]], [y.sum()])
    stats, _, names = R["profile"]
    if stats.get("vector_vxm", {}).get("count") != FACADE_CHAIN or stats["vector_reduce"]["count"] != 1:
        raise AssertionError(f"time profile: {stats}")
    if not {"vector_vxm", "vector_reduce"} <= names:
        raise AssertionError("torch.profiler shows no record_function of the facade's scopes")
    print(f"facade: chain of {FACADE_CHAIN} vxm at n={N_FACADE} ({I['S'].nnz} entries) and its reduce within "
          f"1e-5 of scipy's float64; mxv, eadd, emult, map, reduce(MAX), transpose, reduce_by_row equal; mxm "
          f"n=2^13 and mxmT n=2^15 (i32 exact, f32 within 1e-5) equal scipy's; pi {R['pi']}; convert's "
          f"side-{SIDE_CONVERT} grid loads back equal; banner: {banner.stdout.strip().splitlines()[-1]}; the "
          f"schedule ran in order; vector_vxm x{stats['vector_vxm']['count']} in "
          f"{stats['vector_vxm']['ms']:.3f} ms under profiling", flush=True)
    print("facade seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in R["seconds"].items()), flush=True)


# ---------------------------------------------------------------- the sharded layer


DIST_SPMV = ("spmv", "pr", "pr_overlap", "pr_pallas", "pr_pallas_overlap", "bfs", "bfs_pallas",
             "bfs_pallas_overlap", "sssp", "sssp_pallas", "sssp_pallas_overlap", "road_bfs")


def dist_mats(G):
    """Part (a)'s inputs, the main path's graphs uncut: SpMV on bench.py's
    n = 2^21 graph, PageRank / BFS / SSSP on bench_suite.py's n = 2^20 graph,
    BFS with the default ladder on the side-1024 road grid, TC at n = 2^15
    and 2^20, mxm on the mxm_mprod_s graph.  SSSP pulls over Aᵀ (the
    weights are not symmetric)."""
    return {"spmv": G["M"], "pr": G["Ap"], "bfs": G["Aint"], "sssp": F.csr_transpose_host(G["Aw"]),
            "road": G["Road"], "tc": G["T"],
            "tc_big": G["Aint"], "mxm": G["MX13"]}


def run_dist(G):
    """Phase 4's dist slice.  (a) A world of one NCCL rank in this process
    (the card's count is 1 where it runs), every dist function once at the
    main path's size (``tools.dist_times``); then the same functions on
    ``DT.SMALL``'s graphs, the reference of (b).  (b) DIST_RANKS gloo ranks
    on cuda:0, spawned, each launching kernels 1 and 4 on its shards of
    ``DT.SMALL``'s graphs, with their walls (host-staged collectives)."""
    t0 = time.perf_counter()
    mesh = PAR.make_device_mesh(device=DEVICE)
    R = {"mesh": mesh, "shards": DT.shard_all(mesh, dist_mats(G))}
    torch.cuda.synchronize()
    print(f"dist: world of {mesh.size} ({mesh.backend}) on {mesh.device}; shards made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    R["one"] = DT.run_all(mesh, R["shards"])
    R["small_shards"] = DT.shard_all(mesh, DT.graphs(DT.SMALL, DEVICE))
    R["small_one"] = DT.run_all(mesh, R["small_shards"])
    t0 = time.perf_counter()
    R["ranks"] = PAR.spawn_world(DT.rank_job, DIST_RANKS, "gloo", [DEVICE] * DIST_RANKS, args=(DT.SMALL, True),
                                 timeout_s=600.0, threads=1)
    print(f"dist: {DIST_RANKS} gloo ranks on {DEVICE} ran in {time.perf_counter() - t0:.1f} s", flush=True)
    return R


def check_dist(G, R):
    one, x = R["one"], R["shards"]["x"]
    check_close("dist_masked_spmv MULT/PLUS n=2^21", torch.from_numpy(one["spmv"]["result"]).to(DEVICE),
                K1.spmv_pull(G["M"], x, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)[0], False,
                masked_spmv(as64(G["M"]), x.double(), op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)[0])
    p_one = alg.pr(G["Ap"], 0.85, DT.EPS).values
    for name in ("pr", "pr_overlap", "pr_pallas", "pr_pallas_overlap"):
        check_close(f"dist {name}", torch.from_numpy(one[name]["result"]).to(DEVICE)[:N_GRAPH], p_one, False,
                    G["pr_ref64"])
    bfs_one = alg.bfs(G["Aint"], 0, At=G["Aint"]).values
    sssp_one = alg.sssp(G["Aw"], 0).values
    fin = torch.isfinite(G["sssp_ref"])
    for name in ("bfs", "bfs_pallas", "bfs_pallas_overlap"):
        v = torch.from_numpy(one[name]["result"]).to(DEVICE)[:N_GRAPH]
        check_close(f"dist {name} against scipy", v, G["bfs_ref"], True)
        check_close(f"dist {name} against algorithms.bfs", v, bfs_one, True)
    for name in ("sssp", "sssp_pallas", "sssp_pallas_overlap"):
        d = torch.from_numpy(one[name]["result"]).to(DEVICE)[:N_GRAPH]
        if not torch.equal(torch.isinf(d), ~fin):
            raise AssertionError(f"dist {name}: unreachable set differs from dijkstra")
        torch.testing.assert_close(d[fin].double(), G["sssp_ref"][fin], rtol=1e-5, atol=0, msg=f"dist {name}")
        torch.testing.assert_close(d[fin], sssp_one[fin], rtol=1e-5, atol=0, msg=f"dist {name} vs sssp")
    road = torch.from_numpy(one["road_bfs"]["result"]).to(DEVICE)[:G["Road"].shape[0]]
    check_close("dist road bfs against scipy", road, G["road_bfs_ref"], True)
    tc_small, tc_big = alg.tc(G["T"]), alg.tc(G["Aint"])
    if one["tc"]["result"] != tc_small or one["tc_big"]["result"] != tc_big:
        raise AssertionError(f"dist_tc {one['tc']['result']}, {one['tc_big']['result']}: algorithms.tc "
                             f"{tc_small}, {tc_big}")
    ref, got = G["MX13_ref"], one["mxm"]["result"]
    check_close("dist_mxm rows against scipy", torch.from_numpy(got["row_ids"]).long(),
                torch.from_numpy(np.repeat(np.arange(N_MXM), np.diff(ref.indptr))), True)
    check_close("dist_mxm cols against scipy", torch.from_numpy(got["cols"]), torch.from_numpy(ref.indices), True)
    check_close("dist_mxm values against scipy", torch.from_numpy(got["values"]).to(DEVICE),
                torch.from_numpy(got["values"]).to(DEVICE), False, torch.from_numpy(ref.data).to(DEVICE))
    for name, r in one.items():
        if name in DIST_SPMV and r["launches"].get("spmv_pull", 0) <= 0:
            raise AssertionError(f"dist {name} launched no kernel 1")
        if any(k.endswith("_torch") for k in r["dispatch"]):
            raise AssertionError(f"dist {name} took a torch path: {r['dispatch']}")
    if one["tc"]["launches"].get("mxmt_reduce", 0) <= 0 or one["tc_big"]["launches"].get("mxmt_reduce", 0) <= 0:
        raise AssertionError("dist_tc launched no kernel 4")
    print(f"dist (a): every function equals the single-card path and scipy (tc {tc_small} and {tc_big}, "
          f"mxm {len(got['cols'])} entries); kernel 1 on every SpMV path, kernel 4 in dist_tc", flush=True)
    check_dist_ranks(R)


def check_dist_ranks(R):
    """(b): the ranks' rows stacked equal the world of one on the same
    graphs (min-plus, depths, counts and structure bitwise; f32 PLUS within
    rtol 1e-5); stats equal the JAX package's at S = DIST_RANKS."""
    small = R["small_one"]
    for name, want in small.items():
        parts = [r["calls"][name] for r in R["ranks"]]
        for rank, p in enumerate(parts):
            if any(k.endswith("_torch") for k in p["dispatch"]):
                raise AssertionError(f"dist (b) rank {rank} {name} took a torch path: {p['dispatch']}")
            if name in DIST_SPMV and p["launches"].get("spmv_pull", 0) <= 0:
                raise AssertionError(f"dist (b) rank {rank} {name} launched no kernel 1")
            if name == "tc" and p["launches"].get("mxmt_reduce", 0) <= 0:
                raise AssertionError(f"dist (b) rank {rank} tc launched no kernel 4")
            if name in DT.JAX_STATS_S4 and p["stats"] != DT.JAX_STATS_S4[name]:
                raise AssertionError(f"dist (b) {name} stats {p['stats']}, the JAX package's {DT.JAX_STATS_S4[name]}")
        w = want["result"]
        if name == "mxm":
            mloc = -(-DT.SMALL["mxm_n"] // DIST_RANKS)  # the ranks' rows are local
            for f in ("row_ids", "cols"):
                got = np.concatenate([p["result"][f] + (rank * mloc if f == "row_ids" else 0)
                                      for rank, p in enumerate(parts)])
                np.testing.assert_array_equal(got, w[f], err_msg=f"dist (b) mxm {f}")
            np.testing.assert_allclose(np.concatenate([p["result"]["values"] for p in parts]), w["values"], rtol=1e-5)
        elif isinstance(w, np.ndarray):
            got = np.concatenate([p["result"] for p in parts])[:w.shape[0]]
            if name == "spmv" or name.startswith("pr"):
                np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-7, err_msg=f"dist (b) {name}")
            else:
                np.testing.assert_array_equal(got, w, err_msg=f"dist (b) {name}")
        elif any(p["result"] != w for p in parts):
            raise AssertionError(f"dist (b) {name}: {[p['result'] for p in parts]}, world of one {w}")
    print(f"dist (b): {DIST_RANKS} gloo ranks on {DEVICE} equal the world of one on n={DT.SMALL['n']}; BFS and "
          f"SSSP stats equal the JAX package's at S={DIST_RANKS}; kernels 1 and 4 on every rank", flush=True)


# ---------------------------------------------------------------- timing


def cuda_ms(fn, reps=TIMED_RUNS, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def paired_ms(kernel_fn, plain_fn, plain_reps=TIMED_RUNS):
    """plain, kernel, kernel, plain; mean of each side."""
    warm = min(plain_reps, 3)
    p1 = cuda_ms(plain_fn, plain_reps, warm)
    k1, k2 = cuda_ms(kernel_fn), cuda_ms(kernel_fn)
    p2 = cuda_ms(plain_fn, plain_reps, warm)
    return (k1 + k2) / 2, (p1 + p2) / 2


def mxmt_bound(mask, A, values, out_bytes):
    """Kernels 4 and 5 (B = A, every stored entry selected) and the gather:
    each distinct input read once (the mask's indptr and columns, A's
    indptr, columns and, with ``values``, values; the gather no A but B's,
    which is A), the outputs written once."""
    ins = [mask.indptr, mask.cols, A.indptr, A.cols, *((A.values,) if values else ())]
    nbytes = sum(t.numel() * t.element_size() for t in {t.data_ptr(): t for t in ins}.values())
    return bound(nbytes + out_bytes)


def time_spgemm(G, card):
    """Kernels 4 and 5 against their plain versions, beside their gather
    floor (``mxmt_gather``: the same walk, B's rows with no probe of A), on
    the SpGEMM graph (n = 2^15) and the traversal graph (n = 2^20), mask =
    A = B as tc calls them, and on the hub graph with its own mask; every
    stored mask entry selected.  masked_spgemm_mprod_s (bench_suite.py:559:
    mask products over time); the walls of tc at both sizes and of
    mxmT_masked MULT/PLUS i32 at n = 2^20.  Returns the n = 2^20 rows."""
    times = {}
    graphs = (("n=2^15", G["T"], G["T"], TIMED_RUNS), ("n=2^20", G["Aint"], G["Aint"], PLAIN_RUNS_BIG),
              ("hub", G["HTm_i32"], G["HTw_i32"], PLAIN_RUNS_BIG))
    for label, mask, A, reps in graphs:
        n, nnz = A.shape[0], int(A.nnz)
        prods = count_mxmT_products(mask, A)
        rows = {
            "mxmt_reduce structural": (lambda: K45.mxmt_reduce(mask, A, A, None, struct_only=True),
                                       lambda: K45.mxmt_reduce_plain(mask, A, A, None, struct_only=True),
                                       mxmt_bound(mask, A, False, out_bytes=8)),
            "mxmt_reduce MULT i32": (lambda: K45.mxmt_reduce(mask, A, A, op.MULT_INT),
                                     lambda: K45.mxmt_reduce_plain(mask, A, A, op.MULT_INT),
                                     mxmt_bound(mask, A, True, out_bytes=8)),
            "mxmt_masked MULT/PLUS i32": (
                lambda: K45.mxmt_masked(mask, A, A, op.MULT_INT, op.PLUS_INT, 0),
                lambda: K45.mxmt_masked_plain(mask, A, A, op.MULT_INT, op.PLUS_INT, 0),
                mxmt_bound(mask, A, True, out_bytes=5 * mask.capacity)),
            "mxmt_gather cols": (lambda: K8.mxmt_gather(mask, A, False),
                                 lambda: K8.mxmt_gather_plain(mask, A, False),
                                 mxmt_bound(mask, A, False, out_bytes=4 * mask.capacity)),
            "mxmt_gather cols+values": (lambda: K8.mxmt_gather(mask, A, True),
                                        lambda: K8.mxmt_gather_plain(mask, A, True),
                                        mxmt_bound(mask, A, True, out_bytes=4 * mask.capacity)),
        }
        print(f"kernels 4 and 5 on {label} n={n} nnz={nnz} mask nnz={int(mask.nnz)} products={prods}: "
              f"{mxmt_plan_line(mask, A)}", flush=True)
        for name, (kfn, pfn, (bound_ms, bound_by)) in rows.items():
            k, p = paired_ms(kfn, pfn, reps)
            print(f"time {name} {label}: kernel {k:.4f} ms ({prods / k / 1e3:.1f} Mproducts/s), plain "
                  f"{p:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) [{card}]", flush=True)
            if label == "n=2^20":
                key = {"mxmt_reduce structural": "mxmt_reduce", "mxmt_masked MULT/PLUS i32": "mxmt_masked",
                       "mxmt_gather cols+values": "mxmt_gather"}.get(name)
                if key:
                    times[key] = (k, p, bound_ms, bound_by)
        if label == "hub":
            continue
        wall = wall_ms(lambda: alg.tc(A))
        print(f"time tc {label} nnz={nnz}: wall {wall:.4f} ms (median of 3), {prods / wall / 1e3:.1f} "
              f"masked_spgemm_mprod_s end to end [{card}]", flush=True)
    A = G["Aint"]
    wall = wall_ms(lambda: mxmT_masked(A, A, A, op.MULT_INT, op.PLUS_INT, op.GTZERO_INT, 0))
    print(f"time mxmT_masked MULT/PLUS i32 n=2^20: wall {wall:.4f} ms (median of 3) [{card}]", flush=True)
    return times


def wall_ms(fn):
    """Median of 3 host-clock walls of a synchronized call, after one."""
    fn()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return sorted(walls)[1]


def time_kernels(G, card):
    times = {}
    n, M = N_SPMV, G["M"]
    nnz = M.cols.shape[0]
    gb_model = (nnz * 12 + n * 4 + (n + 1) * 4) / 1e9  # bench.py:207
    x = torch.from_numpy(np.random.default_rng(1).random(n, dtype=np.float32)).to(DEVICE)
    for label, om, oa, init in (("MULT/PLUS", op.MULT_FLOAT, op.PLUS_FLOAT, 0.0),
                                ("PLUS/MIN", op.PLUS_FLOAT, op.MIN_FLOAT, float("inf"))):
        k, p = paired_ms(lambda: K1.spmv_pull(M, x, om, oa, init),
                         lambda: K1.spmv_pull_plain(M, x, om, oa, init))
        times.setdefault("spmv_pull", (k, p, *spmv_bound(M)))
        print(f"time spmv_pull {label} f32 n={n} nnz={nnz}: kernel {k:.4f} ms "
              f"({gb_model / k * 1e3:.1f} GB/s-model), plain {p:.4f} ms "
              f"({gb_model / p * 1e3:.1f} GB/s-model) [{card}]", flush=True)
    valid = x > 0.5
    k, p = paired_ms(lambda: K1.spmv_pull_structural(M, valid),
                     lambda: K1.spmv_pull_structural_plain(M, valid))
    print(f"time spmv_pull structural n={n}: kernel {k:.4f} ms, plain {p:.4f} ms [{card}]", flush=True)

    n, A = N_GRAPH, G["Aw"]
    rng = np.random.default_rng(8)
    front = torch.from_numpy(np.sort(rng.choice(n, n // 20, replace=False)).astype(np.int32)).to(DEVICE)
    d = torch.from_numpy(rng.uniform(0, 10, n).astype(np.float32)).to(DEVICE)
    k, p = paired_ms(lambda: K2.spmv_push(A, front, d, op.PLUS_FLOAT, op.MIN_FLOAT, float("inf")),
                     lambda: K2.spmv_push_plain(A, front, d, op.PLUS_FLOAT, op.MIN_FLOAT, float("inf")))
    ip = A.indptr.long()
    edges = int((ip[front.long() + 1] - ip[front.long()]).sum())
    # the frontier, its indptr pairs and x values, its rows' cols and values; the hits written
    times["spmv_push"] = (k, p, *bound(16 * front.numel() + 8 * edges + 4 * n, 2 * edges))
    inf_t = torch.tensor(float("inf"), device=DEVICE)
    DEVICE_MS["spmv_push"] = LT.graph_ms(lambda: K2.spmv_push(A, front, d, op.PLUS_FLOAT, op.MIN_FLOAT,
                                                               inf_t), TIMED_RUNS)
    print(f"time spmv_push MIN-plus f32 n={n} frontier={n // 20}: kernel {k:.4f} ms (device, a CUDA graph "
          f"of {TIMED_RUNS} calls: {DEVICE_MS['spmv_push']:.4f}), plain {p:.4f} ms [{card}]", flush=True)
    k, p = paired_ms(lambda: K2.spmv_push_structural(A, front),
                     lambda: K2.spmv_push_structural_plain(A, front))
    print(f"time spmv_push OR n={n} frontier={n // 20}: kernel {k:.4f} ms, plain {p:.4f} ms [{card}]",
          flush=True)

    hits = torch.from_numpy(rng.random(n) < 0.1).to(DEVICE)
    v = torch.zeros(n, dtype=torch.int32, device=DEVICE)
    f = torch.from_numpy(rng.random(n) < 0.05).to(DEVICE)
    lst = torch.empty(n, dtype=torch.int32, device=DEVICE)
    cnt = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    # the first call's inputs: hits and front read, v where a hit lands outside the frontier, front
    # and v written where they change, the new frontier's list
    level_bytes = 2 * n + 4 * int((hits & ~f).sum()) + 5 * int(f.sum()) + 4 * int((hits & ~f).sum())
    k, p = paired_ms(lambda: K3.bfs_level_update(hits, v.zero_(), f, 3, lst, cnt),
                     lambda: K3.bfs_level_update_plain(hits, v.zero_(), f, 3, lst, cnt))
    # hits, v and the frontier read; v and the frontier written, and the new frontier's list
    times["level_update"] = (k, p, *bound(level_bytes))
    print(f"bound level_update: {level_bytes} bytes, a pass over n = {n} (2 bytes a vertex) and the "
          f"first call's frontier and hits", flush=True)
    DEVICE_MS["level_update"] = LT.graph_ms(lambda: K3.bfs_level_update(hits, v.zero_(), f, 3, lst, cnt),
                                            TIMED_RUNS)
    print(f"time level_update BFS n={n}: kernel {k:.4f} ms (device, a CUDA graph of {TIMED_RUNS} calls "
          f"with v's memset: {DEVICE_MS['level_update']:.4f}), plain {p:.4f} ms [{card}]", flush=True)
    hv = torch.from_numpy(rng.uniform(0, 10, n).astype(np.float32)).to(DEVICE)
    sv = torch.full((n,), float("inf"), device=DEVICE)
    ch = torch.zeros(n, dtype=torch.bool, device=DEVICE)
    k, p = paired_ms(lambda: K3.sssp_level_update(hv, sv.fill_(float("inf")), ch, lst, cnt),
                     lambda: K3.sssp_level_update_plain(hv, sv.fill_(float("inf")), ch, lst, cnt))
    print(f"time level_update SSSP n={n}: kernel {k:.4f} ms, plain {p:.4f} ms [{card}]", flush=True)
    return times


def time_algorithms(G, card):
    for name, fn in (("bfs", lambda: alg.bfs(G["Aint"], 0, At=G["Aint"])),
                     ("sssp", lambda: alg.sssp(G["Aw"], 0)),
                     ("pr", lambda: alg.pr(G["Ap"], 0.85, 1e-6))):
        fn()
        walls = []
        for _ in range(3):
            for k in alg.STATS:
                alg.STATS[k] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        s = alg.STATS
        print(f"time {name} n={N_GRAPH} nnz={G['Aint'].cols.shape[0]}: wall {sorted(walls)[1]:.2f} ms "
              f"(median of 3; runs {', '.join(f'{w:.2f}' for w in walls)}), "
              f"{s['levels']} levels ({s['push']} push, {s['pull']} pull), "
              f"{s['host_syncs']} host syncs [{card}]", flush=True)


def time_road(G, card):
    """Kernel 6 against its plain versions on the road grids (CUDA events);
    kernel 6 alone on the path, barbell and random 2^18 graphs, with rounds,
    wide rounds and us a round (the plain version beside it on the random
    graph, where it takes seconds); BFS on the side-3072 grid with the
    budget lifted, against scipy; and the road walls on the resident route
    and on the level loop (host clock around a synchronized run, median of
    3, with levels and host syncs)."""
    times = {}
    for kind, M, fn, plain in (("bfs", G["Road"], K6.bfs_resident, K6.bfs_resident_plain),
                               ("sssp", G["RoadW"], K6.sssp_resident, K6.sssp_resident_plain)):
        k, p = paired_ms(lambda: fn(M, 0), lambda: plain(M, 0), PLAIN_RUNS_ROAD)
        n, nnz = M.shape[0], int(M.nnz)
        # indptr, cols (and the weights) once; the depths or distances written
        times[f"{kind}_resident"] = (k, p, *bound(4 * (n + 1) + (8 if kind == "sssp" else 4) * nnz
                                                   + 4 * n))
        rounds, _, wide = fn(M, 0)[1].tolist()
        print(f"time {kind}_resident n={M.shape[0]} nnz={M.cols.shape[0]}: kernel {k:.4f} ms ({rounds} "
              f"rounds, {wide} wide, {k * 1e3 / rounds:.4f} us a round), plain {p:.4f} ms [{card}]",
              flush=True)
    for label, key, plain_too in (("path", "Path", False), ("barbell", "Barbell", False),
                                  ("random 2^18", "Rand18", True)):
        M = G[key]
        for kind, fn, plain in (("bfs", K6.bfs_resident, K6.bfs_resident_plain),
                                ("sssp", K6.sssp_resident, K6.sssp_resident_plain)):
            row = RL.time_run(kind, M, 0, TIMED_RUNS)
            extra = ""
            if plain_too:
                k, p = paired_ms(lambda: fn(M, 0), lambda: plain(M, 0), PLAIN_RUNS_ROAD)
                extra = f"; paired with the plain version: kernel {k:.4f} ms, plain {p:.4f} ms"
            print(f"time {kind}_resident {label} n={row['n']} nnz={row['nnz']} "
                  f"({K6.resident_plan(M)}): {row['ms']:.4f} ms, {row['rounds']} rounds, {row['wide']} "
                  f"wide, {row['us_per_round']:.4f} us a round{extra} [{card}]", flush=True)
    time_road_big(G, card)
    walls = {}
    for name, algo, M in (("bfs", alg.bfs, G["Road"]), ("sssp", alg.sssp, G["RoadW"])):
        for route, budget in (("resident", alg.RESIDENT_BYTES), ("level loop", 0)):
            with resident_budget(budget):
                algo(M, 0, At=M)
                runs = []
                for _ in range(3):
                    for key in alg.STATS:
                        alg.STATS[key] = 0
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    algo(M, 0, At=M)
                    torch.cuda.synchronize()
                    runs.append((time.perf_counter() - t0) * 1e3)
            wall = sorted(runs)[1]
            walls[name, route] = wall
            s = alg.STATS
            print(f"time road {name} {route} n={M.shape[0]} nnz={M.cols.shape[0]}: wall {wall:.3f} ms "
                  f"(median of 3; runs {', '.join(f'{w:.3f}' for w in runs)}), {s['levels']} levels, "
                  f"{s['host_syncs']} host syncs [{card}]", flush=True)
    nnz = G["Road"].cols.shape[0]
    print(f"road_bfs_gteps {nnz / walls['bfs', 'resident'] / 1e6:.4f} (level loop "
          f"{nnz / walls['bfs', 'level loop'] / 1e6:.4f}); road_sssp_ms {walls['sssp', 'resident']:.3f} "
          f"(level loop {walls['sssp', 'level loop']:.3f}) [{card}]", flush=True)
    return times


def time_road_big(G, card):
    """road_big_bfs_gteps's graph (the side-3072 grid, six times the byte
    budget): the public bfs with the budget lifted takes kernel 6 and
    equals scipy's depths; kernel 6's time, rounds and us a round.  Its
    GTEPS are over the kernel's time, not bench_suite's host wall of bfs."""
    a, M = G["Road3072_sp"], G["Road3072"]
    with resident_budget(1 << 40):
        for key in alg.STATS:
            alg.STATS[key] = 0
        v = alg.bfs(M, 0, At=M).values
        if alg.STATS["resident"] != 1:
            raise AssertionError("side-3072 bfs with the budget lifted must take the resident route")
    lev = cg.shortest_path(a, method="D", unweighted=True, indices=0)
    check_close("road bfs side 3072", v, torch.from_numpy((lev + 1).astype(np.int32)).to(DEVICE), True)
    row = RL.time_run("bfs", M, 0, 5)
    if row["rounds"] != 2 * SIDE_BIG - 1:
        raise AssertionError(f"side-3072 bfs: {row['rounds']} rounds, want {2 * SIDE_BIG - 1}")
    print(f"time bfs_resident side {SIDE_BIG} (budget lifted) n={row['n']} nnz={row['nnz']}: "
          f"{row['ms']:.4f} ms, {row['rounds']} rounds, {row['wide']} wide, {row['us_per_round']:.4f} us a "
          f"round; equal to scipy; kernel6_side3072_gteps {row['nnz'] / row['ms'] / 1e6:.4f} "
          f"(entries over the kernel's CUDA-event time) [{card}]", flush=True)


@contextlib.contextmanager
def list_sizes():
    """The level loop's lists, as each count read finds them: yields the list
    of (k, E) that the reads append to."""
    read, sizes = alg._host_count, []

    def record(S):
        count = read(S)
        sizes.append((S.k, S.edges))
        return count

    alg._host_count = record
    try:
        yield sizes
    finally:
        alg._host_count = read


def push_level_bytes(kind, M, source, sizes):
    """Bytes a run's push levels need, each read or written once, from each
    level's list (k vertices, E edges) and the next list's k.  A listed
    vertex: its slot, offset and indptr pair, its depth written and front
    byte cleared (BFS) or its distance read and changed byte cleared (SSSP),
    21 bytes; an edge: its column (BFS, 4) and value (SSSP, 8); a vertex of
    the next list: its bit or hits slot, front or changed byte, slot,
    offset and degree (BFS 17; SSSP adds its distance read and written and
    its hits slot reset, 29).  Targets that the level reaches but does not
    list are not counted."""
    ip = M.indptr
    cur = [(1, int(ip[source + 1] - ip[source]))] + sizes[:-1]
    per_edge, per_next = (4, 17) if kind == "bfs" else (8, 29)
    return sum(21 * k + per_edge * e for k, e in cur) + per_next * sum(k for k, _ in sizes)


def plain_level_ms(kind, M, levels=100):
    """The plain versions' time a level (host clock, count read included),
    over the first ``levels`` levels of a run from vertex 0, all pushed."""
    At = alg._default_At(M)
    S = (KF.bfs_state if kind == "bfs" else KF.sssp_state)(M, 0)
    torch.cuda.synchronize()
    t0, done = time.perf_counter(), 0
    while done < levels and S.k > 0:
        plain_level(kind, S, At, True)
        KF.read_count(S)
        done += 1
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / done


def time_levels(G, card):
    """The level loop on the road grids (budget 0; every level pushes) and
    the skewed graph: wall, us a level, its split into count reads and the
    host's own time, and from one torch.profiler run each the device's time
    a level; the push levels' rows (their time a level in the loop and on
    the device, the plain versions', and the bound of what the run's
    frontiers need); the skewed walls."""
    times, per_level = {}, {}
    dev = torch.device(DEVICE)
    for label, kind, M in (("side 1024", "bfs", G["Road"]), ("side 512", "sssp", G["RoadW"]),
                           (f"side {SIDE_BIG}", "bfs", G["Road3072"])):
        row = LT.loop_row(kind, M, dev)
        prof = LT.profile_row(kind, M, row["wall_ms"], row["levels"])
        if row["pull"]:
            raise AssertionError(f"road {kind} {label}: {row['pull']} pull levels; every level should push")
        per_level[label] = prof["device_us_per_level"]
        print(f"time road {kind} {label} level loop n={M.shape[0]}: wall {row['wall_ms']:.3f} ms, "
              f"{row['levels']} levels, {row['us_per_level']:.3f} us a level (count reads "
              f"{row['read_ms']:.3f} ms, the host's own {row['host_ms']:.3f}); device "
              f"{prof['device_us_per_level']:.3f} us a push level ({prof['kernel_us_per_level']:.3f} in "
              f"kernels), idle share "
              f"{prof['idle_share']:.3f}; items {json.dumps(prof['items'])} [{card}]", flush=True)
        if label in ("side 1024", "side 512"):
            with resident_budget(0), list_sizes() as sizes:
                (alg.bfs if kind == "bfs" else alg.sssp)(M, 0)
            levels = row["levels"]
            nbytes = push_level_bytes(kind, M, 0, sizes) / levels
            times[f"{kind}_push_level"] = (row["wall_ms"] / levels, plain_level_ms(kind, M), *bound(nbytes))
            DEVICE_MS[f"{kind}_push_level"] = prof["kernel_busy_ms"] / levels
            print(f"bound {kind}_push_level: {nbytes:.1f} bytes a level, the mean over the run's {levels} "
                  f"levels of what each frontier needs (its list and rows, the vertices it lists next; "
                  f"n not counted) [{card}]", flush=True)
    ratio = per_level[f"side {SIDE_BIG}"] / per_level["side 1024"]
    print(f"device us a push level: side 1024 {per_level['side 1024']:.3f}, side {SIDE_BIG} "
          f"{per_level[f'side {SIDE_BIG}']:.3f} (x{ratio:.3f} for 9x the vertices) [{card}]", flush=True)
    for kind in ("bfs", "sssp"):
        row = LT.loop_row(kind, G["Skew"], dev)
        print(f"time skewed {kind} n={N_SKEW} nnz={int(G['Skew'].nnz)}: wall {row['wall_ms']:.3f} ms (median "
              f"of 3; runs {', '.join(f'{w:.3f}' for w in row['walls_ms'])}), {row['levels']} levels "
              f"({row['push']} push, {row['pull']} pull), count reads {row['read_ms']:.3f} ms [{card}]",
              flush=True)
    return times


def bound(nbytes, flops=0):
    """``(bound_ms, bound_by)``: the larger of the bytes over the HBM rate
    and the f32 operations over the f32 rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_S * 1e3, flops / F32_FLOPS_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def spmv_bound(M):
    """A MULT/PLUS pull SpMV: indptr, cols, values and x read once, out written once."""
    m, n = M.shape
    nnz = int(M.nnz)
    return bound(4 * (m + 1) + 8 * nnz + 4 * n + 4 * m, 2 * nnz)


def probe_bound(phase, M, nunits):
    m, n = M.shape
    nnz = int(M.nnz)
    ip, chain = 4 * (m + 1), 2 * K8.CHAIN * nnz
    ctas = -(-m // K8.ROWS_PER_CTA)
    tiles = -(-M.capacity // K8.FLAT_TILE)
    ring = 16 * nunits + 4 * nunits  # the unit descriptors and one output a unit
    resident = 8 * min((K7.MAX_STAGE + 11) & ~3, M.capacity)  # ring_fold's words of cols and values
    return {"stream": bound(ip + 8 * nnz + 8 * m, nnz),
            "gather": bound(ip + 8 * nnz + 4 * n + 4 * ctas, 2 * nnz),
            "fullfix": bound(ip + 8 * nnz + 4 * n + 4 * ctas, 2 * nnz),
            "alu": bound(ip + 4 * m, chain),
            "xgather": bound(ip + 4 * n + 4 * m, nnz),
            "ring_copy": bound(ip + 8 * nnz + ring),
            "ring_alu": bound(ip + ring, chain),
            "ring_copy_alu": bound(ip + 8 * nnz + ring + 4 * nunits, chain),
            "warp_row": bound(ip + 8 * nnz + 4 * n + 4 * m, 2 * nnz),
            # indptr[m], the stream and per tile one sum (and a checksum)
            "flat_stream": bound(4 + 8 * nnz + 8 * tiles, nnz),
            "flat_gather": bound(4 + 8 * nnz + 4 * n + 4 * tiles, 2 * nnz),
            # indptr, the resident words, x and the output; no stream
            "ring_fold": bound(ip + resident + 4 * n + 4 * m, 2 * nnz)}[phase]


def with_team(M, g):
    """M with an indptr of its own, whose kernel-1 plan walks rows in teams
    of g lanes (the rest of the plan as M's): kernel 1 at another team size
    than the one pull_plan picks, for the timings only."""
    N = replace(M, indptr=M.indptr.clone())
    K1._PLANS.put(N.indptr, replace(K1.pull_plan(M), team=g))
    return N


def time_pull(G, card):
    """Kernel 1 beside its first, warp-per-row design (kernel 8's warp_row),
    kernel 7 at 2, 3 and 4 slots, kernel 8's ring_copy, ring_fold and
    flat_gather (the phases that bound kernel 7), cuSPARSE (one
    ``torch.sparse_csr_tensor @ x`` call: the library's time, not a port)
    and kernel 1 at every team size, in turns (forward, then backward),
    MULT/PLUS f32, on the n = 2^21, powerlaw and hub graphs; then kernel 7's
    plain version.  Returns kernel 7's row and the library time on the
    n = 2^21 graph."""
    for label, key in (("n=2^21", "M"), ("powerlaw", "P"), ("hub", "H")):
        M = G[key]
        n, nnz = M.shape[0], int(M.nnz)
        gb_model = (nnz * 12 + n * 4 + (n + 1) * 4) / 1e9  # bench.py:207
        x = torch.from_numpy(np.random.default_rng(1).random(n, dtype=np.float32)).to(DEVICE)
        lib = torch.sparse_csr_tensor(M.indptr, M.cols, M.values, size=(n, n), check_invariants=False)
        torch.testing.assert_close(lib @ x, K1.spmv_pull(M, x, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)[0],
                                   rtol=1e-5, atol=1e-5, msg="cuSPARSE against kernel 1")
        fns = {"kernel 1": lambda: K1.spmv_pull(M, x, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0),
               "warp_row": lambda: K8.spmv_probe("warp_row", M, x),
               **{f"kernel 7 slots={s}": (lambda s=s: K7.spmv_pull_staged(M, x, op.MULT_FLOAT, op.PLUS_FLOAT,
                                                                          0.0, slots=s))
                  for s in K7.SLOT_COUNTS},
               **{phase: (lambda phase=phase: K8.spmv_probe(phase, M, x))
                  for phase in ("ring_copy", "ring_fold", "flat_gather")},
               "cuSPARSE": lambda: lib @ x}
        for g in (2, 4, 8, 16, 32):
            Mg = with_team(M, g)
            fns[f"kernel 1 G={g}"] = (lambda Mg=Mg: K1.spmv_pull(Mg, x, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0))
        ms = {name: 0.0 for name in fns}
        for order in (list(fns), list(fns)[::-1]):
            for name in order:
                ms[name] += cuda_ms(fns[name]) / 2
        plan = K7.staged_plan(M)
        print(f"kernel 1 on {label}: {plan_line(M)}; kernel 7: {plan.nunits} units, {plan.nhub} rows of "
              f"several chunks", flush=True)
        for name, t in ms.items():
            print(f"time {name} MULT/PLUS f32 {label} n={n} nnz={nnz}: {t:.4f} ms ({gb_model / t * 1e3:.1f} "
                  f"GB/s-model) [{card}]", flush=True)
        if key == "M":
            kept = ms
    M = G["M"]
    x = torch.from_numpy(np.random.default_rng(1).random(M.shape[0], dtype=np.float32)).to(DEVICE)
    plain = cuda_ms(lambda: K7.spmv_pull_staged_plain(M, x, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0),
                    PLAIN_RUNS_BIG, 1)
    print(f"time kernel 7 plain version: {plain:.4f} ms [{card}]", flush=True)
    default = f"kernel 7 slots={K7.resolve_slots(None)}"
    # kernel 1's function, so kernel 1's bound: the plan's unit descriptors are this design's bytes
    return {"spmv_pull_staged": (kept[default], plain, *spmv_bound(M))}, kept["cuSPARSE"]


def time_probes(G, R, card):
    """The probe table of phase 4's probe_spmv run, then each kernel-8 phase
    against its plain version (CUDA events) on the same graph."""
    probe = R["probe"]
    print(f"probe_spmv n={probe['n']} nnz={probe['nnz']} ({probe['iters']} launches each; "
          f"torch_sum is a library reference, not a port) [{card}]:")
    for name, ns in probe["ns_per_entry"].items():
        print(f"  {name:14s} {ns:8.4f} ns/entry  {probe['ms'][name]:.4f} ms", flush=True)
    M = G["M"]
    x = torch.from_numpy(np.random.default_rng(1).random(M.shape[1], dtype=np.float32)).to(DEVICE)
    nunits = K7.staged_plan(M).nunits
    times = {}
    for phase in PROBE_PHASES:
        k, p = paired_ms(lambda: K8.spmv_probe(phase, M, x), lambda: K8.spmv_probe_plain(phase, M, x),
                         PLAIN_RUNS_BIG)
        times[f"spmv_probe_{phase}"] = (k, p, *probe_bound(phase, M, nunits))
        print(f"time spmv_probe {phase}: kernel {k:.4f} ms, plain {p:.4f} ms [{card}]", flush=True)
    return times


def time_variants(G, card):
    """ab_spmv's chained steps on the n = 2^21 graph: kernel 1, kernel 1 over
    2 and 4 row-split parts on their own streams, kernel 7 at 2-4 slots;
    forward, then backward, averaged."""
    M = G["M"]
    n, nnz = M.shape[0], int(M.nnz)
    x = torch.from_numpy(np.random.default_rng(1).random(n, dtype=np.float32)).to(DEVICE)
    runs = {name: AB.chained(AB.variant_spmv(M, manual, variant, torch.device(DEVICE))[0])
            for name, manual, variant in (("warp", 0, "warp"), ("split2", 0, "split2"),
                                          ("split4", 0, "split4"), ("manual 2", 2, "warp"),
                                          ("manual 3", 3, "warp"), ("manual 4", 4, "warp"))}
    ms = {name: 0.0 for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            ms[name] += AB.timed_ms(runs[name], x, AB_ITERS, torch.device(DEVICE)) / 2
    bytes_model = nnz * 12 + n * 8 + 4  # tools/ab_spmv.py:201
    for name, t in ms.items():
        print(f"time ab_spmv {name}: {t:.4f} ms a chained step ({bytes_model / t / 1e6:.1f} "
              f"GB/s-model) [{card}]", flush=True)


def mxm_bound(A, C, products):
    """Kernel 9 on A @ A: A's indptr, columns and values read once, C's
    indptr, columns, values and row ids written once; 2 operations a
    product."""
    nnz_a, nnz_c = int(A.nnz), int(C.nnz)
    return bound(4 * (A.shape[0] + 1) + 8 * nnz_a + 4 * (C.shape[0] + 1) + 12 * nnz_c, 2 * products)


def time_mxm(G, card):
    """Kernel 9 (MULT/PLUS f32, A @ A) against its plain version and
    cuSPARSE (``torch.sparse.mm`` of two CSR tensors: the library's time,
    not a port) on the 2^13, 2^20 and skewed graphs; a cuSPARSE failure is
    printed as that graph's result.  Then mxm_mprod_s at n = 2^13, chained
    as bench_suite.py:534-552 chains it (B's values scaled by a device
    scalar from the last result).  Returns the n = 2^20 row and its
    library time."""
    rows = {}
    for label, M in (("n=2^13", G["MX13"]), ("n=2^20", G["Aw"]), ("skewed", G["Skew"])):
        n, nnz = M.shape[0], int(M.nnz)
        products = K9.mxm_plan(M, M).products
        kfn = lambda M=M: K9.mxm(M, M, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
        pfn = lambda M=M: K9.mxm_plain(M, M, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
        if label == "n=2^13":
            k, p = paired_ms(kfn, pfn)
        else:  # the plain version takes seconds here: one call
            k, p = cuda_ms(kfn, 5, 1), cuda_ms(pfn, 1, 0)
        C = kfn()
        bound_ms, bound_by = mxm_bound(M, C, products)
        lib_ms, lib_note = None, ""
        L = torch.sparse_csr_tensor(M.indptr, M.cols[:nnz], M.values[:nnz], size=(n, n))
        try:
            if label == "n=2^13":  # the yardstick computes the same C: its entry count and sum
                ref = torch.sparse.mm(L, L)
                want = float(C.values[:int(C.nnz)].double().sum())
                if ref._nnz() != int(C.nnz) or abs(float(ref.values().double().sum()) - want) > 1e-5 * want:
                    raise AssertionError("cuSPARSE's A @ A differs from kernel 9's at n=2^13")
                del ref
            lib_ms = cuda_ms(lambda: torch.sparse.mm(L, L), 5 if label == "n=2^13" else 2, 1)
            lib_note = f"cuSPARSE {lib_ms:.4f} ms"
        except RuntimeError as e:  # out of memory, or a refusal: this graph's library result
            lib_note = f"cuSPARSE failed: {type(e).__name__}: {str(e).splitlines()[0][:200]}"
        del L
        torch.cuda.empty_cache()
        print(f"time spgemm_mxm MULT/PLUS f32 {label} n={n} nnz={nnz} products={products} C nnz={int(C.nnz)}: "
              f"kernel {k:.4f} ms ({products / k / 1e3:.1f} Mproducts/s), plain {p:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}); {lib_note} [{card}]", flush=True)
        rows[label] = (k, p, bound_ms, bound_by, lib_ms)
        del C
    A = G["MX13"]
    products = K9.mxm_plan(A, A).products
    mxm(A, A, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
    walls = []
    for _ in range(3):
        s = torch.ones((), device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(MXM_CHAIN):
            R = mxm(A, replace(A, values=A.values * s), op.MULT_FLOAT, op.PLUS_FLOAT, 0.0,
                    check_init_sparsify=False)
            s = 1.0 + R.values[0] * 0 + (k + 1) * 1e-9
        float(s)
        walls.append((time.perf_counter() - t0) / MXM_CHAIN)
    wall = sorted(walls)[1]
    print(f"time mxm_mprod_s n=2^13: {products / wall / 1e6:.1f} Mproducts/s, {wall * 1e3:.4f} ms a call "
          f"(median of 3 chains of {MXM_CHAIN}; {', '.join(f'{w * 1e3:.4f}' for w in walls)}) [{card}]", flush=True)
    return {"spgemm_mxm": rows["n=2^20"][:4]}, rows["n=2^20"][4]


def library_call(name, fn):
    """``(ms, note)`` of one PyTorch call that computes the same function;
    a failure (out of memory, a refusal) is printed as the result."""
    try:
        fn()
        torch.cuda.synchronize()
        ms = cuda_ms(fn, 5, 1)
        return ms, f"library {name} {ms:.4f} ms"
    except RuntimeError as e:
        return None, f"library {name} failed: {type(e).__name__}: {str(e).splitlines()[0][:200]}"


def time_ops(G, R, card):
    """Each ops call (CUDA events; 5 calls after 1 for the matrix ops of
    33.5 M entries, 20 after 3 for the rest) beside its bound (``bound`` of
    ``tools/ops_times.py``'s ``work``) and, where one PyTorch call computes
    the same function, that call's time: ``to_sparse_csc()`` for
    m_transpose, ``A + B`` of two CSR tensors for m_eadd PLUS and
    ``torch.sparse_bsr_tensor(...) @ X`` for bsr_spmm.  Returns the rows of
    the ops JSON line."""
    I = G["ops"]
    bounds = {name: bound(*w) for name, w in OT.work(I, R).items()}
    library = OT.library(I)
    big = {"m_transpose", "m_eadd", "m_emult", "kron"}
    rows = []
    for name, call in OT.calls(I).items():
        ms = cuda_ms(call, 5, 1) if name in big else cuda_ms(call)
        bound_ms, bound_by = bounds[name]
        lib_ms, note = library_call(*library[name]) if name in library else (None, "no library call")
        torch.cuda.empty_cache()
        print(f"time op {name}: {ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); {note} [{card}]", flush=True)
        rows.append({"name": name, "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                     "library": library[name][0] if name in library else None})
    return rows

def host_us(fn, calls=FACADE_HOST_CALLS):
    """Host microseconds a call: ``calls`` calls issued with no wait, after one."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def device_busy(fn):
    """One call of ``fn`` under torch.profiler: the device's busy ms (the
    union of its kernel, copy and memset spans) and the count of those spans."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, last = 0.0, float("-inf")
    for start, stop in spans:
        busy += max(0.0, stop - max(start, last))
        last = max(last, stop)
    return busy / 1e3, len(spans)


def host_profile(fn, top=6):
    """One call of ``fn`` under torch.profiler: its wall, the device's busy
    ms and idle share, and the ``top`` operators by the host's own time."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, last = 0.0, float("-inf")
    for start, stop in spans:
        busy += max(0.0, stop - max(start, last))
        last = max(last, stop)
    ops = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)[:top]
    return {"wall_ms": wall, "busy_ms": busy / 1e3, "idle_share": 1 - busy / 1e3 / wall,
            "host_ms_by_op": {e.key[:48]: [round(e.self_cpu_time_total / 1e3, 3), e.count] for e in ops}}


def overlap_profile(mesh, sh):
    """One dist_pagerank_pallas_overlap under torch.profiler: its wall, the
    device's busy ms (the union of kernel, copy and memset spans), the
    collective's spans (NCCL's kernels, or its copies at world 1) and how
    long kernel 1 ran while one of them did."""
    from torch.autograd import DeviceType

    fn = lambda: DT.CALLS["pr_pallas_overlap"](mesh, sh)  # noqa: E731
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy, last = 0.0, float("-inf")
    for _, start, stop in sorted(ev, key=lambda e: e[1]):
        busy += max(0.0, stop - max(start, last))
        last = max(last, stop)
    coll = [e for e in ev if "nccl" in e[0].lower()]
    k1 = [e for e in ev if "spmv_pull" in e[0]]
    both = sum(max(0.0, min(a[2], b[2]) - max(a[1], b[1])) for a in coll for b in k1)
    return {"wall_ms": wall, "busy_ms": busy / 1e3, "idle_share": 1 - busy / 1e3 / wall, "items": len(ev),
            "nccl_items": len(coll), "nccl_names": sorted({e[0][:60] for e in coll}), "kernel1_items": len(k1),
            "kernel1_ms": sum(e[2] - e[1] for e in k1) / 1e3, "overlap_ms": both / 1e3}


def time_dist(G, R, card):
    """(a)'s walls beside the single-card walls on the same graphs, with each
    function's iterations, host reads, logical comm bytes and kernel 1
    launches; one profiled overlap step; (b)'s host-staged walls."""
    mesh, one = R["mesh"], R["one"]
    ms = DT.time_all(mesh, R["shards"], list(one))
    single = {"pr": wall_ms(lambda: alg.pr(G["Ap"], 0.85, DT.EPS)),
              "bfs": wall_ms(lambda: alg.bfs(G["Aint"], 0, At=G["Aint"])),
              "sssp": wall_ms(lambda: alg.sssp(G["Aw"], 0)),
              "spmv": cuda_ms(lambda: K1.spmv_pull(G["M"], R["shards"]["x"], op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)),
              "tc": wall_ms(lambda: alg.tc(G["T"])), "tc_big": wall_ms(lambda: alg.tc(G["Aint"])),
              "mxm": wall_ms(lambda: mxm(G["MX13"], G["MX13"], op.MULT_FLOAT, op.PLUS_FLOAT, 0.0))}
    with resident_budget(0):
        single["road_bfs"] = wall_ms(lambda: alg.bfs(G["Road"], 0, At=G["Road"]))
    rows = {}
    for name, r in one.items():
        base = single.get(name) or single.get(name.split("_")[0])
        rows[name] = {"ms": ms[name], "single_ms": base, "ratio": ms[name] / base if base else None,
                      "iterations": r["iterations"], "host_reads": r["host_reads"],
                      "comm_bytes": (r["stats"] or {}).get("comm_bytes"), "moved_bytes": r["comm"].get("bytes", 0),
                      "kernel1_launches": r["launches"].get("spmv_pull", 0),
                      "kernel4_launches": r["launches"].get("mxmt_reduce", 0)}
        print(f"time dist {name} (world of 1, NCCL): {ms[name]:.3f} ms, single card {base:.3f} ms "
              f"({single_name(name)}), {r['iterations']} iterations, {r['host_reads']} host reads, "
              f"{rows[name]['kernel1_launches']} kernel-1 launches [{card}]", flush=True)
    prof = overlap_profile(mesh, R["shards"])
    print(f"time dist pr_pallas_overlap profiled: {json.dumps(prof)} [{card}]", flush=True)
    loops = {name: host_profile(lambda name=name: DT.CALLS[name](mesh, R["shards"])) for name in ("bfs", "road_bfs")}
    for name, p in loops.items():
        print(f"time dist {name} profiled (world of 1, NCCL): {json.dumps(p)} [{card}]", flush=True)
    staged = R["ranks"][0]["ms"]
    small = DT.time_all(mesh, R["small_shards"], list(staged))
    for name, t in staged.items():
        print(f"time dist {name} ({DIST_RANKS} gloo ranks on one card, host-staged, n={DT.SMALL['n']}): "
              f"{t:.3f} ms; world of 1 (NCCL) on the same graph {small[name]:.3f} ms [{card}]", flush=True)
    return {"world1_nccl": rows, "profile": prof, "loop_profiles": loops, "gloo4_host_staged_ms": staged,
            "world1_small_ms": small, "card": card}


def single_name(name):
    return {"spmv": "kernel 1, CUDA events", "tc": "algorithms.tc n=2^15", "tc_big": "algorithms.tc n=2^20",
            "mxm": "ops.mxm", "road_bfs": "algorithms.bfs, level loop"}.get(name, f"algorithms.{name.split('_')[0]}")


def time_facade(G, card):
    """bench_suite.py:349-412's facade_chain_ratio on the card: the facade
    chain (ten Vector.vxm, then reduce read on the host) against its
    functional baseline (``ops.best_spmv_fn`` over the CSR of Sᵀ on
    DenseVecs, the same kernel, then a sum read on the host), host clock
    from a synchronized start, FACADE_PAIRS interleaved pairs whose order
    alternates; the ratio is of the medians.  Then one vxm's host cost (a
    facade vxm against ops.vxm_masked_dense on the same snapshots, in
    turns) and its time by CUDA events.  Returns the facade JSON line's
    object."""
    I = G["facade"]
    n, S = N_FACADE, I["S"]
    M = facade_matrix(S, FLOAT)
    r0 = FC.Vector.from_lists(I["start"], np.ones(I["start"].size, np.float32), n, FLOAT)
    mask = FC.Vector(n, FLOAT)
    At = F.csr_transpose_host(F.csr_from_scipy(S, device=DEVICE))
    spmv_fn = O.best_spmv_fn(At, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
    x0 = torch.zeros(n, dtype=torch.float32, device=DEVICE)
    x0[torch.from_numpy(I["start"]).to(DEVICE)] = 1.0
    zero = torch.zeros((), dtype=torch.float32, device=DEVICE)

    def chain_facade():
        return facade_chain(r0, mask, M)[1]

    def chain_functional():
        r = DenseVec(x0, zero)
        for _ in range(FACADE_CHAIN):
            r = DenseVec(spmv_fn(At, r.values), zero)
        return float(r.values.sum())

    sums = (chain_facade(), chain_functional())
    if abs(sums[0] - sums[1]) > 1e-5 * abs(sums[1]):
        raise AssertionError(f"facade chain {sums[0]} and its functional baseline {sums[1]} differ")
    walls = {"facade": [], "functional": []}
    for i in range(FACADE_PAIRS):
        for name in ("facade", "functional")[:: 1 if i % 2 == 0 else -1]:
            fn = chain_facade if name == "facade" else chain_functional
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    f_ms, fn_ms = (float(np.median(walls[k])) for k in ("facade", "functional"))
    (f_busy, f_items), (fn_busy, fn_items) = device_busy(chain_facade), device_busy(chain_functional)
    mask_d, r0_d, Mt = mask._device(), r0._device(), M._device_t()

    def vxm_facade():
        return r0.vxm(mask, M, FLOAT.MULT, FLOAT.PLUS, FLOAT.ALWAYS)

    def vxm_dense():
        return O.vxm_masked_dense(mask_d, r0_d, Mt, op.MULT_FLOAT, op.PLUS_FLOAT, op.ALWAYS_FLOAT, 0.0)

    hf1, hd1, hd2, hf2 = host_us(vxm_facade), host_us(vxm_dense), host_us(vxm_dense), host_us(vxm_facade)
    row = {"name": "facade_chain", "n": n, "nnz": int(S.nnz), "steps": FACADE_CHAIN, "pairs": FACADE_PAIRS,
           "facade_ms": f_ms, "functional_ms": fn_ms, "facade_chain_ratio": f_ms / fn_ms,
           "facade_runs_ms": walls["facade"], "functional_runs_ms": walls["functional"],
           "vxm_host_us": (hf1 + hf2) / 2, "vxm_masked_dense_host_us": (hd1 + hd2) / 2,
           "vxm_ms": cuda_ms(vxm_facade), "vxm_masked_dense_ms": cuda_ms(vxm_dense),
           "facade_device_busy_ms": f_busy, "facade_device_items": f_items, "facade_idle_share": 1 - f_busy / f_ms,
           "functional_device_busy_ms": fn_busy, "functional_device_items": fn_items,
           "functional_idle_share": 1 - fn_busy / fn_ms, "card": card}
    print(f"time facade chain n=2^18: facade {f_ms:.4f} ms, functional {fn_ms:.4f} ms, facade_chain_ratio "
          f"{f_ms / fn_ms:.4f} (medians of {FACADE_PAIRS} interleaved pairs); one vxm: host "
          f"{row['vxm_host_us']:.1f} us (vxm_masked_dense {row['vxm_masked_dense_host_us']:.1f}), events "
          f"{row['vxm_ms']:.4f} ms ({row['vxm_masked_dense_ms']:.4f}); device busy {f_busy:.4f} ms in {f_items} "
          f"items, idle share {row['facade_idle_share']:.3f} (functional {fn_busy:.4f} ms, {fn_items} items, "
          f"{row['functional_idle_share']:.3f}) [{card}]", flush=True)
    return row


# ---------------------------------------------------------------- main


def main():
    phase("1 device")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(f"device: {name} (count {torch.cuda.device_count()}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi, flush=True)

    phase("2 build")
    t0 = time.perf_counter()
    load_library()
    print(f"built and loaded the CUDA kernels in {time.perf_counter() - t0:.1f} s")
    for kind in ("bfs", "sssp"):
        for team in (2, 4, 8, 16, 32):
            ctas, cluster, regs = K6.resident_grid(kind, team)
            print(f"kernel 6 ({kind}, teams of {team}): a cooperative grid of {ctas} CTAs of "
                  f"{K6.CTA_THREADS} threads in clusters of {cluster}, {regs} registers a thread")
    for line in build_log().splitlines():
        if any(k in line for k in ("registers", "Compiling entry", "spill", "smem")):
            print(line.strip())

    t0 = time.perf_counter()
    G = build_graphs()
    print(f"graphs made in {time.perf_counter() - t0:.1f} s", flush=True)

    phase("3 kernels against their plain versions")
    errs = check_kernels(G)
    errs.update(check_push_levels(G))
    errs.update(check_mxmt(G))
    errs.update(check_mxm(G))
    errs.update(check_resident(G))
    errs.update(check_staged(G))
    torch.cuda.synchronize()

    phase("4 the slices through the public entry points")
    launches, stats, astats, results = {}, {}, {}, {}
    for slice_name, run, check in (("spmv", run_slice, check_slice),
                                   ("push", run_push, check_push),
                                   ("skewed", run_skewed, check_skewed),
                                   ("spgemm", run_spgemm, check_spgemm),
                                   ("road", run_road, check_road),
                                   ("staged", run_staged, check_staged_path),
                                   ("probes", run_probes, check_probes),
                                   ("mxm", run_mxm, check_mxm_slice),
                                   ("ops", run_ops, check_ops),
                                   ("facade", run_facade, check_facade),
                                   ("dist", run_dist, check_dist)):
        kernels.reset_launches()
        for k in DISPATCH_STATS:
            DISPATCH_STATS[k] = 0
        for k in alg.STATS:
            alg.STATS[k] = 0
        t0 = time.perf_counter()
        R = run(G)
        launches[slice_name], stats[slice_name] = dict(kernels.LAUNCHES), dict(DISPATCH_STATS)
        astats[slice_name] = dict(alg.STATS)
        print(f"{slice_name} main path ran in {time.perf_counter() - t0:.3f} s", flush=True)
        check(G, R)
        results[slice_name] = R

    phase("5 launch counts of phase 4")
    for slice_name, kernel_names in PATHS.items():
        print(f"{slice_name}: DISPATCH_STATS {json.dumps(stats[slice_name])}")
        print(f"{slice_name}: kernels.LAUNCHES {json.dumps(launches[slice_name])}", flush=True)
        for k in kernel_names:
            if launches[slice_name][k] <= 0:
                raise AssertionError(f"kernel {k} was not launched on the {slice_name} main path")
    print(f"spmv: algorithms.STATS {json.dumps(astats['spmv'])}", flush=True)
    if stats["spmv"]["mxv_torch"] or stats["spmv"]["vxm_torch"] or stats["spgemm"]["mxmT_torch"]:
        raise AssertionError("a covered semiring took the torch path")
    if astats["spmv"]["push"] == 0 or astats["spmv"]["pull"] == 0:
        raise AssertionError("the traversals did not run both directions")
    road = astats["road"]
    print(f"road: algorithms.STATS {json.dumps(road)}", flush=True)
    if not road["resident"] == road["host_syncs"] == 2 or road["level_loop"] or road["capped"]:
        raise AssertionError("the road slice must run twice on the resident route, one host sync each")
    if astats["spmv"]["resident"]:
        raise AssertionError("the n = 2^20 traversals must keep the level loop")
    skewed = astats["skewed"]
    print(f"skewed: algorithms.STATS {json.dumps(skewed)}", flush=True)
    if skewed["resident"] or skewed["level_loop"] != 7 or skewed["push"] == 0 or skewed["pull"] == 0:
        raise AssertionError("the skewed graph's six runs and the side-3072 bfs must take the level loop, "
                             "both directions")
    if launches["mxm"]["spgemm_mxm"] != 2 or stats["mxm"]["mxm_kernel"] != 2 or stats["mxm"]["mxm_torch"] != 1:
        raise AssertionError("the mxm slice must launch kernel 9 twice and take the torch path with products_cap")
    print(f"ops: kernels.LAUNCHES {json.dumps(launches['ops'])}", flush=True)
    if any(launches["ops"].values()):
        raise AssertionError("the ops slice launched a kernel: its ops are plain PyTorch")
    facade_want = {"spmv_pull": 2 * FACADE_CHAIN + 4, "spgemm_mxm": 1, "mxmt_masked": 2}
    if ({k: launches["facade"][k] for k in facade_want} != facade_want
            or any(v for k, v in stats["facade"].items() if k.endswith("_torch"))):
        raise AssertionError(f"the facade slice must launch {facade_want} (two chains, mxv and the "
                             f"schedule's three vxm; mxm; mxmT i32 and f32) and take no torch path")
    if stats["dist"]["mxv_torch"] or stats["dist"]["mxmT_torch"]:
        raise AssertionError("the dist slice took the torch path for a covered request")
    staged = astats["staged"]
    print(f"staged: algorithms.STATS {json.dumps(staged)}", flush=True)
    if launches["staged"]["spmv_pull"] or staged["pull"] == 0 or staged["resident"]:
        raise AssertionError("under MANUAL_DMA every f32 and structural pull level must run kernel 7")

    phase("6 times on the card")
    times = time_kernels(G, card)
    time_algorithms(G, card)
    times.update(time_spgemm(G, card))
    times.update(time_road(G, card))
    times.update(time_levels(G, card))
    staged_times, cusparse_ms = time_pull(G, card)
    times.update(staged_times)
    times.update(time_probes(G, results["probes"], card))
    time_variants(G, card)
    mxm_times, mxm_library_ms = time_mxm(G, card)
    times.update(mxm_times)
    ops_rows = time_ops(G, results["ops"], card)
    facade_row = time_facade(G, card)
    dist_row = time_dist(G, results["dist"], card)
    torch.distributed.destroy_process_group()

    # one PyTorch call computes the same function only for the pull SpMVs and mxm
    library = {"spmv_pull": cusparse_ms, "spmv_pull_staged": cusparse_ms, "spgemm_mxm": mxm_library_ms}
    rows_out, seen = [], set()
    for slice_name, kernel_names in PATHS.items():
        for k in kernel_names:
            if k in seen:
                continue
            seen.add(k)
            route, source, replaces = KERNELS[k]
            ms, plain_ms, bound_ms, bound_by = times[k]
            row = {"name": k, "route": route, "source": source, "replaces": replaces,
                   "launches": launches[slice_name][k], "max_abs_err": errs[k], "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": library.get(k)}
            if k in DEVICE_MS:
                row["device_ms"] = DEVICE_MS[k]
            rows_out.append(row)
    print(json.dumps({"dist": dist_row}))
    print(json.dumps({"facade": facade_row}))
    print(json.dumps({"ops": ops_rows}))
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


def build_graphs():
    """Every graph of phases 3-6, on DEVICE."""
    indptr, rows, cols, vals = build_graph(N_SPMV, DEG_SPMV)
    G = {"M": csr(indptr, rows, cols, vals, N_SPMV),
         "Minf": csr(indptr, rows, cols, vals, N_SPMV, fill=np.float32(np.inf)),
         "Mi": csr(indptr, rows, cols, (vals * 2000 - 1000).astype(np.int32), N_SPMV)}
    G["ops"] = I = OT.build_inputs(DEVICE, (indptr, rows, cols, vals))
    print(f"graphs: ops A n={N_SPMV} nnz={I['A_sp'].nnz} (capacity {I['A'].capacity}), row {I['row']} and "
          f"column {I['col']} the longest; kron operands nnz {I['KronA_sp'].nnz} and {I['KronB_sp'].nnz}; band "
          f"n={OT.N_BAND} nnz={I['Band_sp'].nnz}", flush=True)
    hp, hr, hc, hv = hub_graph(N_GRAPH)
    G["H"] = csr(hp, hr, hc, hv, N_GRAPH)
    fp, fr, fc, fv = build_graph(N_FEW, 1, seed=4)
    G["Few"] = csr(fp, fr, fc, fv, N_FEW)
    G["Hi"] = csr(hp, hr, hc, (hv * 2000 - 1000).astype(np.int32), N_GRAPH)
    pp, pr_, pc, pv = powerlaw_graph(N_SPMV, DEG_SPMV)
    G["P"], G["Pi"] = csr(pp, pr_, pc, pv, N_SPMV), csr(pp, pr_, pc, (pv * 2000 - 1000).astype(np.int32), N_SPMV)
    for d in SMALL_DEGREES:
        sp_, sr, sc, sv = build_graph(N_SMALL, d, seed=d)
        G[f"S{d}"] = csr(sp_, sr, sc, sv, N_SMALL)
        G[f"S{d}i"] = csr(sp_, sr, sc, (sv * 2000 - 1000).astype(np.int32), N_SMALL)
    a = random_graph(N_GRAPH, DEG_GRAPH)
    G["A_sp"] = a
    G["Aint"] = F.csr_from_scipy(a.astype(np.int32), device=DEVICE)
    aw = a.copy()
    aw.data = np.random.default_rng(2).uniform(0.1, 2.0, a.nnz).astype(np.float32)
    G["Aw_sp"] = aw
    G["Aw"] = F.csr_from_scipy(aw, fill=np.float32(np.inf), device=DEVICE)
    outdeg = np.asarray(a.sum(axis=0)).ravel()
    outdeg[outdeg == 0] = 1
    G["Ap"] = F.csr_from_scipy(a.multiply(0.85 / outdeg).tocsr().astype(np.float32), device=DEVICE)
    t = random_graph(N_TC, DEG_TC, seed=SEED_TC)
    G["T_sp"] = t
    G["T"] = F.csr_from_scipy(t.astype(np.int32), device=DEVICE)
    G["Tw_f32"], G["Tw_i32"] = valued(t, 5, -2.0, 2.0)
    G["Tm_f32"], G["Tm_i32"] = signed_mask(t, np.float32, 6), signed_mask(t, np.int32, 6)
    ah, mh = hub_spgemm(N_HUB_TC, hub_len=HUB_LEN_TC)
    G["HTw_f32"], G["HTw_i32"] = valued(ah, 7, 0.5, 1.5)
    G["HTm_f32"], G["HTm_i32"] = signed_mask(mh, np.float32, 8), signed_mask(mh, np.int32, 8)
    road, road_w = road_graphs(SIDE_BFS, SIDE_SSSP, SEED_ROAD)
    G["Road_sp"], G["Road"] = road, F.csr_from_scipy(road, device=DEVICE)
    G["RoadW_sp"], G["RoadW"] = road_w, F.csr_from_scipy(road_w, fill=np.float32(np.inf), device=DEVICE)
    path = path_graph(RL.PATH_N)
    G["Path"], G["PathW"] = F.csr_from_scipy(path, fill=np.float32(np.inf), device=DEVICE), path.diagonal(1)
    G["Barbell"] = F.csr_from_scipy(barbell_graph(*RL.BARBELL), fill=np.float32(np.inf), device=DEVICE)
    G["Rand18"] = F.csr_from_scipy(RL.weighted_random(), fill=np.float32(np.inf), device=DEVICE)
    a_bins, b_bins = spgemm_bins()
    G["Bins_f32"] = tuple(F.csr_from_scipy(x, device=DEVICE) for x in (a_bins, b_bins))
    G["Bins_i32"] = tuple(F.csr_from_scipy((x * 1000).astype(np.int32), device=DEVICE) for x in (a_bins, b_bins))
    a_bins, b_bins = spgemm_bins(1 << 20)
    G["Bins20_f32"] = tuple(F.csr_from_scipy(x, device=DEVICE) for x in (a_bins, b_bins))
    G["Bins20_i32"] = tuple(F.csr_from_scipy((x * 1000).astype(np.int32), device=DEVICE) for x in (a_bins, b_bins))
    mx = random_graph(N_MXM, DEG_MXM, seed=SEED_MXM)
    rng = np.random.default_rng(11)
    mx.data = rng.uniform(0.5, 1.5, mx.nnz).astype(np.float32)
    G["MX13_sp"], G["MX13"] = mx, F.csr_from_scipy(mx, device=DEVICE)
    G["MX13inf"] = F.csr_from_scipy(mx, fill=np.float32(np.inf), device=DEVICE)
    mi = mx.astype(np.int32)
    mi.data = rng.integers(1, 10, mx.nnz).astype(np.int32)
    G["MX13i"] = F.csr_from_scipy(mi, device=DEVICE)
    mi.data = rng.choice([-1, 1], mx.nnz).astype(np.int32)
    G["MX13pm"] = F.csr_from_scipy(mi, device=DEVICE)
    sk = skewed_graph(N_SKEW)
    G["Skew_sp"], G["Skew"] = sk, F.csr_from_scipy(sk, fill=np.float32(np.inf), device=DEVICE)
    G["skew_hub"] = int(np.argmax(np.diff(sk.indptr)))
    fa = random_graph(N_FACADE, DEG_FACADE, seed=SEED_FACADE)
    indeg = np.asarray(fa.sum(axis=0)).ravel()
    tf = t.astype(np.float32)
    tf.data = np.random.default_rng(12).uniform(0.5, 1.5, t.nnz).astype(np.float32)
    G["facade"] = {"S": (fa @ sp.diags(0.85 / np.maximum(indeg, 1))).tocsr().astype(np.float32),
                   "start": np.arange(0, N_FACADE, N_FACADE // 1024), "T_i32": t.astype(np.int32), "T_f32": tf}
    print(f"graphs: facade chain n={N_FACADE} nnz={G['facade']['S'].nnz}", flush=True)
    big = road_grid(SIDE_BIG)
    G["Road3072_sp"], G["Road3072"] = big, F.csr_from_scipy(big, device=DEVICE)
    print(f"graphs: skewed n={N_SKEW} nnz={sk.nnz} (longest row {G['skew_hub']}, "
          f"{int(np.diff(sk.indptr).max())} entries); road n={big.shape[0]} nnz={big.nnz}", flush=True)
    print(f"graphs: spmv n={N_SPMV} nnz={rows.size}; hub n={N_GRAPH} nnz={hr.size}; powerlaw "
          f"n={N_SPMV} nnz={pr_.size}; n={N_SMALL} at degrees {SMALL_DEGREES}; "
          f"traversal n={N_GRAPH} nnz={a.nnz}; spgemm n={N_TC} nnz={t.nnz}; spgemm hub "
          f"n={N_HUB_TC} nnz={ah.nnz} with a mask of {mh.nnz}; road bfs n={road.shape[0]} "
          f"nnz={road.nnz}; road sssp n={road_w.shape[0]} nnz={road_w.nnz}; kernel 6's path n={RL.PATH_N}, "
          f"barbell n={G['Barbell'].shape[0]} nnz={int(G['Barbell'].nnz)} and random n={RL.RANDOM_N} "
          f"nnz={int(G['Rand18'].nnz)}; mxm n={N_MXM} nnz={mx.nnz}", flush=True)
    return G


if __name__ == "__main__":
    main()
