"""Distributed masked SpMV and graph algorithms (counterpart of
``spla_tpu/parallel/dist_ops.py``).

1-D row decomposition: each rank owns ``mloc`` rows of the matrix (its
output slots) and gathers the input vector each step.  Each rank calls a
function on its own block and gets its ``[mloc]`` rows back;
``comm.gather_rows`` rebuilds the padded global vector.

The JAX loops are ``lax.while_loop``s inside ``shard_map`` whose exit
scalar is ``psum``-replicated and never leaves the device.  Here each rank
runs the loop on its host and reads one collective result a step: the
error (PageRank), or the ranks' frontier counts gathered in one call (BFS,
SSSP), whose sum ends the loop and whose largest picks the next level's
exchange tier (the JAX loop's ``pmax``).  ``STATS`` counts those reads.
Each step's SpMV is kernel 1 on CUDA tensors when it covers the semiring
(``ops.DISPATCH_STATS`` counts it), its plain version otherwise.

The frontier exchange is capped-sparse, with the JAX package's ladder of
tiers: a level whose largest per-rank frontier fits a tier ships at most
that many indices per rank (and, for SSSP, values); one that fits none
gathers the dense vectors.  The stats count the JAX package's logical
bytes, accumulated in float32 as it does (``dist_ops.py:267``).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from .. import op as OP
from ..containers import CsrMatrix
from ..formats import kept_positions
from ..kernels import spmv as K
from ..ops.spmv import DISPATCH_STATS
from .comm import all_gather, psum
from .dist_matrix import ShardedCsr
from .mesh import Mesh

__all__ = ["STATS", "dist_masked_spmv", "dist_pagerank", "dist_pagerank_overlap", "dist_bfs", "dist_sssp"]

# loops run and their iterations (levels, rounds), and the collective
# results they read on the host, since the last reset
STATS = {"loops": 0, "iterations": 0, "host_reads": 0}

PR_MAX_ITERS = 10_000  # f32 error can plateau above a tiny eps; an uncapped loop would hang every rank


def spmv(A: CsrMatrix, x, op_mul, op_add, init, x_valid=None):
    """One rank's SpMV values: kernel 1 when it covers the semiring on CUDA
    tensors, its plain version otherwise."""
    if A.values.device.type == "cuda" and K.pull_codes(op_mul, op_add, A.values.dtype) is not None:
        DISPATCH_STATS["mxv_kernel"] += 1
        return K.spmv_pull(A, x, op_mul, op_add, init, x_valid=x_valid)[0]
    DISPATCH_STATS["mxv_torch"] += 1
    return K.spmv_pull_plain(A, x, op_mul, op_add, init, x_valid=x_valid)[0]


def spmv_structural(A: CsrMatrix, x_active, row_sel):
    """One rank's structural step: kernel 1's structural variant on CUDA."""
    DISPATCH_STATS["mxv_kernel" if A.cols.device.type == "cuda" else "mxv_torch"] += 1
    return K.spmv_pull_structural(A, x_active, row_sel)


def dist_masked_spmv(mesh: Mesh, A: ShardedCsr, x, op_mul, op_add, init, axis="d"):
    """This rank's rows of ``r = A x`` over (op_mul, op_add); ``x`` is this
    rank's ``[mloc]`` block, gathered first (the halo exchange)."""
    return spmv(A.local_block(), all_gather(mesh, x), op_mul, op_add, init)


# ---------------------------------------------------------------- PageRank


def _gids(mesh: Mesh, mloc: int):
    return mesh.rank * mloc + torch.arange(mloc, dtype=torch.int64, device=mesh.device)


def pagerank_loop(mesh: Mesh, n: int, mloc: int, alpha, eps, product):
    """``p = product(p_prev) + (1 - alpha) / n`` on the live rows until the
    global error ``||p - p_prev||_2 <= eps`` (at most ``PR_MAX_ITERS``),
    with the JAX loop's float32 arithmetic; one psum read a step."""
    f32 = np.float32
    addition = float((f32(1) - f32(alpha)) / f32(n))
    live = _gids(mesh, mloc) < n
    p = torch.where(live, torch.full((mloc,), 1.0 / n, dtype=torch.float32, device=mesh.device), 0.0)
    eps32 = f32(eps)
    err, it = eps32 + f32(0.1), 0
    STATS["loops"] += 1
    while err > eps32 and it < PR_MAX_ITERS:
        p_new = torch.where(live, product(p) + addition, 0.0)
        err2 = psum(mesh, torch.sum((p_new - p) ** 2).reshape(1))
        err = f32(torch.sqrt(err2).item())
        STATS["host_reads"] += 1
        STATS["iterations"] += 1
        p, it = p_new, it + 1
    return p


def dist_pagerank(mesh: Mesh, A: ShardedCsr, alpha, eps, axis="d"):
    """This rank's rows of PageRank (the reference's ``src/algorithm.cpp:278-335``;
    A pre-scaled by alpha / out-degree)."""
    block = A.local_block()
    return pagerank_loop(mesh, A.shape[0], A.mloc, alpha, eps,
                         lambda p: spmv(block, all_gather(mesh, p), OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0))


def overlapped(mesh: Mesh, x, diag_step, off_step):
    """``(diag_step(x), off_step(gathered x))``: the diagonal block's kernel
    is issued while the gather of x is in flight."""
    pending = all_gather(mesh, x, async_op=True)
    local = diag_step(x)
    return local, off_step(pending.wait())


def dist_pagerank_overlap(mesh: Mesh, diag: ShardedCsr, off: ShardedCsr, alpha, eps, axis="d"):
    """PageRank over the diagonal / off-diagonal split
    (``shard_csr_split_diag``): each step's gather runs while the
    diagonal block's SpMV, which needs only this rank's vector, runs on the
    card.  The result equals ``dist_pagerank``'s."""
    if diag.shape[0] != off.shape[0] or diag.mloc != off.mloc:
        raise ValueError("diag and off must split one matrix")
    d, o = diag.local_block(diag.mloc), off.local_block()

    def product(p):
        local, remote = overlapped(mesh, p, lambda x: spmv(d, x, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0),
                                   lambda x: spmv(o, x, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0))
        return local + remote

    return pagerank_loop(mesh, off.shape[0], off.mloc, alpha, eps, product)


# ---------------------------------------------------------------- the frontier exchange


def normalize_caps(frontier_cap, mloc) -> tuple:
    """The cap ladder: None = the two-tier default (mloc/256, mloc/16, at
    least 32 each); an int = one tier; 0 = always dense; a tuple = the
    given tiers, ascending."""
    if frontier_cap is None:
        tiers = (max(mloc // 256, 32), max(mloc // 16, 32))
    elif isinstance(frontier_cap, tuple):
        tiers = frontier_cap
    elif frontier_cap == 0:
        return ()
    else:
        tiers = (int(frontier_cap),)
    return tuple(sorted(set(int(c) for c in tiers if c > 0)))


def _tier(maxcnt: int, caps: tuple):
    """The smallest tier holding every rank's frontier, or None (dense)."""
    return next((c for c in caps if maxcnt <= c), None)


def _tier_bytes(cap, dense_bytes, per_entry, n_shards) -> np.float32:
    """A level's logical gather bytes: the tier's, or the dense vectors'."""
    return np.float32(dense_bytes if cap is None else n_shards * cap * per_entry)


def _sparse_indices(mesh: Mesh, active, mloc: int, cap: int):
    """The global ids of this rank's at most ``cap`` active slots, padded
    with ``S * mloc``, and the positions they came from."""
    pos, ok = kept_positions(active, cap)
    return torch.where(ok, mesh.rank * mloc + pos, mesh.size * mloc).to(torch.int32), pos, ok


def exchange_front(mesh: Mesh, front, mloc: int, cap):
    """Start the gather of the boolean frontier: the dense vectors (cap
    None) or at most ``cap`` indices a rank.  Returns a function that waits
    and gives the ``[S * mloc]`` frontier."""
    n_pad = mesh.size * mloc
    if cap is None:
        return all_gather(mesh, front, async_op=True).wait
    gidx, _, _ = _sparse_indices(mesh, front, mloc, cap)
    pending = all_gather(mesh, gidx, async_op=True)

    def wait():
        full = torch.zeros(n_pad + 1, dtype=torch.bool, device=front.device)
        full[pending.wait().long()] = True
        return full[:n_pad]

    return wait


def exchange_changed(mesh: Mesh, v, changed, mloc: int, cap):
    """Start the gather of SSSP's feedback, ``(v, changed)``: the dense
    vectors (cap None) or at most ``cap`` changed (index, value) pairs a
    rank, unchanged slots arriving as +inf.  Returns a function that waits
    and gives ``(v_full, valid_full)`` of ``S * mloc`` slots."""
    n_pad = mesh.size * mloc
    if cap is None:
        pv, pc = all_gather(mesh, v, async_op=True), all_gather(mesh, changed, async_op=True)
        return lambda: (pv.wait(), pc.wait())
    gidx, pos, ok = _sparse_indices(mesh, changed, mloc, cap)
    gval = torch.where(ok, v[pos], torch.inf)
    pi, pv = all_gather(mesh, gidx, async_op=True), all_gather(mesh, gval, async_op=True)

    def wait():
        idx = pi.wait().long()
        v_full = torch.full((n_pad + 1,), torch.inf, dtype=v.dtype, device=v.device)
        v_full[idx] = pv.wait()
        valid = torch.zeros(n_pad + 1, dtype=torch.bool, device=v.device)
        valid[idx] = True
        return v_full[:n_pad], valid[:n_pad]

    return wait


def _counts(mesh: Mesh, active):
    """``(sum, largest)`` of the ranks' active counts: one gather, one host read."""
    counts = all_gather(mesh, active.sum().reshape(1)).tolist()
    STATS["host_reads"] += 1
    return sum(counts), max(counts)


# ---------------------------------------------------------------- BFS and SSSP


def bfs_loop(mesh: Mesh, mloc: int, source: int, caps: tuple, level, max_depth: int):
    """Depths (1-based, 0 unreached) of this rank's rows from ``source``:
    ``level(front, wait_full, row_sel)`` gives the next frontier, the
    unvisited rows only, from this rank's frontier and the gather's
    ``wait``.  Stops when the frontier empties or past ``max_depth``."""
    gids = _gids(mesh, mloc)
    v = torch.zeros(mloc, dtype=torch.int32, device=mesh.device)
    front = gids == source
    count = 1
    maxcnt = int(0 <= source < mesh.size * mloc)  # the source's rank holds the one frontier vertex
    depth, comm, sparse = 1, np.float32(0), 0
    STATS["loops"] += 1
    while count > 0 and depth <= max_depth:
        v = torch.where(front, depth, v)
        cap = _tier(maxcnt, caps)
        comm = np.float32(comm + _tier_bytes(cap, mesh.size * mloc, 4, mesh.size))
        sparse += cap is not None
        front = level(front, exchange_front(mesh, front, mloc, cap), v == 0)
        count, maxcnt = _counts(mesh, front)
        depth += 1
        STATS["iterations"] += 1
    return v, {"comm_bytes": int(comm), "sparse_levels": sparse, "levels": depth - 1}


def dist_bfs(mesh: Mesh, At: ShardedCsr, source, axis="d", frontier_cap: int | None = None,
             with_stats: bool = False):
    """This rank's BFS depths over the transpose-sharded adjacency.  The
    frontier is exchanged each level by the capped-sparse index gather with
    the tier ladder (``frontier_cap``: None the default ladder, an int one
    tier, a tuple a ladder, 0 always dense).  ``with_stats`` also returns
    ``{"comm_bytes", "sparse_levels", "levels"}`` (logical gather bytes),
    equal on every rank and to the JAX package's at the same S."""
    block = At.local_block()
    v, stats = bfs_loop(mesh, At.mloc, int(source), normalize_caps(frontier_cap, At.mloc),
                        lambda front, wait, row_sel: spmv_structural(block, wait(), row_sel), At.shape[0])
    return (v, stats) if with_stats else v


def sssp_loop(mesh: Mesh, mloc: int, source: int, caps: tuple, relax, first_it: int, max_it: int):
    """Distances of this rank's rows from ``source`` by Bellman-Ford with the
    reference's feedback (only changed entries relax again):
    ``relax(v, changed, wait_full)`` gives the relaxed distances from the
    exchange's ``wait``.  Rounds are numbered from ``first_it`` and stop when
    nothing changes or past ``max_it``."""
    gids = _gids(mesh, mloc)
    changed = gids == source
    v = torch.where(changed, 0.0, torch.inf).to(torch.float32)
    count = 1
    maxcnt = int(0 <= source < mesh.size * mloc)
    it, comm, sparse = first_it, np.float32(0), 0
    STATS["loops"] += 1
    while count > 0 and it <= max_it:
        cap = _tier(maxcnt, caps)
        comm = np.float32(comm + _tier_bytes(cap, mesh.size * mloc * 5, 8, mesh.size))
        sparse += cap is not None
        new_v = OP.MIN_FLOAT(v, relax(v, changed, exchange_changed(mesh, v, changed, mloc, cap)))
        changed = new_v != v
        v = new_v
        count, maxcnt = _counts(mesh, changed)
        it += 1
        STATS["iterations"] += 1
    return v, {"comm_bytes": int(comm), "sparse_rounds": sparse, "rounds": it - first_it}


def _f32(block: CsrMatrix) -> CsrMatrix:
    """The block with f32 weights (min-plus folds distances in f32)."""
    if block.values.dtype == torch.float32:
        return block
    return replace(block, values=block.values.float(), fill=block.fill.float())


def min_plus(block: CsrMatrix, x, x_valid):
    """``min_j x[j] + A[i, j]`` over the valid x: kernel 1's (PLUS, MIN)."""
    return spmv(block, x, OP.PLUS_FLOAT, OP.MIN_FLOAT, float("inf"), x_valid=x_valid)


def dist_sssp(mesh: Mesh, At: ShardedCsr, source, axis="d", frontier_cap: int | None = None,
              with_stats: bool = False):
    """This rank's SSSP distances (min-plus relaxation; unreached +inf).  The
    feedback is exchanged each round by the capped-sparse (index, value)
    gather with the tier ladder, dense past the top tier (see ``dist_bfs``);
    ``with_stats`` also returns ``{"comm_bytes", "sparse_rounds", "rounds"}``."""
    block = _f32(At.local_block())
    v, stats = sssp_loop(mesh, At.mloc, int(source), normalize_caps(frontier_cap, At.mloc),
                         lambda v, changed, wait: min_plus(block, *wait()), 1, At.shape[0])
    return (v, stats) if with_stats else v
