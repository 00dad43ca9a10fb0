"""BFS, SSSP, PageRank and triangle counting over the port's kernels
(counterpart of ``spla_tpu/algorithms.py``), with the naive sequential
oracles.

BFS and SSSP take one of two routes, as the JAX package does
(``spla_tpu/algorithms.py:237-241,457-461``):

* the resident route: kernel 6 runs the whole traversal in one
  cooperative launch.  It is taken when Aᵀ is square and not skewed
  (``formats.is_skewed``), SSSP's weights are finite f32, and CSR(A) plus
  the traversal state fit ``RESIDENT_BYTES``.  It ignores the Descriptor's
  push/pull modes, as the JAX resident route does;
* otherwise the level loop: a push level is kernel 2's fused push level
  over CSR(A) (BFS: one launch; SSSP: two, the second kernel 3's update of
  the vertices the push touched), whose work follows the frontier's edges;
  a pull level is kernel 1 (pull over ``At``, the unvisited mask fused)
  then kernel 3's stream update.  Both write the next frontier list with
  its degree offsets.  A level pushes when its frontier holds at most
  ``front_factor * n`` vertices (``Descriptor.push_only``: always;
  ``pull_only``: never); every mode gives identical depths and distances.
  The run's state (``kernels.frontier.LevelState``) is allocated once: a
  level allocates nothing and copies nothing to the device.

Host sync: the level loop reads the frontier count (PageRank: the error) on
the host once per level, as the C++ reference does
(``src/algorithm.cpp:112``); the resident route reads its round count once
per run.  From the counts it reads, the loop counts each level's work in
``STATS`` (``push_edges``, ``pull_entries``) with no read of its own, and
it names its phases in a ``torch.profiler`` trace
(``profiling.span``: ``spla.bfs`` / ``sssp`` / ``pr``, ``spla.level.push`` /
``pull`` / ``read``).  The JAX version has no such sync: each loop is one
``lax.while_loop`` whose convergence scalar stays on the device
(``spla_tpu/algorithms.py:8-12``).  ``tc`` reads its one result (its spans
``spla.tc`` and ``spla.tc.read``) and counts its work in
``STATS["tc_products"]`` and ``STATS["tc_walked"]`` from kernel 4's plan
and check (facts of ``formats.derived``), with no read of its own.
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import replace

import numpy as np
import torch

from . import op as OP
from .containers import CsrMatrix, DenseVec
from .descriptor import Descriptor
from .formats import csr_transpose_host, derived, is_skewed, stored_finite as _finite, transpose_of
from .kernels.frontier import LevelState, bfs_state, read_count, sssp_state
from .kernels.level_update import bfs_pull_update, sssp_pull_update
from .kernels.mxmt import mxmt_products, mxmt_reduce, ordered_walk
from .kernels.resident import bfs_resident, sssp_resident
from .kernels.spmv import spmv_pull, spmv_pull_structural
from .kernels.traversal import bfs_push_level, sssp_push_level
from .ops.matrix import m_reduce
from .ops.spgemm import mxmT_masked, mxmT_masked_reduce
from .profiling import span
from .types import type_from_dtype
from .utils.bits import bits

__all__ = ["STATS", "RESIDENT_BYTES", "resident_bytes", "bfs", "sssp", "pr", "tc", "bfs_naive",
           "sssp_naive", "pr_naive", "tc_naive"]

# Of the runs since the last reset: levels (PageRank: iterations; the
# resident route: its rounds), push and pull levels, host syncs, BFS/SSSP
# runs on each route, resident runs stopped by the n + 2 round cap, and the
# resident rounds that ran on kernel 6's whole grid.  The loops read
# nothing else on the host.  The level loop's work: ``push_edges``, the
# stored entries of the lists its push levels walked (kernel 2), and
# ``pull_entries``, those of the rows its pulls selected (kernel 1; a
# PageRank iteration selects every row), as ``_run_levels`` counts them.
# ``tc_products``: the size of ``tc``'s problems, the sum of A's row length
# over A's stored entries (Σ deg² for A = Aᵀ), whichever walk ran;
# ``tc_walked``: the elements of A's rows that the walk ``tc`` chose reads
# (the full walk: ``tc_products``; the ordered walk: ``ordered_walk(A)``).
STATS = {"levels": 0, "push": 0, "pull": 0, "host_syncs": 0, "resident": 0, "level_loop": 0,
         "capped": 0, "wide_rounds": 0, "push_edges": 0, "pull_entries": 0, "tc_products": 0,
         "tc_walked": 0}

# What the resident route may hold: the H100's 50 MB L2, the counterpart of
# RESIDENT_VMEM (spla_tpu/pallas/spmv.py:2456) on the TPU.
RESIDENT_BYTES = 50 * 1024 * 1024

_QUERIES = itertools.count(1)  # the query number a public call's span carries
_LEVEL_SPANS = ("spla.level.pull", "spla.level.push")  # by push


def _default_At(A: CsrMatrix) -> CsrMatrix:
    """Aᵀ for the pull kernel when the caller gave none.

    The reference traverses by push over A's rows (``r[j] = or/min_i f[i]
    (x) A[i,j]``, ``src/algorithm.cpp:97``); pull computes ``mxv(At, f)``,
    which matches only when ``At = Aᵀ``.  A directed graph therefore needs
    the transpose; ``At = A`` would walk reversed edges.  A symmetric A is
    returned itself.  A fact of the tensors and the shape that the
    transposes read (the store holds None for a symmetric A)."""
    T = derived(_default_At, (A.row_ids, A.cols, A.values, A.nnz, A.fill), lambda: _asymmetric_At(A),
                A.shape)
    return A if T is None else T


def _asymmetric_At(A: CsrMatrix) -> CsrMatrix | None:
    """Aᵀ, or None when it equals A."""
    T = csr_transpose_host(A)
    # T is the canonical Aᵀ and its transpose the canonical A, so the
    # comparison holds however A's columns are ordered
    T2 = csr_transpose_host(T)
    if all(torch.equal(getattr(T2, f), getattr(T, f)) for f in ("indptr", "cols", "values")):
        return None
    return T


def _operands(A: CsrMatrix, At: CsrMatrix | None) -> tuple:
    """``(At, Apush)``: the matrix pull walks (``_default_At(A)`` if none is
    given) and CSR(A) for the push kernel, the transpose of ``At``: A itself
    when At is A or was not given, else ``transpose_of(At)``."""
    if At is None:
        return _default_At(A), A
    return At, (A if At is A else transpose_of(At))


def _front_factor_of(descriptor) -> float:
    """Push = always push, Pull = never, otherwise the density threshold."""
    if descriptor is None:
        return Descriptor().front_factor
    if descriptor.push_only:
        return 1.0
    if descriptor.pull_only:
        return 0.0
    return descriptor.front_factor


def _stored(M: CsrMatrix) -> int:
    """M's stored entries (one host read, a fact of ``nnz``)."""
    return derived(_stored, (M.nnz,), lambda: int(M.nnz))


def _host_count(S: LevelState) -> int:
    STATS["host_syncs"] += 1
    return read_count(S)


def _pushes(count: int, n: int, front_factor: float) -> bool:
    push = count <= front_factor * n
    STATS["push" if push else "pull"] += 1
    STATS["levels"] += 1
    return push


def resident_bytes(n: int, capacity: int, sssp: bool) -> int:
    """Bytes kernel 6 works on for n vertices and ``capacity`` stored
    entries: indptr, cols, the result and the two queues; SSSP adds the
    values and the per-vertex round stamps."""
    words = (n + 1) + capacity + n + 2 * n
    if sssp:
        words += capacity + n
    return 4 * words


def _takes_resident(At: CsrMatrix, Apush: CsrMatrix, sssp: bool) -> bool:
    """The JAX package's resident gate (``spla_tpu/algorithms.py:341-351,
    534-544``, ``spla_tpu/pallas/spmv.py:2660-2669``) with the L2 budget.
    Non-finite SSSP weights keep the level loop: a NaN, or -inf meeting
    +inf, makes a NaN distance whose value would depend on the order of
    the kernel's relaxations.  The checks that read nothing on the host
    come first."""
    n, m = At.shape
    if n != m or (sssp and At.values.dtype != torch.float32):
        return False
    if resident_bytes(n, Apush.capacity, sssp) > RESIDENT_BYTES:
        return False
    return not is_skewed(At) and not (sssp and not _finite(Apush))


def _read_resident(stats) -> None:
    rounds, capped, wide = stats.tolist()  # the run's one host read
    STATS["host_syncs"] += 1
    STATS["levels"] += rounds
    STATS["capped"] += capped
    STATS["wide_rounds"] += wide
    STATS["resident"] += 1


def _run_levels(S: LevelState, At: CsrMatrix, descriptor, level, unvisited_rows: bool) -> None:
    """The level loop: ``level(S, At, push)`` until a level writes an empty
    list, one host read a level.  From each read it counts the level's
    work in ``STATS``: a push level walks its list's edges
    (``push_edges``, the source's degree among them); a pull level walks
    the stored entries of the rows that kernel 1 selects
    (``pull_entries``).  BFS (``unvisited_rows``) selects the unvisited
    rows: every visited vertex went through exactly one list, so with
    ``At`` the push matrix they hold At's entries less the edges of every
    list so far; with another ``At`` (a directed graph) all of At's are
    counted, an upper bound.  SSSP's pulls select every row."""
    ff = _front_factor_of(descriptor)
    n = At.shape[0]
    stored = _stored(At)
    rows_left = unvisited_rows and At is S.A
    walked, count = 0, 1
    while count > 0:
        push = _pushes(count, n, ff)
        with span(_LEVEL_SPANS[push]):
            level(S, At, push)
        with span("spla.level.read"):
            count = _host_count(S)
        walked += S.walked
        if push:
            STATS["push_edges"] += S.walked
        else:
            STATS["pull_entries"] += stored - walked if rows_left else stored


def bfs_level(S: LevelState, At: CsrMatrix, push: bool) -> None:
    """One BFS level: kernel 2's push level, or kernel 1's pull over ``At``
    (the unvisited rows only) and kernel 3's update."""
    if push:
        bfs_push_level(S)
    else:
        row_sel = torch.eq(S.v, 0, out=S.row_sel)
        bfs_pull_update(S, spmv_pull_structural(At, S.mask, row_sel=row_sel, out=S.pull_out))


def sssp_level(S: LevelState, At: CsrMatrix, push: bool) -> None:
    """One SSSP level: kernel 2's push level, or kernel 1's (PLUS, MIN)
    pull of the changed distances and kernel 3's update.  The reference's
    feedback vector, changed ? v : +inf, is carried as (v, changed)."""
    if push:
        sssp_push_level(S)
    else:
        hits, _ = spmv_pull(At, S.v, OP.PLUS_FLOAT, OP.MIN_FLOAT, float("inf"), x_valid=S.mask,
                            out=S.pull_out)
        sssp_pull_update(S, hits)


def bfs(A: CsrMatrix, source: int, descriptor: Descriptor | None = None,
        At: CsrMatrix | None = None) -> DenseVec:
    """Depth of every vertex from ``source`` (1-based; 0 = unreachable).

    Structure-only traversal: values are ignored.  ``At`` is the CSR of
    Aᵀ, which pull walks; it defaults to a cached transpose of A (A itself
    when A is symmetric).  ``At=A`` declares A symmetric and skips that
    check: push, and the resident route, then walk A's rows."""
    with span("spla.bfs", next(_QUERIES)):
        At, Apush = _operands(A, At)
        if _takes_resident(At, Apush, sssp=False):
            v, stats = bfs_resident(Apush, int(source))
            with span("spla.level.read"):
                _read_resident(stats)
            return DenseVec(v, torch.zeros((), dtype=torch.int32, device=v.device))
        STATS["level_loop"] += 1
        S = bfs_state(Apush, int(source))
        _run_levels(S, At, descriptor, bfs_level, unvisited_rows=True)
        return DenseVec(S.v, torch.zeros((), dtype=torch.int32, device=S.v.device))


def sssp(A: CsrMatrix, source: int, descriptor: Descriptor | None = None,
         At: CsrMatrix | None = None) -> DenseVec:
    """Single-source shortest paths by Bellman-Ford with the reference's
    feedback semantics (only entries that changed relax again); unreachable
    = +inf.  ``At`` as in :func:`bfs`.  The resident route stops after
    n + 2 rounds (``STATS["capped"]`` counts such runs), which ends a
    negative cycle; the level loop has no cap."""
    with span("spla.sssp", next(_QUERIES)):
        At, Apush = _operands(A, At)
        if _takes_resident(At, Apush, sssp=True):
            d, stats = sssp_resident(Apush, int(source))
            with span("spla.level.read"):
                _read_resident(stats)
            return DenseVec(d, torch.tensor(float("inf"), dtype=torch.float32, device=d.device))
        STATS["level_loop"] += 1
        if At.values.dtype != torch.float32:
            At = replace(At, values=At.values.float(), fill=At.fill.float())
            Apush = replace(Apush, values=Apush.values.float(), fill=Apush.fill.float())
        S = sssp_state(Apush, int(source))
        _run_levels(S, At, descriptor, sssp_level, unvisited_rows=False)
        return DenseVec(S.v, torch.tensor(float("inf"), dtype=torch.float32, device=S.v.device))


def pr(A: CsrMatrix, alpha: float = 0.85, eps: float = 1e-6,
       descriptor: Descriptor | None = None) -> DenseVec:
    """PageRank ``p = A p_prev + (1 - alpha) / n`` until ``||p - p_prev||_2 <=
    eps`` (at most 10 000 iterations).  A comes pre-scaled by the caller."""
    with span("spla.pr", next(_QUERIES)):
        n = A.shape[0]
        device = A.values.device
        addition = (1.0 - alpha) / n
        stored = _stored(A)
        p = torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
        err, it = eps + 0.1, 0
        while err > eps and it < 10_000:
            with span("spla.level.pull"):
                ap, _ = spmv_pull(A, p, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0)
                p_new = ap + addition
                STATS["levels"] += 1
                STATS["pull_entries"] += stored
            with span("spla.level.read"):
                STATS["host_syncs"] += 1
                err = float(torch.sqrt(torch.sum((p_new - p) ** 2)))
            p, it = p_new, it + 1
        return DenseVec(p, torch.zeros((), dtype=torch.float32, device=device))


def _is_pattern(A: CsrMatrix) -> bool:
    """Every stored value is 1 (one host read, a fact of ``values`` and ``nnz``)."""
    return derived(_is_pattern, (A.values, A.nnz),
                   lambda: bool(torch.all(~A.valid_mask() | (bits(A.values) == 1))))


def tc(A: CsrMatrix, products_cap: int | None = None) -> int:
    """Triangle count: the sum of ``(A x Aᵀ) masked by A`` under (MULT,
    PLUS) with the GTZERO select (reference ``src/algorithm.cpp:380-414``).
    For a symmetric adjacency each triangle counts 6 times, as in the
    reference.  A verified 0/1 pattern runs structurally (values read as 1,
    the select skipped).

    On CUDA tensors the products are summed by kernel 4 in one pass, in
    int64 (float64 for float values; rounded to the nearest int); on CPU
    tensors through ``mxmT_masked`` and ``m_reduce(PLUS_INT)``, which sums in
    the value dtype: for int32 it wraps past 2^31 where kernel 4 does not.
    Reads one scalar on the host.  The ops are those of A's value type
    (MULT, PLUS and GTZERO of INT, UINT or FLOAT), so a UINT graph compares
    and multiplies as unsigned, and launches kernel 4's u32 instance.

    On CUDA tensors a 0/1 pattern that ``kernels.mxmt.ordered_walk`` finds
    square, symmetric, with no diagonal entry and strictly increasing rows
    takes kernel 4's ordered walk (GAP's ordered count): the entries (i, j)
    with j < i over the columns k < j, each triangle once, times 6, the same
    integer.  Every other input takes the full walk.

    The call is one ``spla.tc`` span, the read one ``spla.tc.read`` in it;
    ``STATS["tc_products"]`` gains the elements of A's rows the full walk
    reads over every stored entry (``kernels.mxmt.mxmt_products``), and
    ``STATS["tc_walked"]`` those the chosen walk reads: from kernel 4's
    plan and check on CUDA (facts of ``formats.derived``), so no host read
    of their own."""
    with span("spla.tc", next(_QUERIES)):
        is_pattern = _is_pattern(A)
        T = type_from_dtype(A.values.dtype)
        products = mxmt_products(A, A)
        cuda = A.values.device.type == "cuda"
        walked = ordered_walk(A) if cuda and is_pattern else None
        STATS["tc_products"] += products
        STATS["tc_walked"] += products if walked is None else walked
        if walked is not None:
            total = mxmt_reduce(A, A, A, None, struct_only=True, ordered=True)
            with span("spla.tc.read"):
                return 6 * int(total)
        if cuda:
            total = mxmT_masked_reduce(A, A, A, T.MULT, T.GTZERO, struct_only=is_pattern)
            with span("spla.tc.read"):
                return int(round(float(total))) if total.is_floating_point() else int(total)
        B = mxmT_masked(A, A, A, T.MULT, T.PLUS, T.GTZERO, 0, products_cap=products_cap,
                        struct_only=is_pattern)
        total = m_reduce(0, B, T.PLUS).value
        with span("spla.tc.read"):
            return int(total)


def bfs_naive(adj: list, source: int) -> np.ndarray:
    """Sequential queue BFS oracle (reference ``src/algorithm.cpp:122-152``)."""
    n = len(adj)
    v = np.zeros(n, np.int32)
    visited = np.zeros(n, bool)
    q = deque([source])
    visited[source] = True
    v[source] = 1
    while q:
        i = q.popleft()
        for j in adj[i]:
            if not visited[j]:
                visited[j] = True
                v[j] = v[i] + 1
                q.append(j)
    return v


def sssp_naive(adj: list, w: list, source: int) -> np.ndarray:
    """SPFA / Bellman-Ford queue oracle (reference ``src/algorithm.cpp:231-272``)."""
    n = len(adj)
    dist = np.full(n, np.inf, np.float32)
    dist[source] = 0.0
    inq = np.zeros(n, bool)
    q = deque([source])
    inq[source] = True
    while q:
        i = q.popleft()
        inq[i] = False
        for j, wx in zip(adj[i], w[i]):
            nd = np.float32(dist[i] + wx)
            if nd < dist[j]:
                dist[j] = nd
                if not inq[j]:
                    q.append(j)
                    inq[j] = True
    return dist


def pr_naive(adj_in: list, w_in: list, alpha: float, eps: float) -> np.ndarray:
    """Dense-loop oracle (reference ``src/algorithm.cpp:337-374``):
    ``adj_in[i]`` lists the in-neighbours k of i, with weights ``w_in[i]``."""
    n = len(adj_in)
    p_prev = np.full(n, 1.0 / n, np.float32)
    p = np.zeros(n, np.float32)
    err = eps + 0.1
    while err > eps:
        for i in range(n):
            p[i] = sum(wx * p_prev[k] for k, wx in zip(adj_in[i], w_in[i])) + (1.0 - alpha) / n
        err = float(np.sqrt(((p - p_prev) ** 2).sum()))
        p, p_prev = p_prev, p
    return p_prev


def tc_naive(adj: list) -> int:
    """Sorted-intersection oracle (reference ``src/algorithm.cpp:416-448``)."""
    count = 0
    for row in adj:
        for nb in row:
            a, b = row, adj[nb]
            i = j = 0
            while i < len(a) and j < len(b):
                if a[i] == b[j]:
                    count += 1
                    i += 1
                    j += 1
                elif a[i] < b[j]:
                    i += 1
                else:
                    j += 1
    return count
