"""Triangle counting on the benchmark's graphs, its work counters and its spans
(``algorithms.tc``, ``algorithms.STATS["tc_products"]`` and ``["tc_walked"]``,
``spla.tc`` / ``spla.tc.read``, ``kernels.mxmt.MxmtPlan.products``), and the
plain version of kernel 4's ordered walk with the check that lets ``tc`` take
it (``kernels.mxmt.ordered_walk``), on the CPU.

The graphs are the benchmark's own (``graphbench/core/graph.py`` with the
urand and kron generators, at scales 6-9), and the count is held to the
benchmark's plain reference, GAP's ordered count (``graphbench/reference/
tc.py``), which counts each triangle once where ``tc`` counts it six times.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from graphbench.core import graph as G  # noqa: E402
from graphbench.core.graph import Graph  # noqa: E402
from graphbench.core import port  # noqa: E402
from graphbench.core.spec import load_module  # noqa: E402
from spla_tpu_torch import algorithms as alg, formats as F  # noqa: E402
from spla_tpu_torch.kernels import mxmt as K45, probe as K8  # noqa: E402

REF = load_module("reference", "tc")
CONFIGS = {"urand": "gap-urand-s24-tc", "kron": "gap-kron-s25"}
CPU = torch.device("cpu")


def _graph(kind, scale, seed=11):
    config = json.loads((ROOT / "graphbench" / "configs" / f"{CONFIGS[kind]}.json").read_text())
    return G.build(config, seed, CPU, scale)


def _csr(graph, values=None):
    """The program's CSR of the benchmark's graph, as ``queries/tc.py`` makes
    it: int32 ones, or ``values``."""
    ones = torch.ones(graph.nnz, dtype=torch.int32)
    return port.csr(graph, ones if values is None else values, 0)


def _adjacency(graph):
    ptr = np.searchsorted(graph.rows.numpy(), np.arange(graph.n + 1))
    cols = graph.cols.numpy()
    return [list(cols[ptr[i]:ptr[i + 1]]) for i in range(graph.n)]


def _sum_deg_of_col(graph):
    """Σ over the stored entries of the degree of the entry's column."""
    deg = graph.degrees()
    return int(deg[graph.cols.long()].sum())


@pytest.mark.parametrize("scale", [6, 7, 8, 9])
@pytest.mark.parametrize("kind", ["urand", "kron"])
def test_tc_is_six_ordered_counts_and_the_naive_count(kind, scale):
    graph = _graph(kind, scale, seed=scale)
    got = alg.tc(_csr(graph))
    triangles = REF.ordered_count(graph)
    assert triangles > 0
    assert got == 6 * triangles == alg.tc_naive(_adjacency(graph))


@pytest.mark.parametrize("values", ["pattern", "weights"])
def test_tc_products_counts_the_rows_walked(values):
    """``STATS["tc_products"]`` gains Σ over the stored entries of deg(col)
    (Σ deg² on a symmetric graph) each call, whether the values are ones
    (the structural path) or the benchmark's weights (a weighted sum); so
    does ``STATS["tc_walked"]``, as CPU tensors take the full walk."""
    graph = _graph("urand", 8)
    A = _csr(graph, None if values == "pattern" else graph.weights.to(torch.int32))
    want = _sum_deg_of_col(graph)
    assert want == int((graph.degrees() ** 2).sum())
    alg.STATS["tc_products"] = alg.STATS["tc_walked"] = 0
    first = alg.tc(A)
    assert alg.STATS["tc_products"] == alg.STATS["tc_walked"] == want
    assert alg.tc(A) == first
    assert alg.STATS["tc_products"] == alg.STATS["tc_walked"] == 2 * want


@pytest.mark.parametrize("scale", [6, 7, 8, 9])
@pytest.mark.parametrize("kind", ["urand", "kron"])
def test_the_plain_ordered_walk_is_a_sixth_of_the_full_count(kind, scale):
    """Kernel 4's ordered walk (the entries (i, j) with j < i over the columns
    k < j of row j) in its plain version counts each triangle once: times 6
    it is the full structural count, ``tc`` and the naive count."""
    graph = _graph(kind, scale, seed=scale + 20)
    A = _csr(graph)
    ordered = int(K45.mxmt_reduce(A, A, A, None, struct_only=True, ordered=True))
    full = int(K45.mxmt_reduce(A, A, A, None, struct_only=True))
    assert ordered == REF.ordered_count(graph) > 0
    assert 6 * ordered == full == alg.tc(A) == alg.tc_naive(_adjacency(graph))


def _lower_walk(graph) -> int:
    """Σ over the stored (i, j) with j < i of row j's columns below j, by numpy."""
    rows, cols = graph.rows.numpy().astype(np.int64), graph.cols.numpy().astype(np.int64)
    below = np.bincount(rows[cols < rows], minlength=graph.n)
    return int(below[cols[cols < rows]].sum())


def _edited(graph, edit):
    """The graph with one fault: ``directed`` drops one stored direction of
    an edge, ``diagonal`` adds the entry (v, v), ``duplicate`` stores an edge
    twice each way (rows stay sorted)."""
    rows, cols = graph.rows.numpy().astype(np.int64), graph.cols.numpy().astype(np.int64)
    e = int(np.flatnonzero(cols < rows)[len(rows) // 4])
    if edit == "directed":
        rows, cols = np.delete(rows, e), np.delete(cols, e)
    else:
        v = int(rows[e])
        extra = [(v, v)] if edit == "diagonal" else [(v, int(cols[e])), (int(cols[e]), v)]
        rows = np.concatenate([rows, [r for r, _ in extra]])
        cols = np.concatenate([cols, [c for _, c in extra]])
        order = np.lexsort((cols, rows))
        rows, cols = rows[order], cols[order]
    return Graph(n=graph.n, rows=torch.from_numpy(rows.astype(np.int32)),
                 cols=torch.from_numpy(cols.astype(np.int32)),
                 weights=torch.ones(len(rows), dtype=torch.float32), checksum=0)


def _tc_walk(A):
    """What the walk ``tc`` takes on CUDA tensors reads: ``ordered_walk(A)``
    where A is a verified 0/1 pattern, else None (the full walk)."""
    return K45.ordered_walk(A) if alg._is_pattern(A) else None


VERDICT_CASES = [*(f"{kind}{scale}" for kind in ("urand", "kron") for scale in (6, 7, 8, 9)),
                 "directed", "diagonal", "duplicate", "weighted"]


@pytest.mark.parametrize("case", VERDICT_CASES)
def test_tc_takes_the_ordered_walk_only_on_a_symmetric_pattern(case):
    """``tc``'s check (a 0/1 pattern, square, symmetric, no diagonal entry,
    strictly increasing rows) holds on the benchmark's graphs, where it gives
    what the ordered walk reads, and fails on a directed graph, one diagonal
    entry, one duplicate column and the weighted graph."""
    if case[-1].isdigit():
        graph = _graph(case[:-1], int(case[-1]), seed=3)
        A = _csr(graph)
        assert _tc_walk(A) == K45.ordered_walk(A) == _lower_walk(graph) > 0
        assert _lower_walk(graph) == int(K45._entry_degrees(A, A, ordered=True).sum())
        return
    graph = _graph("urand", 8, seed=3)
    if case == "weighted":
        A = _csr(graph, graph.weights.to(torch.int32))
        assert K45.ordered_walk(A) is not None  # the structure holds; the values do not
    else:
        A = _csr(_edited(graph, case))
        assert K45.ordered_walk(A) is None
    assert _tc_walk(A) is None


def test_the_plain_ordered_gather_reads_the_rows_below_the_diagonal():
    """The floor of the ordered walk (``mxmt_gather`` with ``ordered``): at
    each entry (i, j) with j < i the XOR of row j's columns below j, else 0."""
    graph = _graph("kron", 8)
    A = _csr(graph)
    got = K8.mxmt_gather(A, A, values=False, ordered=True).numpy()
    rows, cols = graph.rows.numpy(), graph.cols.numpy()
    ptr = np.searchsorted(rows, np.arange(graph.n + 1))
    want = np.zeros(len(rows), np.int32)
    for e in np.flatnonzero(cols < rows):
        j = cols[e]
        row = cols[ptr[j]:ptr[j + 1]]
        want[e] = np.bitwise_xor.reduce(row[row < j], initial=0)
    assert np.array_equal(got, want) and want.any()


def _spans(prof):
    """``(name, start, end, args)`` of the trace's ``spla.*`` ranges, by start."""
    out = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.kwinputs().get("args"))
           for ev in prof.profiler.kineto_results.events() if ev.name().startswith("spla.")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def test_each_tc_call_is_one_numbered_span_with_its_read_inside():
    A = _csr(_graph("urand", 7))
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        alg.tc(A)
        alg.tc(A)
    spans = _spans(prof)
    tops = [s for s in spans if s[0] == "spla.tc"]
    reads = [s for s in spans if s[0] == "spla.tc.read"]
    assert len(tops) == len(reads) == 2 and len(spans) == 4
    assert all(isinstance(t[3], int) for t in tops) and tops[1][3] == tops[0][3] + 1
    for t, r in zip(tops, reads):
        assert t[1] <= r[1] and r[2] <= t[2] and r[3] is None


def _rectangular(seed=4):
    """A 300 x 500 mask against a 500 x 700 B whose rows 7 and 410 hold 600
    and 2,500 entries (hub chunks), each row's columns sorted."""
    rng = np.random.default_rng(seed)

    def csr(m, n, per_row, hubs=()):
        rows = np.concatenate([rng.integers(0, m, per_row * m), *[np.full(k, r) for r, k in hubs]])
        cols = rng.integers(0, n, rows.size)
        a = sp.csr_matrix((np.ones(rows.size, np.int32), (rows, cols)), shape=(m, n))
        a.sum_duplicates()
        a.data[:] = 1
        return F.csr_from_scipy(a, device="cpu")

    return csr(300, 500, 6), csr(500, 700, 5, hubs=((7, 600), (410, 2500)))


@pytest.mark.parametrize("graph", ["urand", "kron", "rectangular"])
def test_plan_products_equal_the_plain_count(graph):
    """``MxmtPlan.products``, read with the plan's other counts, equals the
    plain path's product slots (``mxmt_products`` on CPU tensors), with and
    without hub chunks."""
    if graph == "rectangular":
        mask, B = _rectangular()
    else:
        mask = B = _csr(_graph(graph, 9))
    plan = K45.mxmt_plan(mask, B)
    deg_b = (B.indptr[1:] - B.indptr[:-1]).long()
    want = int(deg_b[mask.cols[:int(mask.nnz)].long()].sum())
    assert plan.products == K45.mxmt_products(mask, B) == want
    if graph != "urand":
        assert plan.nhub > 0
