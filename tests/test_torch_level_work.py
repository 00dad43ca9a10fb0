"""The level loop's work counters and spans (``algorithms.STATS``
``push_edges`` / ``pull_entries``, ``profiling.span``), on the CPU.

The counters are held to a count made from the plain BFS / SSSP references'
own levels: the vertices each level walks, the direction the loop's rule
gives it, and the stored entries of the rows a pull selects.  The spans are
read from a ``torch.profiler`` trace, as the benchmark reads them.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

from spla_tpu_torch import Descriptor, algorithms as alg, formats as F, kernels, profiling
from spla_tpu_torch.profiling import span

N, HUB, LEAF = 400, 7, 399
MODES = {"auto": None, "push": Descriptor(push_only=True), "pull": Descriptor(pull_only=True)}
QUERY_SPANS = ("spla.bfs", "spla.sssp", "spla.pr")
LEVEL_SPANS = ("spla.level.push", "spla.level.pull", "spla.level.read")


def _graph(weights=True):
    """Symmetric, no self-loops: random edges, a hub (vertex HUB, ~100
    neighbours) and a leaf (vertex LEAF, one edge, to vertex 0); weights
    whole numbers 1-9, the same both ways."""
    rng = np.random.default_rng(5)
    r = np.concatenate([rng.integers(0, N - 1, 2 * N), np.full(100, HUB), [LEAF]])
    c = np.concatenate([rng.integers(0, N - 1, 2 * N), rng.integers(0, N - 1, 100), [0]])
    keep = r != c
    r, c = r[keep], c[keep]
    w = rng.integers(1, 10, r.size).astype(np.float32) if weights else np.ones(r.size, np.float32)
    a = sp.coo_matrix((np.concatenate([w, w]), (np.concatenate([r, c]), np.concatenate([c, r]))), shape=(N, N))
    a = a.tocsr()
    a.sum_duplicates()
    a.data = np.minimum(a.data, 9).astype(np.float32)  # a duplicate pair sums; keep whole numbers
    return a


def _reset():
    for k in alg.STATS:
        alg.STATS[k] = 0


def _expected(a, lists, ff, unvisited):
    """``(push_edges, pull_entries)`` over the levels that walk ``lists``
    (one vertex array a level), each pushing when its list holds at most
    ``ff * n`` vertices; a pull selects the rows ``unvisited(L)`` (a bool
    mask) after level L's list, or every row where it is None."""
    deg = np.diff(a.indptr)
    push = pull = 0
    for L, lst in enumerate(lists):
        if len(lst) <= ff * a.shape[0]:
            push += int(deg[lst].sum())
        else:
            pull += int(deg[unvisited(L)].sum()) if unvisited else int(a.nnz)
    return push, pull


def _bfs_lists(a, source):
    depth = alg.bfs_naive([a.indices[a.indptr[i]:a.indptr[i + 1]] for i in range(a.shape[0])], source)
    return depth, [np.nonzero(depth == d)[0] for d in range(1, int(depth.max()) + 1)]


def _sssp_lists(a, source):
    """The plain reference's Bellman-Ford by levels, with the loop's feedback
    (a level relaxes the edges of the vertices whose distance the level
    before lowered): the distances and each level's list."""
    dist = np.full(a.shape[0], np.inf, np.float32)
    dist[source] = 0
    changed, lists = np.array([source]), []
    while changed.size:
        lists.append(changed)
        hits = np.full_like(dist, np.inf)
        for u in changed:
            cols, w = a.indices[a.indptr[u]:a.indptr[u + 1]], a.data[a.indptr[u]:a.indptr[u + 1]]
            np.minimum.at(hits, cols, dist[u] + w)
        changed = np.nonzero(hits < dist)[0]
        dist = np.minimum(dist, hits)
    return dist, lists


@pytest.mark.parametrize("source", [HUB, LEAF], ids=["hub", "leaf"])
@pytest.mark.parametrize("mode", list(MODES))
def test_bfs_work_counts_match_the_plain_reference(mode, source, monkeypatch):
    monkeypatch.setattr(alg, "RESIDENT_BYTES", 0)
    a = _graph(weights=False)
    A = F.csr_from_scipy(a, device="cpu")
    depth, lists = _bfs_lists(a, source)
    ff = alg._front_factor_of(MODES[mode])
    want = _expected(a, lists, ff, lambda L: (depth == 0) | (depth > L + 1))
    _reset()
    before = dict(kernels.LAUNCHES)
    got = alg.bfs(A, source, MODES[mode], At=A).values
    np.testing.assert_array_equal(got.numpy(), depth)
    assert (alg.STATS["push_edges"], alg.STATS["pull_entries"]) == want
    assert alg.STATS["levels"] == alg.STATS["host_syncs"] == len(lists)
    assert kernels.LAUNCHES == before  # the CPU's plain versions launch nothing
    if mode == "push":  # every list walked by a push: each reached vertex's edges once
        assert want[0] == int(np.diff(a.indptr)[depth > 0].sum())
        assert want[0] > (100 if source == HUB else 0)  # the source's own list counts


@pytest.mark.parametrize("source", [HUB, LEAF], ids=["hub", "leaf"])
@pytest.mark.parametrize("mode", list(MODES))
def test_sssp_work_counts_match_the_plain_reference(mode, source, monkeypatch):
    monkeypatch.setattr(alg, "RESIDENT_BYTES", 0)
    a = _graph()
    A = F.csr_from_scipy(a, fill=np.float32(np.inf), device="cpu")
    dist, lists = _sssp_lists(a, source)
    ff = alg._front_factor_of(MODES[mode])
    want = _expected(a, lists, ff, None)
    _reset()
    before = dict(kernels.LAUNCHES)
    got = alg.sssp(A, source, MODES[mode], At=A).values
    np.testing.assert_array_equal(got.numpy(), dist)
    assert (alg.STATS["push_edges"], alg.STATS["pull_entries"]) == want
    assert alg.STATS["levels"] == alg.STATS["host_syncs"] == len(lists)
    assert kernels.LAUNCHES == before


def test_bfs_pulls_over_another_At_count_every_entry(monkeypatch):
    """A directed graph pulls over its transpose: the count is then all of
    At's entries a pull, the upper bound the docstring states."""
    monkeypatch.setattr(alg, "RESIDENT_BYTES", 0)
    a = sp.triu(_graph(weights=False), format="csr")
    A = F.csr_from_scipy(a, device="cpu")
    _reset()
    alg.bfs(A, 0, MODES["pull"])
    assert alg.STATS["pull_entries"] == alg.STATS["pull"] * a.nnz > 0


@pytest.mark.parametrize("eps", [1e-3, 1e-6])
def test_pr_counts_every_entry_an_iteration(eps):
    a = _graph(weights=False)
    deg = np.diff(a.indptr).astype(np.float32)
    a = sp.csr_matrix(a.multiply(0.85 / np.maximum(deg, 1)[None, :]), dtype=np.float32)
    A = F.csr_from_scipy(a, device="cpu")
    _reset()
    alg.pr(A, 0.85, eps)
    assert alg.STATS["levels"] == alg.STATS["host_syncs"] > 1
    assert alg.STATS["pull_entries"] == alg.STATS["levels"] * a.nnz
    assert alg.STATS["push_edges"] == 0


def test_the_resident_route_counts_no_level_work():
    a = _graph(weights=False)
    A = F.csr_from_scipy(a, device="cpu")
    _reset()
    alg.bfs(A, HUB, At=A)
    assert alg.STATS["resident"] == alg.STATS["host_syncs"] == 1
    assert alg.STATS["push_edges"] == alg.STATS["pull_entries"] == 0


# ------------------------------------------------------------------- spans


def _spans(prof):
    """``(name, start, end, args)`` of the trace's ``spla.*`` ranges, by start."""
    out = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.kwinputs().get("args"))
           for ev in prof.profiler.kineto_results.events() if ev.name().startswith("spla.")]
    return sorted(out, key=lambda s: (s[1], -s[2]))


class _CountingRange:
    """The profiler range that ``span`` opens, keeping each one's name and args."""

    calls = []

    def __init__(self, name, inputs=(), keywords=None):
        self.calls.append((name, (keywords or {}).get("args")))
        self._range = _REAL_RANGE(name, inputs, keywords or {})

    def __enter__(self):
        return self._range.__enter__()

    def __exit__(self, *exc):
        return self._range.__exit__(*exc)


_REAL_RANGE = profiling._range


def _queries(monkeypatch):
    """A BFS (both kinds of level), an SSSP and a PageRank query on the level loop."""
    monkeypatch.setattr(alg, "RESIDENT_BYTES", 0)
    a = _graph()
    A = F.csr_from_scipy(a, device="cpu")
    W = F.csr_from_scipy(a, fill=np.float32(np.inf), device="cpu")
    deg = np.diff(a.indptr).astype(np.float32)
    P = F.csr_from_scipy(sp.csr_matrix(a.multiply(0.85 / np.maximum(deg, 1)[None, :]), dtype=np.float32),
                         device="cpu")
    return [lambda: alg.bfs(A, HUB, At=A), lambda: alg.sssp(W, LEAF, MODES["push"], At=W),
            lambda: alg.pr(P, 0.85, 1e-4)]


@pytest.mark.parametrize("query", [0, 1, 2], ids=["bfs", "sssp", "pr"])
def test_spans_nest_in_their_query_with_its_number(query, monkeypatch):
    """Under torch.profiler each public call is one ``spla.<kind>`` span
    whose args (kept where the profiler records inputs) are a new query
    number, and every level and read span of the call nests in it, one
    level span and one read span a level."""
    call = _queries(monkeypatch)[query]
    monkeypatch.setattr(profiling, "_range", _CountingRange)
    _CountingRange.calls = []
    _reset()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        call()
        call()
    spans = _spans(prof)
    name = QUERY_SPANS[query]
    tops = [s for s in spans if s[0] in QUERY_SPANS]
    assert [s[0] for s in tops] == [name, name]
    inner = [s for s in spans if s[0] in LEVEL_SPANS]
    assert len(inner) == len(spans) - 2
    assert all(sum(t[1] <= s[1] and s[2] <= t[2] for t in tops) == 1 for s in inner)
    levels = alg.STATS["levels"]
    assert sum(s[0] == "spla.level.read" for s in inner) == levels
    assert sum(s[0] in ("spla.level.push", "spla.level.pull") for s in inner) == levels
    if query == 0:
        assert {s[0] for s in inner} == set(LEVEL_SPANS)  # the hub's BFS pushes, then pulls
    numbers = [s[3] for s in tops]
    assert numbers == [args for n, args in _CountingRange.calls if n == name]
    assert numbers[1] == numbers[0] + 1
    assert all(s[3] is None for s in inner)


def test_all_six_span_names_appear_in_one_trace(monkeypatch):
    calls = _queries(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for call in calls:
            call()
    assert {s[0] for s in _spans(prof)} == set(QUERY_SPANS + LEVEL_SPANS)


@pytest.mark.parametrize("query", [0, 1, 2], ids=["bfs", "sssp", "pr"])
def test_without_the_profiler_no_span_opens_a_range(query, monkeypatch):
    """No profiler recording: no profiler range is made, and the counters
    and the host reads are those of a traced run."""
    call = _queries(monkeypatch)[query]
    monkeypatch.setattr(profiling, "_range", _CountingRange)
    _CountingRange.calls = []
    _reset()
    call()
    off = dict(alg.STATS)
    assert _CountingRange.calls == []
    _reset()
    with profile(activities=[ProfilerActivity.CPU]):
        call()
    assert _CountingRange.calls and dict(alg.STATS) == off
    assert off["host_syncs"] == off["levels"]


def test_span_off_is_one_shared_context():
    assert not torch._C._autograd._profiler_enabled()
    assert span("spla.bfs", 3) is span("spla.level.read")
    with span("spla.bfs", 3):
        pass


def test_time_profiler_scopes_open_through_span(monkeypatch):
    """The time profiler's scopes open their profiler range through
    ``span``: only while torch's profiler records, and then under the
    scope's name."""
    monkeypatch.setattr(profiling, "_range", _CountingRange)
    _CountingRange.calls = []
    prof = profiling.TimeProfiler()
    prof.enabled = True
    with prof.scope("outer"):
        pass
    assert _CountingRange.calls == [] and prof.stats()["outer"]["count"] == 1
    with profile(activities=[ProfilerActivity.CPU]) as trace:
        with prof.scope("outer"):
            with prof.scope("inner"):
                pass
    assert _CountingRange.calls == [("outer", None), ("inner", None)]
    names = {ev.name() for ev in trace.profiler.kineto_results.events()}
    assert {"outer", "inner"} <= names
    assert prof.stats()["inner"]["parent"] == "outer"
