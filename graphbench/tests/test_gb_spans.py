"""The program's spans and work counters as the harness reads them
(``core/spans.py`` and the readers built on it), against hand-made values,
and through ``torch.profiler`` with the program itself."""

import pytest
import torch

from graphbench.core import graph as G
from graphbench.core import spans as S
from graphbench.core import trace
from graphbench.core.spec import find_cell, load_module
from graphbench.tests.test_gb_arithmetic import Ev, Run, _reader

NEW_READERS = ("query_idle_us_per_level", "read_idle_us_per_level", "launch_idle_us_per_level",
               "pull_entries_per_query", "pull_ps_per_entry", "push_edges_per_query", "push_ps_per_edge")


def test_intersect():
    a = [(0, 2), (3, 5), (8, 9)]
    b = [(1, 4), (4.5, 8.5)]
    assert S.intersect(a, b) == [(1, 2), (3, 4), (4.5, 5), (8, 8.5)]
    assert S.intersect(a, []) == [] and S.intersect([], b) == []
    assert S.intersect([(0, 1)], [(1, 2)]) == []


def _spanned_trace(spans=True):
    """Busy [0, 1], [2, 3], [6, 7] of a window [0, 10]; a query span [0.5, 8]
    holding a push level [0.5, 2.5], its read [2.5, 4], a pull level [4, 6.5]
    and its read [6.5, 8], with an aten op inside the first read."""
    host = [("spla.bfs", 0.5, 8.0), ("spla.level.push", 0.5, 2.5), ("spla.level.read", 2.5, 4.0),
            ("aten::item", 3.0, 3.9), ("spla.level.pull", 4.0, 6.5), ("spla.level.read", 6.5, 8.0)]
    return trace.Trace(lo=0.0, hi=10.0, host_ops=host if spans else host[3:4], device_ops=[
        ("bfs_push_level_kernel(Walk)", 0.0, 1.0), ("void spmv_pull_structural_kernel<2>(HitArgs)", 2.0, 3.0),
        ("void bfs_update_kernel<true>(int, bool)", 6.0, 7.0)])


def test_spans_are_the_programs_host_ops_clipped_to_the_window():
    t = trace.Trace(lo=0.0, hi=10.0, device_ops=[], host_ops=[
        ("spla.bfs", -1.0, 4.0), ("aten::item", 1.0, 2.0), ("spla.level.read", 9.0, 12.0),
        ("splash", 0.0, 1.0)])
    assert S.spans(t) == [("spla.bfs", 0.0, 4.0), ("spla.level.read", 9.0, 10.0)]
    assert S.spans(trace.Trace(lo=0.0, hi=1.0, device_ops=[], host_ops=[])) == []


def test_idle_within_named_spans():
    t = _spanned_trace()
    # idle: [1, 2], [3, 6], [7, 10]
    assert S.idle_within(t, ("spla.bfs",)) == pytest.approx(1 + 3 + 1)  # [1, 2], [3, 6], [7, 8]
    assert S.idle_within(t, ("spla.level.read",)) == pytest.approx(1 + 1)  # [3, 4], [7, 8]
    assert S.idle_within(t, ("spla.level.push", "spla.level.pull")) == pytest.approx(1 + 2)  # [1, 2], [4, 6]
    assert S.idle_within(t, ("spla.sssp",)) == 0
    assert S.idle_within(t, ("aten::item",)) == 0  # only the program's spans count


def test_trace_from_events_keeps_a_spans_device_projection_out_of_device_ops():
    """The program's spans reach ``host_ops`` as the profiler's host events do;
    a span's projection onto the device (kineto's GPU user annotation) is no
    device operation, so it adds nothing to the busy time."""
    t0 = 10**18
    events = [
        Ev(trace.WINDOW, t0, 10_000),
        Ev("spla.bfs", t0 - 1_000, 6_000),  # clipped to [0, 5 us]
        Ev("spla.level.read", t0 + 3_000, 1_000),
        Ev("spla.bfs", t0 + 1_000, 2_000, device="CUDA", annotation=True),  # the span on the device
        Ev("spla.level.pull", t0 + 6_000, 1_000, thread=2),  # another thread
        Ev("spla.level.push", t0 + 20_000, 1_000),  # after the window
        Ev("kernel_a", t0 + 1_000, 1_000, device="CUDA"),
    ]
    t = trace.from_events(events)
    assert t.device_ops == [("kernel_a", pytest.approx(1e-6), pytest.approx(2e-6))]
    assert [(n, pytest.approx(s), pytest.approx(e)) for n, s, e in S.spans(t)] == [
        ("spla.bfs", 0.0, 5e-6), ("spla.level.read", 3e-6, 4e-6)]
    assert t.busy_s == pytest.approx(1e-6)
    assert S.idle_within(t, ("spla.bfs",)) == pytest.approx(4e-6)


def test_level_loop_readers_by_hand():
    run = Run("kron-bfs", trace_=_spanned_trace(), queries=2, levels=2)
    assert _reader("query_idle_us_per_level")(run) == pytest.approx(5 / 2 * 1e6)
    assert _reader("read_idle_us_per_level")(run) == pytest.approx(2 / 2 * 1e6)
    assert _reader("launch_idle_us_per_level")(run) == pytest.approx(3 / 2 * 1e6)
    assert _reader("idle_us_per_level")(run) == pytest.approx(7 / 2 * 1e6)  # the harness's time besides


def test_work_readers_by_hand():
    run = Run("kron-bfs", trace_=_spanned_trace(), queries=2, levels=2)
    run.counters["stats"].update(push=1, pull=1, push_edges=500, pull_entries=4000)
    assert _reader("pull_entries_per_query")(run) == 2000
    assert _reader("push_edges_per_query")(run) == 250
    assert _reader("pull_ps_per_entry")(run) == pytest.approx(1.0 / 4000 * 1e12)
    assert _reader("push_ps_per_edge")(run) == pytest.approx(1.0 / 500 * 1e12)
    # pull_entries_per_query x pull_ps_per_entry is pull_ms_per_query
    assert (_reader("pull_entries_per_query")(run) * _reader("pull_ps_per_entry")(run) * 1e-9
            == pytest.approx(_reader("pull_ms_per_query")(run)))
    sssp = Run("urand-sssp", trace_=trace.Trace(lo=0.0, hi=1.0, host_ops=[], device_ops=[
        ("sssp_push_kernel(Walk)", 0.0, 0.1), ("sssp_touched_kernel(int const*)", 0.1, 0.15),
        ("void sssp_update_kernel<true>(int)", 0.15, 0.2)]))
    sssp.counters["stats"].update(push=3, push_edges=1000)
    assert _reader("push_ps_per_edge")(sssp) == pytest.approx(0.15 / 1000 * 1e12)


@pytest.mark.parametrize("name", NEW_READERS)
@pytest.mark.parametrize("case", ["no trace", "no spans or counters", "no levels", "no push levels"])
def test_the_programs_readers_read_nothing_where_nothing_is(name, case):
    """A run with no trace, a program without the spans or counters (as
    before they were added), no levels, or no push level (PageRank): the
    readers that read it give None."""
    run = Run("kron-bfs", trace_=_spanned_trace(), queries=2, levels=2)
    run.counters["stats"].update(push=1, pull=1, push_edges=500, pull_entries=4000)
    reads = {"no trace": ("pull_ps_per_entry", "push_ps_per_edge", "query_idle_us_per_level",
                          "read_idle_us_per_level", "launch_idle_us_per_level"),
             "no spans or counters": NEW_READERS,
             "no levels": NEW_READERS,
             "no push levels": ("push_edges_per_query", "push_ps_per_edge")}[case]
    if case == "no trace":
        run.trace = None
    elif case == "no spans or counters":
        run.trace = _spanned_trace(spans=False)
        run.counters["stats"] = {"levels": 2}
    elif case == "no levels":
        run.counters["stats"] = {"levels": 0, "push": 0, "pull": 0, "push_edges": 0, "pull_entries": 0}
    else:
        run.counters["stats"].update(push=0, push_edges=0)
    assert (_reader(name)(run) is None) == (name in reads)


def _traced_queries(device, scale, monkeypatch):
    """A trace of four BFS queries by the program on ``urand-bfs``'s graph cut
    to ``scale``, through the level loop, as the cells' graphs take it."""
    from spla_tpu_torch import algorithms

    monkeypatch.setattr(algorithms, "RESIDENT_BYTES", 0)
    cell = find_cell("urand-bfs")
    graph = G.build(cell.config, 7, device, scale)
    kind = load_module("queries", "bfs")
    A = kind.prepare(graph, cell.mix)
    sources, hub = G.sources(graph, 3, 4)
    kind.warm(A, hub, cell.mix)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()

    def loop():
        for s in sources:
            kind.run(A, s, cell.mix)
        sync()

    return trace.capture(loop, device.type == "cuda")[1]


def _check_traced_queries(t):
    names = [n for n, _, _ in S.spans(t)]
    assert names.count("spla.bfs") == 4
    assert {"spla.level.read", "spla.level.push"} <= set(names) <= {
        "spla.bfs", "spla.level.push", "spla.level.pull", "spla.level.read"}
    assert not [n for n, _, _ in t.device_ops if n.startswith(S.PREFIX)]
    idle = t.window_s - t.busy_s
    assert 0 < S.idle_within(t, ("spla.level.read",)) <= S.idle_within(t, ("spla.bfs",)) <= idle


def test_the_programs_spans_reach_the_trace_on_the_cpu(monkeypatch):
    _check_traced_queries(_traced_queries(torch.device("cpu"), 10, monkeypatch))


@pytest.mark.cuda
def test_the_programs_spans_reach_the_trace_on_the_device(cuda_device, monkeypatch):
    t = _traced_queries(cuda_device, 16, monkeypatch)
    assert t.device_ops
    _check_traced_queries(t)
