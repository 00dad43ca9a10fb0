"""The frozen metric arithmetic: the busy-interval union, the idle gaps and their
names, the roofline's bytes and bound, the readers, against hand-made values."""

import pytest

from graphbench.core import roofline, trace
from graphbench.core.spec import find_cell, load_module


def test_union_and_length():
    assert trace.union([(5, 6), (0, 2), (1, 3), (3, 4), (6, 6.5)]) == [(0, 4), (5, 6.5)]
    assert trace.length(trace.union([(0, 1), (0.5, 2), (10, 11)])) == 3
    assert trace.union([]) == []


def test_gaps():
    merged = [(1, 2), (3, 4), (9, 12)]
    assert trace.gaps(merged, 0, 10) == [(0, 1), (2, 3), (4, 9)]
    assert trace.gaps(merged, 1.5, 3.5) == [(2, 3)]
    assert trace.gaps([], 0, 1) == [(0, 1)]


def test_innermost_names_nested_host_ops():
    ops = [("outer", 0, 10), ("read", 2, 5), ("sync", 3, 4), ("launch", 6, 7)]
    assert trace.innermost(ops, [1, 3.5, 4.5, 6.5, 8, 12]) == ["outer", "sync", "read", "launch", "outer", None]


def test_top():
    pairs = [("a", 1.0), ("b", 3.0), ("a", 2.5), ("c", 0.5)]
    assert trace.top(pairs, 2) == [["a", 3.5], ["b", 3.0]]


def test_short_name():
    long = "void (anonymous namespace)::spmv_pull_kernel<float, 1, 0, 3>(PullArgs<float>, PullPlan)"
    assert trace.short_name(long) == "spmv_pull_kernel<float, 1, 0, 3>"
    assert trace.short_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"


class Ev:
    """The few members of a profiler event that ``trace.from_events`` reads."""

    def __init__(self, name, start_ns, dur_ns, device="CPU", thread=1, annotation=False):
        self._v = (name, start_ns, dur_ns, device, thread, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return f"DeviceType.{self._v[3]}"

    def start_thread_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_trace_from_events_by_hand():
    t0 = 10**18
    events = [
        Ev(trace.WINDOW, t0, 10_000),
        Ev(trace.WINDOW, t0, 10_000, device="CUDA", annotation=True),  # the span mirrored on the device
        Ev("kernel_a", t0 - 1_000, 3_500, device="CUDA"),  # clipped to [0, 2.5 us]
        Ev("kernel_b", t0 + 1_000, 2_000, device="CUDA"),
        Ev("Memcpy DtoH (Device -> Pinned)", t0 + 6_000, 1_000, device="CUDA"),
        Ev("aten::item", t0 + 3_000, 3_500),
        Ev("other thread", t0, 10_000, thread=2),
    ]
    t = trace.from_events(events)
    assert t.window_s == pytest.approx(10e-6)
    assert t.busy_s == pytest.approx(4e-6)  # [0, 3] and [6, 7] us
    gaps = t.idle_gaps()
    assert [n for n, _ in gaps] == ["host: aten::item", "python"]
    assert [s for _, s in gaps] == pytest.approx([3e-6, 3e-6])
    assert t.device_time(r"kernel_") == (pytest.approx(4.5e-6), 2)
    b = t.breakdown()
    assert b["device_ops"][0] == ["kernel_a", pytest.approx(2.5e-6)]
    assert len(b["idle_gaps"]) == 2


def test_roofline_bytes_and_bound():
    # m = n = 1000, 5000 entries: indptr 4004, cols and values 40000, x 4000, y 4000
    assert roofline.spmv_pull_work(1000, 1000, 5000) == (52004, 10000)
    h100 = roofline.PEAKS["NVIDIA H100 80GB HBM3"]
    s, by = roofline.bound_s(3.35e12, 0, h100)
    assert (s, by) == (pytest.approx(1.0), "bytes")
    s, by = roofline.bound_s(1, 67e12 * 2, h100)
    assert (s, by) == (pytest.approx(2.0), "operations")


class Run:
    """A hand-made run record for the readers."""

    def __init__(self, cell, trace_=None, queries=4, levels=20, elapsed=2.0, n=1000, nnz=5000):
        self.cell = find_cell(cell)
        self.n, self.nnz = n, nnz
        self.setup_s = 12.5
        self.window = type("W", (), {"latencies_s": [0.5] * queries, "elapsed_s": elapsed})()
        self.memory_peak_bytes = 3 * 2**30 + 3 * 2**20
        self.sample_bytes = 3 * 2**20  # the sample's slots, which peak_mem_gib takes off
        self.counters = {"stats": {"levels": levels}, "launches": {}}
        self.trace = trace_
        self.device_name = "NVIDIA H100 80GB HBM3"

    @property
    def queries(self):
        return len(self.window.latencies_s)


def _reader(name):
    return load_module("metrics", name).read


def test_end_to_end_readers_by_hand():
    run = Run("kron-bfs", queries=40)
    lat = [i / 1000 for i in range(1, 41)]  # 1..40 ms
    run.window.latencies_s = lat
    assert _reader("queries_per_s")(run) == pytest.approx(20.0)
    assert _reader("query_p95_ms")(run) == pytest.approx(38.05)  # inclusive: 38 + 0.05 * (39 - 38)
    assert _reader("peak_mem_gib")(run) == 3.0
    assert _reader("setup_s")(run) == 12.5
    run.window.latencies_s = lat[:10]
    assert _reader("query_p95_ms")(run) is None


def test_per_layer_readers_by_hand():
    t = trace.Trace(lo=0.0, hi=1.0, host_ops=[], device_ops=[
        ("void spmv_pull_structural_kernel<2>(HitArgs, PullPlan)", 0.0, 0.2),
        ("void spmv_pull_kernel<float, 1, 0, 3>(PullArgs<float>, PullPlan)", 0.2, 0.3),
        ("bfs_push_level_kernel(Walk, int*, unsigned char*, unsigned int*, int, Next)", 0.3, 0.4),
        ("void bfs_update_kernel<true>(int, bool)", 0.4, 0.45),
        ("void sssp_touched_kernel(int const*)", 0.45, 0.5),
        ("Memcpy DtoH (Device -> Pinned)", 0.6, 0.7),
    ])
    run = Run("kron-bfs", trace_=t, queries=4, levels=20)
    assert _reader("levels_per_query")(run) == 5.0
    assert _reader("device_idle_share")(run) == pytest.approx(40.0)
    assert _reader("idle_us_per_level")(run) == pytest.approx(0.4 / 20 * 1e6)
    assert _reader("pull_ms_per_query")(run) == pytest.approx(0.3 / 4 * 1e3)
    assert _reader("push_update_ms_per_query")(run) == pytest.approx(0.2 / 4 * 1e3)
    assert _reader("k1_roofline")(run) is None  # a traversal's pulls select rows
    pr = Run("kron-pr", trace_=t, n=1000, nnz=5000)
    assert _reader("k1_roofline")(pr) == pytest.approx(52004 / 3.35e12 / 0.1 * 100)
    pr.device_name = "some other card"
    assert _reader("k1_roofline")(pr) is None


def test_readers_of_device_numbers_read_nothing_off_the_device():
    run = Run("kron-bfs", trace_=trace.Trace(lo=0.0, hi=1.0, device_ops=[], host_ops=[]))
    run.memory_peak_bytes = None
    for name in ("peak_mem_gib", "device_idle_share", "idle_us_per_level", "pull_ms_per_query",
                 "push_update_ms_per_query", "k1_roofline"):
        assert _reader(name)(run) is None
