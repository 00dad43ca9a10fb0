"""The BFS / SSSP level loop's time a level, split into its parts, and kernels
2 and 3 at a real level's frontier; a JSON line a run.

Graphs (``--graphs``):

* ``road1024`` — BFS on the side-1024 road grid (``bench_suite.py:226-253``);
* ``road512`` — SSSP on its side-512 corner (``bench_suite.py:323-334``);
* ``road3072`` — BFS on ``road_big_bfs_gteps``'s side-3072 grid
  (``bench_suite.py:269-319``);
* ``rand20`` — ``random_graph(2**20, 16)`` (``bench_suite.py:24``), BFS, and
  SSSP with weights uniform(0.1, 2.0) from seed 2;
* ``skewed`` — ``graphs.skewed_graph()`` (``bench_suite.py:441-448``),
  BFS and SSSP (its own weights) from vertex 0.

Each run takes the level loop (``algorithms.RESIDENT_BYTES`` set to 0; the
skewed graph takes it anyway) from vertex 0, in the default mode.  Its row:

* ``wall_ms`` (host clock around a synchronized run, median of 3), levels,
  push and pull levels, and ``us_per_level``;
* ``read_ms``: the time spent in the loop's count reads (``algorithms.
  _host_count``), which wait for the level's kernels and copy one word;
  ``host_ms``: the rest of the wall, the host's own work (wrappers,
  launches, Python);
* on a card, from one run under ``torch.profiler``: ``device_busy_ms`` (the
  union of kernel, copy and memset intervals), ``kernel_busy_ms`` (kernels
  only), ``device_us_per_level``, the idle share against ``wall_ms``, and
  the device time of each kernel and copy by name;
* ``kernels``: at the frontier of the loop's middle level (its vertices at
  depth max / 2 of a scipy BFS), kernel 2 (``spmv_push`` MIN-plus and
  ``spmv_push_structural``) and kernel 3 (``bfs_level_update`` on the
  structural push's hits, ``sssp_level_update`` on the MIN-plus push's):
  ``eager_ms`` (CUDA events over ``--reps`` launches after 3), ``graph_ms``
  (the device's time: a CUDA graph of ``--reps`` captured calls replayed
  between CUDA events) and ``host_us`` (the host's time to issue one call,
  host clock over ``--reps`` calls with no sync); the SSSP update's eager
  and graph times hold a fill of its distances with +inf before each call
  (``with_reset``).

``--device cpu`` runs the plain versions on the CPU: walls and the split are
host times, and every device field is null (not measured).  ``--small``
cuts the graphs (road sides 16, 8 and 24; n = 2^10) for that.  The tool
uses only entry points the port has had since its level loop began, so a
copy of it (with ``tools/graphs.py``) runs in an older tree unpacked beside
this one, to time the two in turns.

Usage::

    python -m spla_tpu_torch.tools.level_times [--graphs road1024,skewed,...] [--reps 20] [--label NAME]
    python -m spla_tpu_torch.tools.level_times --device cpu --small
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import scipy.sparse.csgraph as cg
import torch

from .. import algorithms as alg, formats as F, op
from ..kernels import level_update as K3, traversal as K2
from .ab_spmv import device_of
from .graphs import random_graph, road_graphs, road_grid, skewed_graph
from .resident_levels import card

GRAPHS = ("road1024", "road512", "road3072", "rand20", "skewed")


def graphs(name, small):
    """``[(kind, scipy matrix), ...]`` of a graph; BFS ignores the values."""
    if name in ("road1024", "road512"):
        road, road_w = road_graphs(16, 8) if small else road_graphs(1024, 512)
        return [("bfs", road)] if name == "road1024" else [("sssp", road_w)]
    if name == "road3072":
        return [("bfs", road_grid(24 if small else 3072))]
    if name == "rand20":
        a = random_graph(1 << 10 if small else 1 << 20, 16)
        a.data = np.random.default_rng(2).uniform(0.1, 2.0, a.nnz).astype(np.float32)
        return [("bfs", a), ("sssp", a)]
    a = skewed_graph(1 << 10 if small else 1 << 18)
    return [("bfs", a), ("sssp", a)]


@contextlib.contextmanager
def level_loop():
    """The resident route gated off, and the count reads timed:
    yields the list their seconds are appended to."""
    saved, read = alg.RESIDENT_BYTES, alg._host_count
    reads = []

    def timed(*args):
        t0 = time.perf_counter()
        out = read(*args)
        reads.append(time.perf_counter() - t0)
        return out

    alg.RESIDENT_BYTES, alg._host_count = 0, timed
    try:
        yield reads
    finally:
        alg.RESIDENT_BYTES, alg._host_count = saved, read


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def loop_row(kind, A, device, descriptor=None):
    """The level loop's wall, its split and its STATS (median of 3 runs)."""
    algo = alg.bfs if kind == "bfs" else alg.sssp

    def fn(A, source):
        return algo(A, source, descriptor)

    runs = []
    with level_loop() as reads:
        fn(A, 0)
        for _ in range(3):
            for key in alg.STATS:
                alg.STATS[key] = 0
            reads.clear()
            sync(device)
            t0 = time.perf_counter()
            fn(A, 0)
            sync(device)
            wall = (time.perf_counter() - t0) * 1e3
            runs.append((wall, sum(reads) * 1e3, dict(alg.STATS)))
    wall, read_ms, stats = sorted(runs, key=lambda r: r[0])[1]
    if stats["level_loop"] != 1:
        raise AssertionError(f"{kind}: the run did not take the level loop: {stats}")
    levels = stats["levels"]
    return {"wall_ms": wall, "walls_ms": [r[0] for r in runs], "levels": levels, "push": stats["push"],
            "pull": stats["pull"], "host_syncs": stats["host_syncs"], "us_per_level": wall * 1e3 / levels,
            "read_ms": read_ms, "host_ms": wall - read_ms}


def profile_row(kind, A, wall_ms, levels, descriptor=None):
    """One level-loop run under torch.profiler: device busy time, kernel
    busy time, and each device item's calls and ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn = alg.bfs if kind == "bfs" else alg.sssp
    with level_loop():
        fn(A, 0, descriptor)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(A, 0, descriptor)
            torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy = {"all": 0.0, "kernels": 0.0}
    last = {"all": float("-inf"), "kernels": float("-inf")}
    items = {}
    for start, stop, name in spans:
        kinds = ("all",) if name.startswith(("Memcpy", "Memset")) else ("all", "kernels")
        for k in kinds:
            busy[k] += max(0.0, stop - max(start, last[k]))
            last[k] = max(last[k], stop)
        calls, us = items.get(name, (0, 0.0))
        items[name] = (calls + 1, us + stop - start)
    top = sorted(items.items(), key=lambda kv: -kv[1][1])[:6]
    return {"device_busy_ms": busy["all"] / 1e3, "kernel_busy_ms": busy["kernels"] / 1e3,
            "device_us_per_level": busy["all"] / levels, "kernel_us_per_level": busy["kernels"] / levels,
            "idle_share": 1 - busy["all"] / 1e3 / wall_ms,
            "items": [[name[:70], calls, us / 1e3] for name, (calls, us) in top]}


def middle_frontier(a):
    """The vertices at depth max / 2 of a BFS from vertex 0 (int32)."""
    lev = cg.shortest_path(a, method="D", unweighted=True, indices=0)
    depth = int(np.max(lev[np.isfinite(lev)])) // 2
    return np.flatnonzero(lev == depth).astype(np.int32)


def host_us(fn, reps, device):
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    sync(device)
    return (t1 - t0) * 1e6 / reps


def eager_ms(fn, reps, device):
    for _ in range(3):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps, replays=5):
    """The device's time a call: ``reps`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def kernel_rows(a, device, reps):
    """Kernels 2 and 3 at the middle level's frontier."""
    n = a.shape[0]
    A = F.csr_from_scipy(a.astype(np.float32), fill=np.float32(np.inf), device=device)
    front = torch.from_numpy(middle_frontier(a)).to(device)
    d = torch.from_numpy(np.random.default_rng(8).uniform(0, 10, n).astype(np.float32)).to(device)
    inf = torch.tensor(float("inf"), device=device)
    hits_b = K2.spmv_push_structural(A, front)
    hits_f = K2.spmv_push(A, front, d, op.PLUS_FLOAT, op.MIN_FLOAT, inf)
    v = torch.zeros(n, dtype=torch.int32, device=device)
    f = torch.zeros(n, dtype=torch.bool, device=device)
    f[front.long()] = True
    sv = torch.full((n,), float("inf"), device=device)
    ch = torch.zeros(n, dtype=torch.bool, device=device)
    lst = torch.empty(n, dtype=torch.int32, device=device)
    cnt = torch.zeros(1, dtype=torch.int32, device=device)
    # (call, reset before each timed call or None): the SSSP update changes
    # nothing once v holds the hits, so its distances go back to +inf
    fns = {"spmv_push MIN-plus": (lambda: K2.spmv_push(A, front, d, op.PLUS_FLOAT, op.MIN_FLOAT, inf), None),
           "spmv_push structural": (lambda: K2.spmv_push_structural(A, front), None),
           "bfs_level_update": (lambda: K3.bfs_level_update(hits_b, v, f, 3, lst, cnt), None),
           "sssp_level_update": (lambda: K3.sssp_level_update(hits_f, sv, ch, lst, cnt),
                                 lambda: sv.fill_(float("inf")))}
    ip = a.indptr.astype(np.int64)
    f_np = front.cpu().numpy()
    rows = {"frontier": int(front.numel()), "frontier_edges": int((ip[f_np + 1] - ip[f_np]).sum())}
    for name, (call, reset) in fns.items():
        fn = call if reset is None else (lambda call=call, reset=reset: (reset(), call()))
        rows[name] = {"eager_ms": eager_ms(fn, reps, device), "host_us": host_us(call, reps, device),
                      "graph_ms": graph_ms(fn, reps) if device.type == "cuda" else None,
                      "with_reset": reset is not None}
    return rows


def run(name, kind, a, device, reps, label, smi):
    A = F.csr_from_scipy(a, fill=np.float32(np.inf), device=device)
    row = {"label": label, "graph": name, "kind": kind, "n": a.shape[0], "nnz": int(a.nnz),
           "device": str(device), "card": smi, **loop_row(kind, A, device)}
    if device.type == "cuda":
        row.update(profile_row(kind, A, row["wall_ms"], row["levels"]))
    row["kernels"] = kernel_rows(a, device, reps)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--graphs", default=",".join(GRAPHS), help=f"comma-separated, of {GRAPHS}")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--label", default="", help="names the tree in the JSON lines")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="tiny graphs, for a run of the plain versions")
    args = ap.parse_args(argv)
    names = args.graphs.split(",")
    unknown = set(names) - set(GRAPHS)
    if unknown:
        raise ValueError(f"unknown graphs {sorted(unknown)}; graphs: {GRAPHS}")
    device = device_of(args.device)
    smi = card() if device.type == "cuda" else None
    rows = []
    for name in names:
        for kind, a in graphs(name, args.small):
            row = run(name, kind, a, device, args.reps, args.label, smi)
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
