"""Kernels 4 and 5 on the three SpGEMM-T graphs of ``chip_smoke.py`` and on
three of higher degree, timed with CUDA events; one JSON line a graph.

* ``tc15`` — ``random_graph(2**15, 24, seed=3)`` (``bench_suite.py:513-514``),
  mask = A = B, as ``tc`` calls it;
* ``tc20`` — ``random_graph(2**20, 16)`` (``bench_suite.py:24``), the same;
* ``hub`` — ``graphs.hub_spgemm(2**17)``: A = B with three rows of 2^16
  drawn columns, and a mask that reaches them;
* ``deg48``, ``deg96``, ``deg192`` — ``random_graph(n, d)`` at d = 48, 96
  and 192 and n = 2^18, 2^17 and 2^16 (12.6 M stored entries each), mask =
  A = B: B rows several times longer than a team of two lanes' batch;
* ``u24`` — ``graphs.uniform_csr(2**24, 32)``, made on the card: the size
  and degree of GAP's urand graph at scale 24 (~537 M stored entries).

On each: kernel 4 structural (the full walk) and MULT i32 and kernel 5
MULT/PLUS i32, with every stored mask entry selected (no selection, as the
structural calls of ``tc`` pass), and the gather floor
(``kernels.probe.mxmt_gather``: B's rows with and without values, no probe
of A); kernel 4's ordered walk (``tc``'s call on a symmetric 0/1 pattern,
the entries (i, j) with j < i over row j's columns below j) and its gather
floor (the same prefix walk with no probe of A), with the first check of
``ordered_walk`` on a mask = A (its seconds, ``check_s``).  At n = 2^20
also the walls of ``tc`` and of ``mxmT_masked`` MULT/PLUS i32 (host clock
around a synchronized call, median of 3) and, with ``--profile``, one call
of each under ``torch.profiler``: its wall with the profiler on, the
device's busy time (the union of its kernel, copy and memset intervals),
the idle share (1 - busy / wall) and the largest device items.  Each
function is launched ``--reps`` times after 3 warm-up launches, every
graph's functions forward and then backward, and the two means averaged.

Usage::

    python -m spla_tpu_torch.tools.mxmt_times [--graphs tc15,tc20,hub,deg48,...] [--reps 20] [--label NAME]
        [--profile]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import algorithms as alg, formats as F, op
from ..kernels import mxmt as K45, probe as K8
from ..ops import mxmT_masked
from .ab_spmv import device_of
from .graphs import hub_spgemm, random_graph, uniform_csr
from .resident_levels import card

GRAPHS = ("tc15", "tc20", "hub")
DEG_GRAPHS = {"deg48": (1 << 18, 48), "deg96": (1 << 17, 96), "deg192": (1 << 16, 192)}
CARD_GRAPHS = {"u24": (1 << 24, 32)}


def operands(name, device):
    """``(mask, A)`` of a graph (B = A), int32, on ``device``."""
    if name == "hub":
        a, mask = hub_spgemm(1 << 17)
        a = a.astype(np.int32)
        a.data = np.random.default_rng(7).integers(-1000, 1000, a.nnz, dtype=np.int32)
        return F.csr_from_scipy(mask.astype(np.int32), device=device), F.csr_from_scipy(a, device=device)
    if name in CARD_GRAPHS:
        A = uniform_csr(*CARD_GRAPHS[name], device)
        return A, A
    if name in DEG_GRAPHS:
        a = random_graph(*DEG_GRAPHS[name], seed=5)
    else:
        a = random_graph(1 << 15, 24, seed=3) if name == "tc15" else random_graph(1 << 20, 16)
    A = F.csr_from_scipy(a.astype(np.int32), device=device)
    return A, A


def functions(mask, A):
    """The timed calls on one graph, by name."""
    return {"k4 structural": lambda: K45.mxmt_reduce(mask, A, A, None, struct_only=True),
            "k4 ordered": lambda: K45.mxmt_reduce(mask, A, A, None, struct_only=True, ordered=True),
            "k4 MULT i32": lambda: K45.mxmt_reduce(mask, A, A, op.MULT_INT),
            "k5 MULT/PLUS i32": lambda: K45.mxmt_masked(mask, A, A, op.MULT_INT, op.PLUS_INT, 0),
            "gather cols": lambda: K8.mxmt_gather(mask, A, False),
            "gather cols ordered": lambda: K8.mxmt_gather(mask, A, False, ordered=True),
            "gather cols+values": lambda: K8.mxmt_gather(mask, A, True)}


def cuda_ms(fn, reps, warmup=3):
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


def wall_ms(fn):
    fn()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return sorted(walls)[1]


def profiled(fn):
    """One call of ``fn`` under torch.profiler (after one without):
    ``{"wall_ms", "busy_ms", "idle_share", "top"}``, top the four device
    items with the most time as ``[name, calls, ms]``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end, items = 0.0, float("-inf"), {}
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        calls, us = items.get(name, (0, 0.0))
        items[name] = (calls + 1, us + stop - start)
    top = sorted(items.items(), key=lambda kv: -kv[1][1])[:4]
    return {"wall_ms": wall, "busy_ms": busy / 1e3, "idle_share": 1 - busy / 1e3 / wall,
            "top": [[name[:80], calls, us / 1e3] for name, (calls, us) in top]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    every = (*GRAPHS, *DEG_GRAPHS, *CARD_GRAPHS)
    ap.add_argument("--graphs", default=",".join(GRAPHS), help=f"comma-separated, of {every}")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--label", default="", help="names the tree in the JSON line")
    ap.add_argument("--profile", action="store_true", help="profile tc and mxmT_masked at n = 2^20")
    args = ap.parse_args(argv)
    names = args.graphs.split(",")
    unknown = set(names) - set(every)
    if unknown:
        raise ValueError(f"unknown graphs {sorted(unknown)}; graphs: {every}")
    device = device_of("cuda")
    smi = card()
    for name in names:
        mask, A = operands(name, device)
        fns = functions(mask, A)
        ms = {k: 0.0 for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for k in order:
                ms[k] += cuda_ms(fns[k], args.reps) / 2
        row = {"label": args.label, "graph": name, "n": A.shape[0], "nnz": int(A.nnz),
               "mask_nnz": int(mask.nnz), "ms": ms, "card": smi}
        plan = K45.mxmt_plan(mask, A)
        row["plan"] = {"hubs": plan.nhub, "chunks": plan.nchunks, "products": plan.products}
        if mask is A:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            row["ordered_walk"] = K45.ordered_walk(A)  # None: tc would take the full walk
            row["check_s"] = time.perf_counter() - t0
        if name == "tc20":
            calls = {"tc": lambda: alg.tc(A),
                     "mxmT_masked MULT/PLUS i32": lambda: mxmT_masked(A, A, A, op.MULT_INT, op.PLUS_INT,
                                                                       op.GTZERO_INT, 0)}
            row["walls_ms"] = {k: wall_ms(fn) for k, fn in calls.items()}
            if args.profile:
                row["profiled"] = {k: profiled(fn) for k, fn in calls.items()}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
