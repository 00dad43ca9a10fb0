"""One run of one cell, from the graph to the result's line.

Set-up builds the configuration's graph on the device from the seed, hands
it to the program (the query kind's ``prepare``), frees the benchmark's own
generation scratch and warms the program up on the cell's own shapes.  The
window then runs the mix's queries in a closed loop (``core.window``), under
the profiler when traced.  After it closes and the peak memory has been
read, the program's state is freed, the graph is made again from its seed,
and the plain reference (``graphbench/reference/<kind>.py``) judges the
sampled results.  The metrics' readers (``graphbench/metrics/<name>.py``)
then read the run.
"""

from __future__ import annotations

import gc
import math
import random
import subprocess
import sys
import time
from dataclasses import dataclass

import torch

from . import graph as G
from . import port
from . import trace as T
from .spec import Cell, load_module
from .window import Window, closed_loop

SOURCE_COUNT = 1 << 16  # sources drawn a run; a window that runs more starts over


@dataclass
class RunRecord:
    """What the metrics' readers read."""

    cell: Cell
    n: int
    nnz: int
    setup_s: float
    window: Window
    memory_peak_bytes: int | None  # over the window, from a reset at its start; None off the device
    sample_bytes: int  # the benchmark's own slots for the sampled results, on the device all through the window
    counters: dict  # the program's counters over the window (``core.port.counters_since``)
    trace: T.Trace | None
    device_name: str | None

    @property
    def queries(self) -> int:
        return len(self.window.latencies_s)


def sync_of(device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _num(v):
    """A number for the result's line: JSON has no NaN or infinity."""
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        done = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return done.stdout.strip().splitlines()[0] if done.returncode == 0 and done.stdout.strip() else None


def judge(ref_mod, graph, sample, mix, limits, log) -> tuple:
    """``(worst, wrong)``: the worst reading of each compared number over the
    sampled results, and how many of them read over a limit."""
    refs, worst, wrong = {}, {}, 0
    for index, source, out in sample:
        if source not in refs:
            refs[source] = ref_mod.reference(graph, source, mix)
        numbers = ref_mod.compare(out, refs[source], mix)
        log(f"check: query {index} source {source}: "
            + ", ".join(f"{k} {v!r}" for k, v in numbers.items()))
        wrong += not verdict(numbers, limits)
        for k, v in numbers.items():
            worst[k] = v if k not in worst or not v <= worst[k] else worst[k]
    return worst, wrong


def verdict(worst: dict, limits: dict) -> bool:
    """Every number compared, each at most its limit (a NaN never passes)."""
    return set(worst) == set(limits) and all(worst[k] <= limits[k] for k in limits)


def execute(cell: Cell, seed: int, seconds: float, traced: bool, t_start: float,
            rehearse_scale: int | None = None, log=None) -> dict:
    """Run the cell; return the result's object (``checked`` its last key)."""
    log = log or (lambda line: print(line, file=sys.stderr, flush=True))
    marks = [("start", t_start), ("imports", time.perf_counter())]  # set-up's phases, for the log
    device = torch.device("cpu") if rehearse_scale is not None else torch.device("cuda", 0)
    on_device = device.type == "cuda"
    sync = sync_of(device)
    mix = cell.mix
    kind = load_module("queries", mix["query"])
    ref_mod = load_module("reference", mix["query"])
    if on_device:
        port.build_kernels()
    marks.append(("kernels", time.perf_counter()))

    graph_seed = G.graph_seed(cell.config, seed)
    graph = G.build(cell.config, graph_seed, device, rehearse_scale)
    n, nnz, checksum = graph.n, graph.nnz, graph.checksum
    sources, hub = (G.window_sources(graph, cell.config, mix, seed, SOURCE_COUNT) if kind.SOURCES
                    else ([None], None))
    sync()
    marks.append(("graph", time.perf_counter()))
    state = kind.prepare(graph, mix)
    del graph
    free(device)
    sync()
    marks.append(("program", time.perf_counter()))
    shape_of = kind.warm(state, hub, mix)
    held = torch.cuda.memory_allocated(device) if on_device else 0
    slots = [torch.empty_like(shape_of) for _ in range(int(mix["check"]["sample"]))]
    sample_bytes = torch.cuda.memory_allocated(device) - held if on_device else 0
    del shape_of
    sync()
    if on_device:
        torch.cuda.reset_peak_memory_stats(device)
    before = port.counters()
    setup_s = time.perf_counter() - t_start
    marks.append(("warm-up", t_start + setup_s))
    phases = ", ".join(f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:]))
    log(f"set-up {setup_s:.3f} s ({phases}): n {n}, stored entries {nnz}, graph checksum {checksum}")

    rng = random.Random(G.sub_seed(seed, "sample"))

    def loop():
        return closed_loop(lambda s: kind.run(state, s, mix), sources, seconds, sync, slots, rng)

    window, trace = T.capture(loop, on_device) if traced else (loop(), None)
    peak = torch.cuda.max_memory_allocated(device) if on_device else None
    delta = port.counters_since(before)
    del state
    free(device)
    log(f"window {window.elapsed_s:.6f} s: {window.attempted} queries, {window.failed} failed; "
        f"peak {peak} bytes, of which the sample's slots {sample_bytes}")
    if window.error:
        log(window.error)

    record = RunRecord(cell=cell, n=n, nnz=nnz, setup_s=setup_s, window=window, memory_peak_bytes=peak,
                       sample_bytes=sample_bytes, counters=delta, trace=trace,
                       device_name=torch.cuda.get_device_name(device) if on_device else None)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = load_module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    again = G.build(cell.config, graph_seed, device, rehearse_scale)
    same_graph = again.checksum == checksum
    if not same_graph:
        log(f"check: the graph made again has checksum {again.checksum}, not {checksum}")
    limits = mix["check"]["limits"]
    worst, wrong = judge(ref_mod, again, window.sample, mix, limits, log)
    del again
    correct = bool(window.failed == 0 and window.sample and same_graph and verdict(worst, limits))

    result = {"correct": correct, "attempted": window.attempted, "failed": window.failed + wrong,
              "metrics": metrics}
    if on_device:
        result["device"] = {"platform": "gpu", "kind": record.device_name, "count": 1,
                            "memory_peak_bytes": peak, "power": power_limit()}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu rehearsal", "count": 0, "memory_peak_bytes": None}
    if trace is not None and on_device:
        result["device"]["busy_s"] = trace.busy_s
        result["device"]["window_s"] = trace.window_s
        result["breakdown"] = trace.breakdown()
    result["checked"] = {k: {"value": _num(worst.get(k, float("nan"))), "limit": limits[k]} for k in limits}
    return result
