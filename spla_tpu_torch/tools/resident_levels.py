"""Kernel 6's time a round, on graphs whose rounds do little or much work; a
JSON line a run.

Kernel 6 (``kernels/resident.py``) runs a whole BFS or SSSP in one launch,
one round a level.  On the path graph every round holds one vertex, so the
kernel's time over its rounds is what a round costs with almost no work;
the other graphs put that beside real work:

* ``path`` — ``graphs.path_graph(4096)``, BFS and SSSP from vertex 0;
* ``road1024`` / ``road512`` — the road cells' grids (``bench_suite.py:226-253,
  323-334``): BFS on the side-1024 grid, SSSP on its side-512 corner;
* ``random`` — ``random_graph(2**18, 16)``, BFS, and SSSP with weights
  uniform(0.1, 2.0) from seed 2: few rounds, most of them wide;
* ``barbell`` — ``graphs.barbell_graph(512, 2**16, 16)``: rounds of one
  vertex and rounds of most of a block, in turn;
* ``road3072`` — ``road_big_bfs_gteps``'s side-3072 grid (``bench_suite.py:
  269-319``), BFS, beyond ``algorithms.RESIDENT_BYTES``: the kernel is called
  directly.

Each run is launched ``--reps`` times after two warm-up launches and timed
with CUDA events.  ``--every-round-wide`` launches the kernel with T = 0, so
that every round runs on the whole grid and ends at its barrier: the
design without its lead cluster.

Usage::

    python -m spla_tpu_torch.tools.resident_levels [--graphs path,road1024,...] [--reps 20]
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from .. import formats as F
from ..kernels import resident as K6
from .ab_spmv import device_of
from .graphs import barbell_graph, path_graph, random_graph, road_graphs, road_grid

GRAPHS = ("path", "road1024", "road512", "random", "barbell", "road3072")
PATH_N = 4096
RANDOM_N, RANDOM_DEG = 1 << 18, 16  # bench_suite.py:24 random_graph at a quarter of its n
BARBELL = (512, 1 << 16, 16)  # path length, block vertices, block degree


def weighted_random(n=RANDOM_N, deg=RANDOM_DEG):
    """``random_graph(n, deg)`` with weights uniform(0.1, 2.0) from seed 2, as
    ``chip_smoke.py`` weights its n = 2^20 graph."""
    a = random_graph(n, deg)
    a.data = np.random.default_rng(2).uniform(0.1, 2.0, a.nnz).astype(np.float32)
    return a


def build(names, device):
    """``{graph: [(kind, A, source), ...]}`` on ``device``."""
    def csr(a):
        return F.csr_from_scipy(a, fill=np.float32(np.inf), device=device)

    out = {}
    if "road1024" in names or "road512" in names:
        road, road_w = road_graphs(1024, 512)
        out["road1024"] = [("bfs", csr(road), 0)]
        out["road512"] = [("sssp", csr(road_w), 0)]
    makers = {"path": lambda: path_graph(PATH_N), "random": weighted_random,
              "barbell": lambda: barbell_graph(*BARBELL), "road3072": lambda: road_grid(3072)}
    for name, make in makers.items():
        if name in names:
            A = csr(make())
            out[name] = [("bfs", A, 0)] if name == "road3072" else [("bfs", A, 0), ("sssp", A, 0)]
    return {name: out[name] for name in names}


def run_fn(kind, A, source, every_round_wide=False):
    """The kernel-6 call of one run, as a function of no arguments."""
    if every_round_wide:
        launch = K6._launch_bfs if kind == "bfs" else K6._launch_sssp
        return lambda: launch(A, source, 0)
    fn = K6.bfs_resident if kind == "bfs" else K6.sssp_resident
    return lambda: fn(A, source)


def time_run(kind, A, source, reps, every_round_wide=False):
    """One run's stats and its mean time over ``reps`` launches (CUDA events)."""
    fn = run_fn(kind, A, source, every_round_wide)
    for _ in range(2):
        _, stats = fn()
    rounds, capped, wide = stats.tolist()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    return {"kind": kind, "n": A.shape[0], "nnz": int(A.cols.shape[0]), "rounds": rounds,
            "capped": capped, "wide": wide, "ms": ms,
            "us_per_round": ms * 1e3 / rounds}


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--graphs", default=",".join(GRAPHS), help=f"comma-separated, of {GRAPHS}")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--every-round-wide", action="store_true")
    args = ap.parse_args(argv)
    names = args.graphs.split(",")
    unknown = set(names) - set(GRAPHS)
    if unknown:
        raise ValueError(f"unknown graphs {sorted(unknown)}; graphs: {GRAPHS}")
    device = device_of("cuda")
    smi = card()
    for name in names:
        for kind, A, source in build([name], device)[name]:
            row = time_run(kind, A, source, args.reps, args.every_round_wide)
            print(json.dumps({"graph": name, **row, "every_round_wide": args.every_round_wide,
                              "card": smi}), flush=True)


if __name__ == "__main__":
    main()
