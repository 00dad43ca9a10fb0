"""BFS example (``examples/bfs.py``, the reference's ``examples/bfs.cpp``).

Loads a MatrixMarket graph, runs BFS on the accelerator and on the CPU for
``--niters`` laps, checks the depths against the sequential queue oracle,
and prints the lap times.
"""

from __future__ import annotations

import sys

import numpy as np

from .. import algorithms
from ..formats import csr_transpose_host
from ..timer import Timer
from .common import (backends, build_adjacency, env_info, load_graph, make_descriptor,
                     print_timers, run_laps, verify_exact)
from .options import make_options


def run(argv=None) -> int:
    args = make_options("bfs", "bfs (breadth first search) with spla_tpu_torch").parse_args(argv)
    devices = backends(args)
    total, t_ref = Timer(), Timer()
    total.start()
    loader = load_graph(args)
    print(f"env: {env_info()}")
    desc = make_descriptor(args)
    s = args.source

    def prepare(device):
        A = loader.to_csr(np.int32, device=device)
        At = csr_transpose_host(A)
        return lambda: algorithms.bfs(A, s, desc, At=At).values

    results, timers = run_laps(args, devices, prepare)
    ok = True
    if args.run_ref:
        adj = build_adjacency(loader)
        t_ref.lap_begin()
        ref = algorithms.bfs_naive(adj, s)
        t_ref.lap_end()
        for name, got in results.items():
            ok &= verify_exact(name, got, ref)
    total.stop()
    print_timers(total, **timers, ref=t_ref)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(run())
