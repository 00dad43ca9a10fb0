"""PageRank example (``examples/pr.py``, the reference's ``examples/pr.cpp``).

The matrix is prepared as the reference example prepares it: A[i,j] =
alpha / out_degree(i) for each edge (i, j) (``examples/pr.cpp:81-87``),
then ``p = A p + (1 - alpha) / N`` until the L2 change drops below eps.
The reference scales by the row's own out-degree, not the textbook
column's; the oracle uses the same rule, so the check compares like with
like.
"""

from __future__ import annotations

import sys

import numpy as np

from .. import algorithms
from ..formats import csr_from_entries
from ..timer import Timer
from .common import (backends, build_adjacency, env_info, load_graph, make_descriptor,
                     print_timers, run_laps, verify_close)
from .options import make_options


def run(argv=None) -> int:
    args = make_options("pr", "pr (page rank) with spla_tpu_torch").parse_args(argv)
    devices = backends(args)
    total, t_ref = Timer(), Timer()
    total.start()
    loader = load_graph(args)
    print(f"env: {env_info()}")
    n = loader.n_rows
    deg = np.bincount(loader.rows, minlength=n).astype(np.float32)
    vals = args.alpha / deg[loader.rows]
    desc = make_descriptor(args)

    def prepare(device):
        A = csr_from_entries((n, n), loader.rows, loader.cols, vals, dtype=np.float32,
                             device=device)
        return lambda: algorithms.pr(A, args.alpha, args.eps, desc).values

    results, timers = run_laps(args, devices, prepare)
    ok = True
    if args.run_ref:
        adj = build_adjacency(loader)
        w = [[float(args.alpha / deg[i])] * len(adj[i]) for i in range(n)]
        t_ref.lap_begin()
        ref = algorithms.pr_naive(adj, w, args.alpha, args.eps)
        t_ref.lap_end()
        for name, got in results.items():
            ok &= verify_close(name, got, ref, atol=1e-4)
    total.stop()
    print_timers(total, **timers, ref=t_ref)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(run())
