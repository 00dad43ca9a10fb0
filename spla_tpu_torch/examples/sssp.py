"""SSSP example (``examples/sssp.py``, the reference's ``examples/sssp.cpp``).

Min-plus relaxation over the edges, each of weight 1.0 as in the
reference example.  ``spla_tpu``'s CLI passes Aᵀ as both matrices, which
its pull kernels allow; here the push and resident routes walk A's rows,
so A goes in with its transpose.
"""

from __future__ import annotations

import sys

import numpy as np

from .. import algorithms
from ..formats import csr_transpose_host
from ..timer import Timer
from .common import (backends, build_adjacency, env_info, load_graph, make_descriptor,
                     print_timers, run_laps, verify_close)
from .options import make_options


def run(argv=None) -> int:
    args = make_options("sssp", "sssp (single source shortest paths) with spla_tpu_torch"
                        ).parse_args(argv)
    devices = backends(args)
    total, t_ref = Timer(), Timer()
    total.start()
    loader = load_graph(args)
    print(f"env: {env_info()}")
    # the reference sets weight 1.0 per edge (examples/sssp.cpp set_float(..., 1))
    loader.vals = np.ones_like(loader.vals)
    desc = make_descriptor(args)
    s = args.source

    def prepare(device):
        A = loader.to_csr(np.float32, fill=np.float32(np.inf), device=device)
        At = csr_transpose_host(A)
        return lambda: algorithms.sssp(A, s, desc, At=At).values

    results, timers = run_laps(args, devices, prepare)
    ok = True
    if args.run_ref:
        adj, w = build_adjacency(loader, weights=True)
        t_ref.lap_begin()
        ref = algorithms.sssp_naive(adj, w, s)
        t_ref.lap_end()
        for name, got in results.items():
            ok &= verify_close(name, got, ref)
    total.stop()
    print_timers(total, **timers, ref=t_ref)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(run())
