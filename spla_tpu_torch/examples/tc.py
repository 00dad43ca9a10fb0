"""Triangle counting example (``examples/tc.py``, the reference's ``examples/tc.cpp``).

B = (A x Aᵀ) masked by A under (MULT, PLUS) with the GTZERO select, then
summed: each triangle of a symmetric adjacency counts 6 times, as in the
reference.
"""

from __future__ import annotations

import sys

import numpy as np

from .. import algorithms
from ..timer import Timer
from .common import backends, build_adjacency, env_info, load_graph, print_timers, run_laps
from .options import make_options


def run(argv=None) -> int:
    args = make_options("tc", "tc (triangles counting) with spla_tpu_torch").parse_args(argv)
    devices = backends(args)
    total, t_ref = Timer(), Timer()
    total.start()
    loader = load_graph(args)
    print(f"env: {env_info()}")
    loader.vals = np.ones_like(loader.vals)

    def prepare(device):
        A = loader.to_csr(np.int32, device=device)
        return lambda: algorithms.tc(A)

    results, timers = run_laps(args, devices, prepare)
    ok = True
    if args.run_ref:
        adj = build_adjacency(loader)
        t_ref.lap_begin()
        ref = algorithms.tc_naive(adj)
        t_ref.lap_end()
        for name, got in results.items():
            good = got == ref
            ok &= good
            print(f"verify {name}: {'OK' if good else f'FAILED got={got} ref={ref}'}")
    print(f"n_triangles (x6): {results.get('acc', results.get('cpu'))}")
    total.stop()
    print_timers(total, **timers, ref=t_ref)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(run())
