"""Shared harness of the example CLIs (counterpart of ``examples/common.py``).

The reference example flow (``examples/bfs.cpp:85-140``): load the mtx
file, build the matrix, run the algorithm on the accelerator and on the CPU
for ``--niters`` laps, run the sequential naive oracle, verify, print the
lap times.  The two backends are two devices: the same functions run on
CPU tensors (the kernels' plain versions) and on ``cuda:<--device>`` (the
kernels).  Accelerator laps are timed with CUDA events, CPU laps with the
host clock.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..descriptor import Descriptor
from ..io import MtxLoader
from ..library import get_library
from ..timer import Timer

__all__ = [
    "backends",
    "load_graph",
    "build_adjacency",
    "run_laps",
    "make_descriptor",
    "verify_exact",
    "verify_close",
    "print_timers",
    "env_info",
]


def backends(args) -> list:
    """``(name, device)`` of each backend the flags ask for.  ``--run-acc``
    without a CUDA device raises here, before any work: unlike
    ``examples/common.py:78-82``, the accelerator laps never run on the
    CPU."""
    out = [("cpu", torch.device("cpu"))] if args.run_cpu else []
    if args.run_acc:
        lib = get_library()
        lib.set_platform(args.platform)
        out.append(("acc", lib.accelerator(args.device)))
    return out


def load_graph(args) -> MtxLoader:
    loader = MtxLoader(verbose=args.verbose)
    loader.load(args.mtxpath, offset_indexes=True, make_undirected=args.undirected,
                remove_loops=True)
    # set semantics, as the reference examples' A->set_*(i, j, v) loop (the
    # last duplicate wins): the oracles' adjacency lists and the CSR agree
    key = loader.rows.astype(np.int64) * loader.n_cols + loader.cols
    _, last = np.unique(key[::-1], return_index=True)
    keep = np.sort(key.size - 1 - last)
    loader.rows, loader.cols, loader.vals = loader.rows[keep], loader.cols[keep], loader.vals[keep]
    return loader


def build_adjacency(loader: MtxLoader, weights: bool = False):
    """Per-row neighbour (and weight) lists for the naive oracles."""
    order = np.lexsort((loader.cols, loader.rows))
    rows, cols, vals = loader.rows[order], loader.cols[order], loader.vals[order]
    adj = [[] for _ in range(loader.n_rows)]
    w = [[] for _ in range(loader.n_rows)] if weights else None
    for k in range(rows.size):
        adj[rows[k]].append(int(cols[k]))
        if weights:
            w[rows[k]].append(float(vals[k]))
    return (adj, w) if weights else adj


def run_laps(args, devices, prepare):
    """Run the algorithm ``--niters`` times on each backend.  ``prepare(device)``
    builds the operands there and returns a function that runs the
    algorithm once and returns a tensor or a number.  Returns the last
    result of each backend (tensors as numpy) and the lap timers."""
    results, timers = {}, {"cpu": Timer(), "acc": Timer()}
    for name, device in devices:
        fn = prepare(device)
        timer = timers[name] = Timer(device)
        for _ in range(args.niters):
            timer.lap_begin()
            out = fn()
            out = out.cpu().numpy() if torch.is_tensor(out) else out
            timer.lap_end()
        results[name] = out
    return results, timers


def make_descriptor(args) -> Descriptor:
    return Descriptor(push_only=args.push_pull == 1, pull_only=args.push_pull == 2,
                      push_pull=args.push_pull == 3, front_factor=args.front_factor)


def verify_exact(name: str, got, ref) -> bool:
    got, ref = np.asarray(got), np.asarray(ref)
    ok = got.shape == ref.shape and bool(np.array_equal(got, ref))
    print(f"verify {name}: {'OK' if ok else 'FAILED'}")
    if not ok:
        if got.shape != ref.shape:
            print(f"  shape {got.shape} != {ref.shape}", file=sys.stderr)
        else:
            for i in np.nonzero(got != ref)[0][:10]:
                print(f"  [{i}] got={got[i]} ref={ref[i]}", file=sys.stderr)
    return ok


def verify_close(name: str, got, ref, atol=1e-5, rtol=1e-4) -> bool:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    ok = got.shape == ref.shape and bool(np.allclose(got, ref, atol=atol, rtol=rtol,
                                                     equal_nan=True))
    print(f"verify {name}: {'OK' if ok else 'FAILED'}")
    if not ok:
        if got.shape != ref.shape:
            print(f"  shape {got.shape} != {ref.shape}", file=sys.stderr)
        else:
            print(f"  max abs err {np.nanmax(np.abs(got - ref)):.3e}", file=sys.stderr)
    return ok


def print_timers(total: Timer, **named: Timer) -> None:
    print(f"total(ms): {total.get_elapsed_ms():.3f}")
    for name, t in named.items():
        print(f"{name}(ms): ", end="")
        t.print()
        print()


def env_info() -> str:
    return get_library().get_accelerator_info()
