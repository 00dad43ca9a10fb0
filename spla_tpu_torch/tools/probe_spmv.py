"""Phase probes of the pull SpMV in ns per stored entry, one JSON line.

Counterpart of ``tools/probe_spmv.py``: kernel 8's phases
(``kernels/probe.py``) beside the real kernels on the same graph
(``bench.py``'s ``build_graph(n, deg, seed=0)``), so that differences of
their times attribute kernel 1's time to its phases:

* ``stream`` — the bytes alone (TPU ``k_stream``, ``k_stream2``,
  ``streamnp``, ``ep_stream``); ``gather`` — + x and the products
  (``k_gather``); ``fullfix`` — + the per-row fold (``k_fullfix``);
  ``warp_row`` — + the per-row stores: kernel 1 as first built, a warp
  per row, on whose grid the phases above run (``k_full``); ``full`` —
  kernel 1 itself (``k_full`` and its layouts);
* ``alu`` — the compute chain with no stream (``k_dummy_alu``,
  ``compnp``); ``xgather`` — x gathers with no stream (``k_dummy_vmem``);
* ``flat_stream``, ``flat_gather`` — the column and value streams with no
  rows, in 16-byte loads, without and with their x gathers: the floors of
  the stream and of the gathers (``streamnp``, ``k_gather``);
* ``ring_copy``, ``ring_alu``, ``ring_copy_alu`` — kernel 7's ring copying
  only, computing only, and both (``manual_dma_alu``, ``manual_alu``);
  ``ring_fold`` — kernel 7's fold on slots that stay resident, no copies
  (``manual_real``); ``staged2``/``3``/``4`` — kernel 7 at 2, 3, 4 slots
  (``manual_dma_real``);
* ``torch_sum`` — ``torch.sum`` over the values and the columns: a library
  reference for the stream's bytes (TPU ``xla_sum``), not a port.

Each probe is launched ``--iters`` times after two warm-up launches and
timed with CUDA events (on the CPU, with the host clock, over the plain
versions).

Usage::

    python -m spla_tpu_torch.tools.probe_spmv [--probe all|stream|...]
    python -m spla_tpu_torch.tools.probe_spmv --device cpu --n 4096
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import op
from ..interop import csr_from_numpy
from ..kernels import PROBE_PHASES
from ..kernels import probe as K8
from ..kernels import spmv as K1
from ..kernels import staged as K7
from .ab_spmv import device_of
from .graphs import build_graph

KERNELS = ("full", "staged2", "staged3", "staged4")
LIBRARY = ("torch_sum",)
PROBES = PROBE_PHASES + KERNELS + LIBRARY


def probe_fns(A, x):
    """Each probe as a function of no arguments."""
    fns = {phase: (lambda phase=phase: K8.spmv_probe(phase, A, x)) for phase in PROBE_PHASES}
    fns["full"] = lambda: K1.spmv_pull(A, x, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
    for slots in (2, 3, 4):
        fns[f"staged{slots}"] = (lambda slots=slots: K7.spmv_pull_staged(
            A, x, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0, slots=slots))
    cols_bits = A.cols.view(torch.float32)  # the same bytes, summed as f32
    fns["torch_sum"] = lambda: (torch.sum(A.values), torch.sum(cols_bits))
    return fns


def time_ms(fn, iters: int, device) -> float:
    for _ in range(2):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def run(n=1 << 21, deg=16, iters=50, probes=PROBES, device="cuda"):
    """``{"ns_per_entry": {probe: ns}, "ms": {probe: ms}, ...}`` of one run."""
    dev = device_of(device)
    unknown = set(probes) - set(PROBES)
    if unknown:
        raise ValueError(f"unknown probes {sorted(unknown)}; probes: {PROBES}")
    indptr, rows, cols, vals = build_graph(n, deg)
    nnz = int(vals.size)
    A = csr_from_numpy((n, n), indptr, cols, vals, rows, nnz, np.float32(0), dev)
    x = torch.from_numpy(np.random.default_rng(1).random(n, dtype=np.float32)).to(dev)
    fns = probe_fns(A, x)
    ms = {name: time_ms(fns[name], iters, dev) for name in probes}
    return {"n": n, "deg": deg, "nnz": nnz, "iters": iters,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "ns_per_entry": {name: t * 1e6 / nnz for name, t in ms.items()}, "ms": ms,
            "library": [name for name in probes if name in LIBRARY]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=1 << 21)
    ap.add_argument("--deg", type=int, default=16)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--probe", default="all", choices=("all",) + PROBES)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    probes = PROBES if args.probe == "all" else (args.probe,)
    print(json.dumps(run(args.n, args.deg, args.iters, probes, args.device)))


if __name__ == "__main__":
    main()
