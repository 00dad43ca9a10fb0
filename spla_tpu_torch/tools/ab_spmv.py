"""A/B timing of the pull SpMV variants, one variant a run, one JSON line.

Counterpart of ``tools/ab_spmv.py``.  Variants:

* ``--manual 0 --variant warp`` — kernel 1 (a warp per row);
* ``--manual N`` (N in 2, 3, 4) — kernel 7 with a ring of N stages;
* ``--variant split2|split4`` — kernel 1 over ``formats.split_rows`` parts,
  each launched on its own CUDA stream into its slice of the output: do
  two launches overlap their streams?

Timing follows the reference tool: ``--iters`` chained SpMVs, each output
scaled by ``(1 + k * 1e-6) / max|output|`` and fed to the next, best of two
runs, timed with CUDA events.  ``ms`` is one chained step; ``gbps_model``
charges it the reference's bytes (12 a stored entry, 8 a row,
``tools/ab_spmv.py:201``).  ``--check`` compares the variant's SpMV and the
op layer's (``ops.best_spmv_fn``, which ``SPLA_MANUAL_DMA=1`` routes to
kernel 7 with ``SPLA_MANUAL_SLOTS`` slots) with scipy.  The JSON line also
holds the environment switch as this process read it and the launch counts.

Not carried over: the TPU tile-format variants (``pair``, ``oct``, ``wide``,
``flat``, ``two``, ``bf16``, ``bf16w``) and ``--cw``, ``--reorder``,
``--split``, ``--split-thresh``: they choose packings of the TPU's cell
format, which the port does not have (ROADMAP, "Not carried over").

Usage::

    python -m spla_tpu_torch.tools.ab_spmv --manual 3 --check
    python -m spla_tpu_torch.tools.ab_spmv --device cpu --n 4096   # plain versions
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import scipy.sparse as sp
import torch

from .. import kernels, op
from ..formats import split_rows
from ..interop import csr_from_numpy
from ..kernels import spmv as K1
from ..kernels import staged as K7
from ..ops import best_spmv_fn
from .graphs import build_graph, powerlaw_graph

VARIANTS = ("warp", "split2", "split4")


def device_of(name: str) -> torch.device:
    """The run's device; a CUDA run without a CUDA device raises."""
    if name != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device (use --device cpu for the plain versions)")
    return torch.device(name)


def graph(kind: str, n: int, deg: int):
    return powerlaw_graph(n, deg) if kind == "powerlaw" else build_graph(n, deg)


def timed_ms(step, x, iters: int, device) -> float:
    """Best of two runs of ``iters`` chained steps, per step."""
    best = float("inf")
    for _ in range(2):
        y = x
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for k in range(iters):
                y = step(y, k)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for k in range(iters):
                y = step(y, k)
            ms = (time.perf_counter() - t0) * 1e3
        if not float(torch.sum(torch.abs(y))) > 0:
            raise AssertionError("the chained SpMV decayed to zero")
        best = min(best, ms / iters)
    return best


def split_spmv(A, parts: int, device):
    """Kernel 1 over ``split_rows(A, parts)``, each part on its own stream
    (CUDA) writing its rows' slice of one output."""
    pieces = split_rows(A, parts)
    bounds = np.cumsum([0] + [p.shape[0] for p in pieces]).tolist()
    streams = [torch.cuda.Stream(device) for _ in pieces] if device.type == "cuda" else None

    def spmv(x):
        out = torch.empty(A.shape[0], dtype=x.dtype, device=x.device)
        jobs = list(zip(pieces, bounds[:-1], bounds[1:]))
        if streams is None:
            for part, r0, r1 in jobs:
                K1.spmv_pull(part, x, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0, out=out[r0:r1])
            return out
        main = torch.cuda.current_stream(device)
        for s, (part, r0, r1) in zip(streams, jobs):
            s.wait_stream(main)
            with torch.cuda.stream(s):
                K1.spmv_pull(part, x, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0, out=out[r0:r1])
        for s in streams:
            main.wait_stream(s)
        return out

    return spmv, [p.shape[0] for p in pieces]


def variant_spmv(A, manual: int, variant: str, device):
    """``(spmv, info)``: the variant's MULT/PLUS SpMV ``x -> A x`` and what
    the JSON line reports of it."""
    if variant not in VARIANTS:
        raise ValueError(f"--variant {variant}: the port's variants are {VARIANTS}")
    if manual and variant != "warp":
        raise ValueError("--manual takes the warp variant only")
    if variant != "warp":
        spmv, parts = split_spmv(A, int(variant[-1]), device)
        return spmv, {"split_rows": parts}
    if manual:
        slots = K7.resolve_slots(manual)
        return (lambda y: K7.spmv_pull_staged(A, y, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0,
                                              slots=slots)[0]), {}
    return (lambda y: K1.spmv_pull(A, y, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)[0]), {}


def chained(spmv):
    """The reference tool's chained step: the output scaled to max 1 (times
    ``1 + k * 1e-6``) feeds the next SpMV."""
    def step(y, k):
        o = spmv(y)
        return o * ((1.0 + k * 1e-6) / (torch.max(torch.abs(o)) + 1e-30))

    return step


def run(n=1 << 21, deg=16, iters=100, graph_kind="uniform", manual=0, variant="warp", check=False,
        device="cuda"):
    """One variant's result as a dict (the JSON line)."""
    dev = device_of(device)
    indptr, rows, cols, vals = graph(graph_kind, n, deg)
    nnz = int(vals.size)
    A = csr_from_numpy((n, n), indptr, cols, vals, rows, nnz, np.float32(0), dev)
    x = torch.from_numpy(np.random.default_rng(1).random(n, dtype=np.float32)).to(dev)
    spmv, info = variant_spmv(A, manual, variant, dev)
    kernels.reset_launches()
    checked = {}
    if check:
        ref = sp.csr_matrix((vals.astype(np.float64), cols, indptr), shape=(n, n)) @ \
            x.cpu().numpy().astype(np.float64)
        routed = best_spmv_fn(A, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
        for name, got in (("variant", spmv(x)), ("op_layer", routed(A, x))):
            err = float(np.abs(got.cpu().numpy() - ref).max())
            if not np.allclose(got.cpu().numpy(), ref, rtol=1e-4, atol=1e-5):
                raise AssertionError(f"{name}: max abs err {err} against scipy")
            checked[name] = err
    ms = timed_ms(chained(spmv), x, iters, dev)
    bytes_model = nnz * 12 + n * 8 + 4
    return {"variant": variant, "manual": manual, "graph": graph_kind, "n": n, "nnz": nnz,
            "ms": ms, "gbps_model": bytes_model / ms / 1e6, "checked": checked,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "manual_dma": K7.MANUAL_DMA, "manual_slots": K7.MANUAL_DMA_SLOTS,
            "launches": {k: kernels.LAUNCHES[k] for k in ("spmv_pull", "spmv_pull_staged")}, **info}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=1 << 21)
    ap.add_argument("--deg", type=int, default=16)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--graph", default="uniform", choices=["uniform", "powerlaw"],
                    help="powerlaw: zipf(2.1) out-degrees (tools/ab_spmv.py:65-72)")
    ap.add_argument("--manual", type=int, default=0, help="kernel 7's slot count; 0 = kernel 1")
    ap.add_argument("--variant", default="warp", choices=VARIANTS)
    ap.add_argument("--check", action="store_true", help="compare with scipy first")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.n, args.deg, args.iters, args.graph, args.manual, args.variant,
                         args.check, args.device)))


if __name__ == "__main__":
    main()
