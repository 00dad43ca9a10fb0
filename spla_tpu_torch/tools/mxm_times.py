"""Kernel 9 (``kernels.spgemm.mxm``, MULT/PLUS f32, C = A @ A) on the graphs
of ``chip_smoke.py``'s mxm slice, timed with CUDA events; one JSON line a
graph.

* ``mx13`` — ``random_graph(2**13, 16, seed=5)`` (``bench_suite.py:528``,
  the mxm_mprod_s graph), values uniform in [0.5, 1.5);
* ``mx20`` — ``random_graph(2**20, 16)`` (``bench_suite.py:24``), values
  uniform in [0.1, 2.0) (the SSSP weights of ``chip_smoke.py``);
* ``skewed`` — ``graphs.skewed_graph()`` (``bench_suite.py:441-448``):
  rows of up to 2.2 M products, in every bin;
* ``bins`` — ``graphs.spgemm_bins()``: A @ B with rows in each bin.

On each: the plan's bins, kernel 9's time a call (``--reps`` calls after
one, the host read of each call's layout included); with ``--chain``,
``mxm_mprod_s``'s time a call (``bench_suite.py:534-552``: the public
``ops.mxm`` chained six times through a device scalar, on the host's clock,
the median of three chains, as ``chip_smoke.py`` times it); and, with
``--profile``, one call under ``torch.profiler``: its wall, the device's
busy time (the union of its kernel, copy and memset intervals), the idle
share and the device time of each kernel by name (the symbolic, numeric
and compaction kernels of each bin); with ``--library``, cuSPARSE's time
(one ``torch.sparse.mm`` of two CSR tensors), or its failure.  With
``--cluster C,...`` it instead times the call and its numeric large and
medium kernels once for each number of CTAs in a large row's cluster
(``kernels.spgemm.CLUSTER``, restored after), checking that every setting
gives C's structure.  With ``--dense D,...`` it instead times,
on ``random_graph(n, D)`` for each n of ``--dense-n`` (default 11,585,
the largest n whose n x n operands ``ops.spgemm.MXM_DENSE_CAP`` of 2^27
elements admits; values uniform in [0.5, 1.5)), kernel 9 against
``mxm``'s dense route (``ops.spgemm._mxm_dense``: A and B densified with
zero fill, one full-f32 ``torch.matmul``, the capacity from a bf16
pattern product, the nonzeros compacted into CSR on the device) in turns,
C checked equal, and the route's four parts apart; each line names the
route ``ops.spgemm.mxm_dense_gate`` picks and how far it is from the
faster one (``gate_over_faster``).

Usage::

    python -m spla_tpu_torch.tools.mxm_times [--graphs mx13,mx20,skewed,bins] [--reps 5] [--label NAME]
        [--profile] [--library] [--chain] [--cluster 8,16,...]
        [--dense 128,256,512 [--dense-n 4096,8192,11585]]
"""

from __future__ import annotations

import argparse
import json
import math
import re
import time
from dataclasses import replace

import numpy as np
import torch

from .. import formats as F, op
from ..kernels import spgemm as K9
from ..ops import mxm, spgemm as TG
from .ab_spmv import device_of
from .graphs import random_graph, skewed_graph, spgemm_bins
from .resident_levels import card

GRAPHS = ("mx13", "mx20", "skewed", "bins")


def operands(name, device):
    """``(A, B)`` of a graph, f32, on ``device``."""
    if name == "bins":
        a, b = spgemm_bins()
        return F.csr_from_scipy(a, device=device), F.csr_from_scipy(b, device=device)
    if name == "skewed":
        a = skewed_graph()
    else:
        a = random_graph(1 << 13, 16, seed=5) if name == "mx13" else random_graph(1 << 20, 16)
        lo, hi, seed = (0.5, 1.5, 11) if name == "mx13" else (0.1, 2.0, 2)
        a.data = np.random.default_rng(seed).uniform(lo, hi, a.nnz).astype(np.float32)
    A = F.csr_from_scipy(a, device=device)
    return A, A


def cuda_ms(fn, reps, warmup=1):
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


def chained_ms(A, B, links=6, chains=3):
    """ms a call of ``links`` public ``ops.mxm`` calls chained through a
    device scalar (B's values scaled by it, the next scalar taken from the
    result), on the host's clock from a synchronize to one read at the end;
    the median of ``chains`` chains (``bench_suite.py:534-552``)."""
    mxm(A, B, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
    walls = []
    for _ in range(chains):
        s = torch.ones((), device=A.values.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(links):
            R = mxm(A, replace(B, values=B.values * s), op.MULT_FLOAT, op.PLUS_FLOAT, 0.0, check_init_sparsify=False)
            s = 1.0 + R.values[0] * 0 + (k + 1) * 1e-9
        float(s)
        walls.append((time.perf_counter() - t0) / links * 1e3)
    return sorted(walls)[len(walls) // 2]


def kernel_name(name):
    """A kernel's short name: ``numeric_small`` for a mangled instance."""
    found = re.search(r"(symbolic|numeric|compact)_[a-z]+", name)
    return found.group(0) if found else name[:60]


def profiled(fn):
    """One call of ``fn`` under torch.profiler (after one without): its
    wall, the device's busy time and idle share, and each kernel's (or
    copy's) device time by short name, as ``[calls, ms]``."""
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
        calls, us = items.get(kernel_name(name), (0, 0.0))
        items[kernel_name(name)] = (calls + 1, us + stop - start)
    return {"wall_ms": wall, "busy_ms": busy / 1e3, "idle_share": 1 - busy / 1e3 / wall,
            "kernels": {k: [c, us / 1e3] for k, (c, us) in sorted(items.items(), key=lambda kv: -kv[1][1])}}


def library_ms(A, B, reps):
    """cuSPARSE's time for A @ B (``torch.sparse.mm`` of two CSR tensors),
    or its failure as a string."""
    try:
        L = torch.sparse_csr_tensor(A.indptr, A.cols[:int(A.nnz)], A.values[:int(A.nnz)], size=A.shape)
        R = L if B is A else torch.sparse_csr_tensor(B.indptr, B.cols[:int(B.nnz)], B.values[:int(B.nnz)],
                                                     size=B.shape)
        return cuda_ms(lambda: torch.sparse.mm(L, R), reps)
    except RuntimeError as e:  # out of memory, or a refusal: the result
        return f"failed: {type(e).__name__}: {str(e).splitlines()[0][:200]}"
    finally:
        torch.cuda.empty_cache()


N_DENSE = 11585  # floor(sqrt(2^27)): the largest n x n operand within MXM_DENSE_CAP


def dense_operand(n, d, device):
    """``random_graph(n, d)``, values uniform in [0.5, 1.5) (seed d), on ``device``."""
    a = random_graph(n, d)
    a.data = np.random.default_rng(d).uniform(0.5, 1.5, a.nnz).astype(np.float32)
    return F.csr_from_scipy(a, device=device)


def dense_gate(A, products):
    """The route ``ops.mxm`` takes for MULT/PLUS f32, init 0, C = A @ A."""
    n = A.shape[0]
    take = TG.mxm_dense_gate(op.MULT_FLOAT, op.PLUS_FLOAT, (A.values.dtype,) * 2, 0.0, n, n, n, products,
                             lambda: F.stored_finite(A))
    return "dense" if take else "kernel9"


def dense_row(A, reps):
    """Kernel 9 against the dense route (``ops.spgemm._mxm_dense``) on C =
    A @ A, in turns (kernel, dense, dense, kernel), C checked equal; and the
    route's parts timed apart: densify (A twice), capacity (the pattern
    product and its one host read), the f32 matmul, compaction."""
    n = A.shape[0]
    kfn = lambda: K9.mxm(A, A, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)  # noqa: E731
    dfn = lambda: TG._mxm_dense(A, A)  # noqa: E731
    C, D = kfn(), dfn()
    if C.capacity != D.capacity or not all(torch.equal(getattr(C, f), getattr(D, f))
                                           for f in ("indptr", "cols", "row_ids", "nnz")):
        raise AssertionError(f"dense route n={n}: C's structure differs from kernel 9's")
    torch.testing.assert_close(D.values, C.values, rtol=1e-5, atol=1e-5)
    c_nnz, capacity = int(C.nnz), C.capacity
    del C, D
    k1, d1 = cuda_ms(kfn, reps), cuda_ms(dfn, reps)
    d2, k2 = cuda_ms(dfn, reps), cuda_ms(kfn, reps)
    Ad = TG._dense0(A, n, n)
    R = TG._dense_matmul(Ad, Ad)
    parts = {"dense_densify_ms": cuda_ms(lambda: (TG._dense0(A, n, n), TG._dense0(A, n, n)), reps),
             "dense_capacity_ms": cuda_ms(lambda: TG._reached(A, A), reps),
             "dense_matmul_ms": cuda_ms(lambda: TG._dense_matmul(Ad, Ad), reps),
             "dense_compact_ms": cuda_ms(lambda: TG._compact_dense(R, capacity), reps)}
    del Ad, R
    torch.cuda.empty_cache()
    return {"c_nnz": c_nnz, "kernel9_ms": (k1 + k2) / 2, "dense_ms": (d1 + d2) / 2, **parts}


def crossover(rows):
    """The products at which kernel 9 and the dense route take the same
    time, from one n's rows: log products interpolated linearly in log
    (kernel 9 ms / dense ms) between the two rows about the first change
    of winner; None when no pair of rows brackets it."""
    rows = sorted(rows, key=lambda r: r["products"])
    for lo, hi in zip(rows, rows[1:]):
        a, b = (math.log(r["kernel9_ms"] / r["dense_ms"]) for r in (lo, hi))
        if a <= 0 <= b and a < b:
            t = -a / (b - a)
            return math.exp((1 - t) * math.log(lo["products"]) + t * math.log(hi["products"]))
    return None


def fit_gate(points):
    """From ``[(n, crossover products)]`` on n x n operands: c = products /
    n^3 at each n, their geometric mean, and the least-squares (c, p0) of
    products = c n^3 + p0 in relative error (each point weighted by 1 /
    its products)."""
    per_n = {n: p / n ** 3 for n, p in points}
    out = {"points": [[n, p] for n, p in points], "c_per_n": per_n}
    if points:
        out["c_geomean"] = math.exp(sum(math.log(c) for c in per_n.values()) / len(per_n))
    if len(points) >= 2:
        x = np.array([[n ** 3 / p, 1 / p] for n, p in points])
        (c, p0), *_ = np.linalg.lstsq(x, np.ones(len(points)), rcond=None)
        out["c_with_p0"], out["p0"] = float(c), float(p0)
    return out


def dense_sweep(ns, degrees, reps, label, smi):
    """Kernel 9 against the dense route on random_graph(n, d) for each n and
    d; one JSON line each, with the route the gate picks; then one line of
    the crossover at each n and the gate's fit (``fit_gate``)."""
    device = device_of("cuda")
    points = []
    for n in ns:
        rows = []
        for d in degrees:
            A = dense_operand(n, d, device)
            products = K9.mxm_plan(A, A).products
            row = dense_row(A, reps)
            gate = dense_gate(A, products)
            faster = "dense" if row["dense_ms"] < row["kernel9_ms"] else "kernel9"
            picked = row["dense_ms" if gate == "dense" else "kernel9_ms"]
            rows.append({"label": label, "graph": f"random_graph({n}, {d})", "n": n, "d": d, "nnz": int(A.nnz),
                         "products": products, "products_per_mkn": products / n ** 3, **row,
                         "kernel9_mproducts_s": products / row["kernel9_ms"] / 1e3, "gate": gate, "faster": faster,
                         "gate_over_faster": picked / min(row["dense_ms"], row["kernel9_ms"]), "card": smi})
            print(json.dumps(rows[-1]), flush=True)
            del A
            torch.cuda.empty_cache()
        at = crossover(rows)
        if at is not None:
            points.append((n, at))
    print(json.dumps({"label": label, "fit": fit_gate(points), "per_mkn_now": TG.MXM_DENSE_PER_MKN,
                      "card": smi}), flush=True)


def cluster_settings(text):
    """``[cluster, ...]`` from ``"8,16"``: clusters of 1 to 16 CTAs, a power of two."""
    settings = []
    for item in text.split(","):
        if item.strip() not in ("1", "2", "4", "8", "16"):
            raise ValueError(f"--cluster {item}: clusters of 1, 2, 4, 8 or 16 CTAs")
        settings.append(int(item))
    return settings


def cluster_sweep(name, A, B, settings, reps, smi):
    """The call and its numeric large and medium kernels at each cluster
    size; one JSON line each."""
    saved = K9.CLUSTER
    sms = torch.cuda.get_device_properties(A.values.device).multi_processor_count
    ref = None
    try:
        for cluster in settings:
            K9.CLUSTER = cluster
            fn = lambda: K9.mxm(A, B, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)  # noqa: E731
            ms = cuda_ms(fn, reps)
            kernels = profiled(fn)["kernels"]
            C = fn()
            ref = C if ref is None else ref
            same = all(torch.equal(getattr(C, f), getattr(ref, f)) for f in ("indptr", "cols", "row_ids", "nnz"))
            if not same:
                raise AssertionError(f"{name}: C's structure changed at clusters of {cluster}")
            print(json.dumps({"graph": name, "cluster": cluster,
                              "shape": K9.cluster_shape(B.shape[1], sms, K9.LARGE_SHARED_BYTES), "ms": ms,
                              "numeric_large_ms": kernels.get("numeric_large", [0, 0.0])[1],
                              "numeric_medium_ms": kernels.get("numeric_medium", [0, 0.0])[1], "card": smi}),
                  flush=True)
    finally:
        K9.CLUSTER = saved


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--graphs", default=",".join(GRAPHS), help=f"comma-separated, of {GRAPHS}")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--label", default="", help="names the tree in the JSON line")
    ap.add_argument("--profile", action="store_true", help="one profiled call a graph")
    ap.add_argument("--library", action="store_true", help="time cuSPARSE too")
    ap.add_argument("--chain", action="store_true", help="time mxm_mprod_s's chain of public mxm calls too")
    ap.add_argument("--cluster", default="", help="CTAs of a large row's cluster, comma-separated, to time in turn")
    ap.add_argument("--dense", default="", help="degrees d, comma-separated: kernel 9 against the dense route "
                                                "on random_graph(n, d)")
    ap.add_argument("--dense-n", default=str(N_DENSE), help="the n of --dense, comma-separated")
    args = ap.parse_args(argv)
    if args.dense:
        dense_sweep([int(n) for n in args.dense_n.split(",")], [int(d) for d in args.dense.split(",")],
                    args.reps, args.label, card())
        return
    names = args.graphs.split(",")
    unknown = set(names) - set(GRAPHS)
    if unknown:
        raise ValueError(f"unknown graphs {sorted(unknown)}; graphs: {GRAPHS}")
    settings = cluster_settings(args.cluster) if args.cluster else None
    device = device_of("cuda")
    smi = card()
    for name in names:
        A, B = operands(name, device)
        if settings:
            cluster_sweep(name, A, B, settings, args.reps, smi)
            continue
        plan = K9.mxm_plan(A, B)
        fn = lambda: K9.mxm(A, B, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)  # noqa: E731
        ms = cuda_ms(fn, args.reps)
        row = {"label": args.label, "graph": name, "n": A.shape[0], "nnz": int(A.nnz), "products": plan.products,
               "c_nnz": int(fn().nnz), "ms": ms, "mproducts_s": plan.products / ms / 1e3,
               "bins": [plan.nsmall, plan.nmedium, plan.nlarge], "card": smi}
        if args.chain:
            row["chain_ms"] = chained_ms(A, B)
            row["chain_mproducts_s"] = plan.products / row["chain_ms"] / 1e3
        if args.profile:
            row["profiled"] = profiled(fn)
        if args.library:
            row["library_ms"] = library_ms(A, B, max(2, args.reps // 2))
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
