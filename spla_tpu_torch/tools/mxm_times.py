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
gives C's structure.  With ``--dense D,...`` it instead times, on
``random_graph(11585, D)`` (values uniform in [0.5, 1.5); 11,585 is the
largest n whose dense operands spla_tpu's ``MXM_DENSE_CAP`` of 2^27
elements admits), kernel 9 against the dense route of spla_tpu's
``_mxm_dense`` (``spla_tpu/ops/spgemm.py:441-495``), which the port does
not have: A and B densified with zero fill, one f32 ``torch.matmul`` with
TF32 off, the nonzeros compacted into CSR; both in turns, C checked equal.

Usage::

    python -m spla_tpu_torch.tools.mxm_times [--graphs mx13,mx20,skewed,bins] [--reps 5] [--label NAME]
        [--profile] [--library] [--chain] [--cluster 8,16,...] [--dense 128,256,512]
"""

from __future__ import annotations

import argparse
import json
import re
import time
from dataclasses import replace

import numpy as np
import torch

from .. import formats as F, op
from ..kernels import spgemm as K9
from ..ops import mxm
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


N_DENSE = 11585  # floor(sqrt(2^27)): spla_tpu's MXM_DENSE_CAP on an n x n operand


def dense_operand(d, device):
    a = random_graph(N_DENSE, d)
    a.data = np.random.default_rng(d).uniform(0.5, 1.5, a.nnz).astype(np.float32)
    return F.csr_from_scipy(a, device=device)


def densify(M):
    """M as a dense f32 matrix, absent entries 0 (duplicates added)."""
    k = int(M.nnz)
    out = torch.zeros(M.shape, dtype=torch.float32, device=M.values.device)
    return out.index_put_((M.row_ids[:k].long(), M.cols[:k].long()), M.values[:k], accumulate=True)


def dense_mxm(A, B):
    """C = A @ B by the dense route (MULT/PLUS f32, init 0): densify, one
    full-f32 matmul, the nonzeros compacted in row order into
    ``(indptr, cols, values)``.  Returns them and three CUDA events: before
    the densify, before the matmul and after it."""
    m, n = A.shape[0], B.shape[1]
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    events[0].record()
    Ad, Bd = densify(A), densify(B)
    events[1].record()
    R = torch.matmul(Ad, Bd)
    events[2].record()
    keep = R != 0
    indptr = torch.zeros(m + 1, dtype=torch.long, device=R.device)
    torch.cumsum(keep.sum(1), 0, out=indptr[1:])
    pos = torch.nonzero(keep.reshape(-1)).squeeze(1)
    return (indptr, (pos % n).to(torch.int32), R.reshape(-1)[pos]), events


def dense_sweep(degrees, reps, label, smi):
    """Kernel 9 against the dense route on random_graph(11585, d) for each
    d, in turns (kernel, dense, dense, kernel); one JSON line each."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32, as precision=HIGHEST
    try:
        for d in degrees:
            A = dense_operand(d, device_of("cuda"))
            plan = K9.mxm_plan(A, A)
            kfn = lambda: K9.mxm(A, A, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)  # noqa: E731
            dfn = lambda: dense_mxm(A, A)  # noqa: E731
            C = kfn()
            (indptr, cols, vals), events = dfn()
            k = int(C.nnz)
            if not (torch.equal(indptr.to(torch.int32), C.indptr) and torch.equal(cols, C.cols[:k])):
                raise AssertionError(f"dense route d={d}: C's structure differs from kernel 9's")
            torch.testing.assert_close(vals, C.values[:k], rtol=1e-5, atol=1e-5)
            k1, d1 = cuda_ms(kfn, reps), cuda_ms(dfn, reps)
            d2, k2 = cuda_ms(dfn, reps), cuda_ms(kfn, reps)
            parts = []
            for _ in range(reps):
                _, ev = dfn()
                ev[2].synchronize()
                parts.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
            densify_ms, matmul_ms = sorted(parts, key=lambda p: p[1])[len(parts) // 2]
            print(json.dumps({"label": label, "graph": f"random_graph({N_DENSE}, {d})", "n": N_DENSE,
                              "nnz": int(A.nnz), "products": plan.products, "c_nnz": k,
                              "kernel9_ms": (k1 + k2) / 2, "dense_ms": (d1 + d2) / 2,
                              "dense_densify_ms": densify_ms, "dense_matmul_ms": matmul_ms,
                              "kernel9_mproducts_s": plan.products / ((k1 + k2) / 2) / 1e3, "card": smi}),
                  flush=True)
            del A, C, indptr, cols, vals
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


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
                                                "on random_graph(11585, d)")
    args = ap.parse_args(argv)
    if args.dense:
        dense_sweep([int(d) for d in args.dense.split(",")], args.reps, args.label, card())
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
