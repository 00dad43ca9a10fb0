"""Kernel 1 under an x-validity mask at the benchmark's urand sizes, timed with CUDA events.

Uniform random graphs made on the device from ``--seed``, every row holding
``--degree`` columns drawn uniformly (32: GAP urand's stored degree) with
weights 1-255: n = 2^24 (``urand-sssp``'s scale) and 2^25 (``urand-bfs``'s).
On each, masks with 10%, 50% and 100% of x valid, and two calls:

* kernel 1's (PLUS, MIN) f32 pull with ``x_valid``, into a given ``out``
  (an SSSP pull level);
* its structural pull with ``x_valid``, every row selected;
* its structural pull with ``x_valid`` and the rows where x is not valid
  selected (a BFS pull level: the frontier is valid, the unvisited rows,
  none of them in it, selected).

A call is what the level loop pays for it: where the tree has
``kernels.spmv.pack_valid_bits``, the pack of the mask is part of it, and
the pack alone is timed too.  Each is launched ``--reps`` times after 3
warm-up launches, the list forward and then backward, and the two means
averaged.  ``--check`` first holds each call on the first scale's graph
once against its plain version (exact: MIN folds of whole numbers, and
hits; the plain versions' temporaries at 2^25 would near the card's
80 GB).  One line a measurement, then one JSON line with all of them.

The tool calls only entry points that trees older than the bitmap have too,
so to hold a change of kernel 1 against its parent, unpack the parent with
``git archive`` into a git-ignored directory, copy this file into its
``spla_tpu_torch/tools/``, and run both trees on one card in one command,
parent-change-change-parent (each builds its own kernels).  With
``--device cpu`` it runs the plain versions at a small ``--scales`` (a
rehearsal: no time is meaningful there).

Usage::

    python -m spla_tpu_torch.tools.mask_times [--scales 24,25] [--degree 32] [--reps 10] [--check]
        [--label NAME] [--seed N] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import op
from ..containers import CsrMatrix
from ..kernels import spmv as K1
from .ab_spmv import device_of

VALID_SHARES = (0.1, 0.5, 1.0)


def urand(scale: int, degree: int, seed: int, device) -> CsrMatrix:
    """n = 2^scale rows of ``degree`` uniform random columns each, f32
    weights uniform on 1-255, fill +inf."""
    n = 1 << scale
    nnz = n * degree
    g = torch.Generator(device=device).manual_seed(seed)
    cols = torch.randint(0, n, (nnz,), generator=g, device=device, dtype=torch.int32)
    values = torch.randint(1, 256, (nnz,), generator=g, device=device, dtype=torch.float32)
    rows = torch.arange(n, dtype=torch.int32, device=device).repeat_interleave(degree)
    indptr = torch.arange(n + 1, dtype=torch.int32, device=device) * degree
    return CsrMatrix(shape=(n, n), indptr=indptr, cols=cols, values=values, row_ids=rows,
                     nnz=torch.tensor(nnz, dtype=torch.int32, device=device),
                     fill=torch.tensor(float("inf"), device=device))


def calls(A: CsrMatrix, valid: torch.Tensor, x: torch.Tensor) -> dict:
    """The timed calls on one graph and mask, by name; ``pack`` where the
    tree has the bitmap."""
    out = torch.empty_like(x)
    hits = torch.empty(A.shape[0], dtype=torch.bool, device=x.device)
    unvisited = ~valid
    inf = float("inf")
    fns = {"PLUS/MIN": lambda: K1.spmv_pull(A, x, op.PLUS_FLOAT, op.MIN_FLOAT, inf, x_valid=valid, out=out)[0],
           "structural": lambda: K1.spmv_pull_structural(A, valid, out=hits),
           "structural unvisited": lambda: K1.spmv_pull_structural(A, valid, unvisited, out=hits)}
    if hasattr(K1, "pack_valid_bits"):
        bits = torch.empty((valid.shape[0] + 31) // 32, dtype=torch.int32, device=x.device)
        fns["pack"] = lambda: K1.pack_valid_bits(valid, out=bits)
    return fns


def check(A: CsrMatrix, valid: torch.Tensor, x: torch.Tensor, fns: dict) -> None:
    got = fns["PLUS/MIN"]()
    ref, _ = K1.spmv_pull_plain(A, x, op.PLUS_FLOAT, op.MIN_FLOAT, float("inf"), x_valid=valid)
    if not torch.equal(got, ref):
        raise AssertionError(f"PLUS/MIN: {int((got != ref).sum())} of {got.numel()} differ from the plain version")
    for name, rows in (("structural", None), ("structural unvisited", ~valid)):
        got, ref = fns[name](), K1.spmv_pull_structural_plain(A, valid, rows)
        if not torch.equal(got, ref):
            raise AssertionError(f"{name}: {int((got != ref).sum())} of {got.numel()} differ from the plain version")
    del got, ref


def timed(fn, reps: int, device) -> float:
    """Mean ms a call over ``reps`` launches after 3 (host clock on the CPU)."""
    for _ in range(3):
        fn()
    if device.type != "cuda":
        import time

        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card(device) -> str:
    if device.type != "cuda":
        return "cpu"
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def measure(scales, degree: int, reps: int, seed: int, device, do_check: bool, log=print) -> list:
    rows = []
    for i, scale in enumerate(scales):
        A = urand(scale, degree, seed + scale, device)
        n, nnz = A.shape[0], A.shape[0] * degree
        g = torch.Generator(device=device).manual_seed(seed + 100 + scale)
        x = torch.rand(n, generator=g, device=device) * 1000
        u = torch.rand(n, generator=g, device=device)
        for share in VALID_SHARES:
            valid = u < share
            fns = calls(A, valid, x)
            if do_check and i == 0:
                check(A, valid, x, fns)
            ms = dict.fromkeys(fns, 0.0)
            for order in (list(fns), list(fns)[::-1]):
                for name in order:
                    ms[name] += timed(fns[name], reps, device) / 2
            for name, t in ms.items():
                row = {"scale": scale, "degree": degree, "valid": share, "call": name, "ms": t,
                       "ps_per_entry": None if name == "pack" else t * 1e9 / nnz}
                rows.append(row)
                log(json.dumps(row))
            del fns, valid
        del A, x, u
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scales", default="24,25")
    ap.add_argument("--degree", type=int, default=32)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=2300)
    ap.add_argument("--check", action="store_true", help="hold each call on the first graph against its plain version")
    ap.add_argument("--label", default="", help="names the tree in the JSON line")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_of(args.device)
    rows = measure([int(s) for s in args.scales.split(",")], args.degree, args.reps, args.seed, device,
                   args.check, log=lambda line: print(f"{args.label}: {line}", flush=True))
    print(json.dumps({"label": args.label, "rows": rows, "card": card(device), "torch": torch.__version__}),
          flush=True)


if __name__ == "__main__":
    main()
