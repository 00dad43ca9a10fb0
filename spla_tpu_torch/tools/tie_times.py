"""The f32 MIN folds of kernels 1, 5, 7 and 9, timed with CUDA events; one JSON line.

These are the folds whose ``op_min`` (``csrc/semiring.cuh``) decides a tie of
+0.0 and -0.0; the line holds their times on the main path's graphs:

* kernel 1 PLUS/MIN at n = 2^21 (``build_graph(2**21, 16)``, x uniform in
  [0, 1)), its templated instance and its generic family (``generic=True``);
* kernel 7 PLUS/MIN there at 2 slots;
* kernel 5 MULT/MIN on ``random_graph(2**20, 16)`` (mask = A = B, values
  uniform in [0.5, 1.5));
* kernel 9 MULT/MIN (``kernels.spgemm.mxm``: C = A @ A, each call with its
  read of C's size on the host) on the ``mxm_mprod_s`` graph
  ``random_graph(2**13, 16, seed=5)`` and on the n = 2^20 graph.

Each is launched ``--reps`` times after 3 warm-up launches (kernel 9
``--reps`` / 4 times), all of them forward and then backward, and the two
means averaged.  The tool calls only entry points that trees older than
the sign rule have too, so to hold a change of a fold against its parent,
unpack the parent with ``git archive`` into a git-ignored directory, copy
this file into its ``spla_tpu_torch/tools/``, and run both trees on one card
in one command, parent-change-change-parent (each builds its own kernels).

Usage::

    python -m spla_tpu_torch.tools.tie_times [--reps 20] [--label NAME]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import formats as F, op
from ..interop import csr_from_numpy
from ..kernels import mxmt as K45, spgemm as K9, spmv as K1, staged as K7
from .ab_spmv import device_of
from .graphs import build_graph, random_graph
from .mxmt_times import cuda_ms
from .resident_levels import card


def operands(device):
    """The graphs: the SpMV's (A, x), the n = 2^20 graph with values in
    [0.5, 1.5) and the n = 2^13 one, on ``device``."""
    n = 1 << 21
    indptr, rows, cols, vals = build_graph(n, 16)
    A = csr_from_numpy((n, n), indptr, cols, vals, rows, rows.size, np.float32(np.inf), device)
    x = torch.from_numpy(np.random.default_rng(1).random(n, dtype=np.float32)).to(device)
    out = {"spmv": (A, x)}
    for name, a in (("n=2^20", random_graph(1 << 20, 16)), ("n=2^13", random_graph(1 << 13, 16, seed=5))):
        a.data = np.random.default_rng(11).uniform(0.5, 1.5, a.nnz).astype(np.float32)
        out[name] = F.csr_from_scipy(a, device=device)
    return out


def functions(g):
    """The timed calls, by name."""
    (A, x), W, S = g["spmv"], g["n=2^20"], g["n=2^13"]
    inf = float("inf")
    return {"k1 PLUS/MIN n=2^21": lambda: K1.spmv_pull(A, x, op.PLUS_FLOAT, op.MIN_FLOAT, inf),
            "k1 generic PLUS/MIN n=2^21": lambda: K1.spmv_pull(A, x, op.PLUS_FLOAT, op.MIN_FLOAT, inf, generic=True),
            "k7 PLUS/MIN n=2^21 slots=2": lambda: K7.spmv_pull_staged(A, x, op.PLUS_FLOAT, op.MIN_FLOAT, inf,
                                                                       slots=2),
            "k5 MULT/MIN n=2^20": lambda: K45.mxmt_masked(W, W, W, op.MULT_FLOAT, op.MIN_FLOAT, inf),
            "k9 MULT/MIN n=2^13": lambda: K9.mxm(S, S, op.MULT_FLOAT, op.MIN_FLOAT, inf),
            "k9 MULT/MIN n=2^20": lambda: K9.mxm(W, W, op.MULT_FLOAT, op.MIN_FLOAT, inf)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--label", default="", help="names the tree in the JSON line")
    args = ap.parse_args(argv)
    device = device_of("cuda")
    fns = functions(operands(device))
    ms = dict.fromkeys(fns, 0.0)
    for order in (list(fns), list(fns)[::-1]):
        for name in order:
            reps = max(args.reps // 4, 1) if name.startswith("k9") else args.reps
            ms[name] += cuda_ms(fns[name], reps) / 2
    print(json.dumps({"label": args.label, "ms": ms, "card": card(), "torch": torch.__version__}), flush=True)


if __name__ == "__main__":
    main()
