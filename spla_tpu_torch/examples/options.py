"""The example CLIs' flags (``examples/options.py``, the reference's
``examples/options.hpp:34-66``).  "acc" is the CUDA device ``--device``."""

from __future__ import annotations

import argparse


def _bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "on")


def make_options(name: str, desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=name, description=desc)
    p.add_argument("--mtxpath", type=str, required=True, help="path to matrix file")
    p.add_argument("--niters", type=int, default=4, help="number of iterations to run")
    p.add_argument("--source", type=int, default=0, help="source vertex to run")
    p.add_argument("--run-ref", type=_bool, default=True,
                   help="check validity running naive version")
    p.add_argument("--run-cpu", type=_bool, default=True,
                   help="run algo on the cpu (the kernels' plain versions)")
    p.add_argument("--run-acc", "--run-gpu", dest="run_acc", type=_bool, default=True,
                   help="run algo on the CUDA device --device; raises without one")
    p.add_argument("--platform", type=int, default=0, help="id of platform to run")
    p.add_argument("--device", type=int, default=0, help="id of device to run")
    p.add_argument("--undirected", type=_bool, default=False,
                   help="force graph to be undirected")
    p.add_argument("--verbose", type=_bool, default=True, help="verbose std output")
    p.add_argument("--debug-timing", type=_bool, default=False,
                   help="timing for each iteration of algorithm")
    p.add_argument("--push-pull", type=int, default=3,
                   help="traversal run mode (push-only 1, pull-only 2, push-pull 3)")
    p.add_argument("--front-factor", type=float, default=0.05,
                   help="adaptive push-pull front sparsity factor")
    p.add_argument("--alpha", type=float, default=0.85,
                   help="alpha parameter for page rank algorithm")
    p.add_argument("--eps", type=float, default=1e-6,
                   help="eps error for page rank algorithm")
    return p
