"""MatrixMarket convert and stats tool (``examples/convert.py``, the
reference's ``examples/convert.cpp``): load an .mtx graph with the chosen
preprocessing, print its degree statistics, and save the transformed graph.

    python -m spla_tpu_torch.examples.convert --in g.mtx --out h.mtx
"""

from __future__ import annotations

import argparse
import sys

from ..io import MtxLoader
from ..timer import Timer


def _bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "on")


def run(argv=None) -> int:
    p = argparse.ArgumentParser("convert", description="aux tool to convert .mtx graph in desired format")
    p.add_argument("--in", dest="inp", type=str, required=True, help="path to matrix file")
    p.add_argument("--out", type=str, default=None, help="path to save matrix file")
    p.add_argument("--offset-indices", type=_bool, default=False, help="offset indices to start from 0")
    p.add_argument("--make-undirected", type=_bool, default=True,
                   help="make graph undirected adding backward edges")
    p.add_argument("--remove-loops", type=_bool, default=True, help="remove self-loops")
    p.add_argument("--stats-only", type=_bool, default=False, help="collect only graphs stats")
    args = p.parse_args(argv)

    timer = Timer()
    timer.start()

    loader = MtxLoader(verbose=True)
    # as the reference tool: --offset-indices true applies the 1-based -> 0-based offset
    loader.load(args.inp, offset_indexes=args.offset_indices, make_undirected=args.make_undirected,
                remove_loops=args.remove_loops)

    if not args.stats_only:
        out = args.out or (args.inp + ".out.mtx")
        loader.save(out)
        print(f"saved to {out}")

    timer.stop()
    print(f"total(ms): {timer.get_elapsed_ms():.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(run())
