"""Run one cell of BENCHMARK.json and print its result as the last line of stdout.

    python graphbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones, read from ``torch.profiler`` over the window.  Either way
the run compares sampled results of the window with the plain reference
and prints each compared number beside its limit, last on stderr and
under ``checked`` in the result.  It needs a CUDA device; only
``--rehearse-scale N`` runs it on the CPU, with the configuration cut to
scale N, and then reports no device metric.
"""

import time

T_START = time.perf_counter()  # set-up runs from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the checkout: graphbench and the program

from graphbench.core.spec import caches_in_checkout, find_cell  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "spla_tpu")  # top-level module names, compared whole


def forbidden_modules() -> list:
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse-scale", type=int, default=None,
                   help="run on the CPU, the configuration cut to this scale (no device metric)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    caches_in_checkout()
    cell = find_cell(args.workload)
    import torch

    if args.rehearse_scale is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
            return 2
    from graphbench.core.bench import execute

    result = execute(cell, args.seed, args.seconds, bool(args.trace), T_START, args.rehearse_scale)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: the benchmark measures spla_tpu_torch alone", file=sys.stderr)
        return 3
    for name, c in result["checked"].items():
        print(f"checked {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
