"""The readings that a cell's limits are set from: the program's and the controls'.

    python graphbench/control.py --workload <cell> --seeds 1,2,3 [--queries K]

For each seed, in one process: the cell's graph, the program's first K
queries of the seed's sources (K defaults to the mix's check sample),
their results compared with the plain reference, and then each control of
the kind (``CONTROLS`` in ``graphbench/reference/<kind>.py``) put in the
program's place on the same sources and compared the same way.  One JSON
line a seed (with the kind's own ``readings`` where its reference has
them), then a summary: the worst program reading over the seeds (the lower
reading) and, for each control, its smallest worst reading (the upper
one).  The benchmark's runs do not run it.  ``--rehearse-scale N`` runs it
on the CPU at scale N.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from graphbench.core.spec import caches_in_checkout, find_cell  # noqa: E402


def readings(cell, seed: int, queries: int, rehearse_scale, log) -> dict:
    import torch

    from graphbench.core import bench
    from graphbench.core import graph as G
    from graphbench.core.spec import load_module

    device = torch.device("cpu") if rehearse_scale is not None else torch.device("cuda", 0)
    sync = bench.sync_of(device)
    mix = cell.mix
    kind, ref_mod = load_module("queries", mix["query"]), load_module("reference", mix["query"])
    graph = G.build(cell.config, G.graph_seed(cell.config, seed), device, rehearse_scale)
    sources, hub = (G.window_sources(graph, cell.config, mix, seed, queries) if kind.SOURCES
                    else ([None] * queries, None))
    state = kind.prepare(graph, mix)
    kind.warm(state, hub, mix)
    sample = []
    for i, s in enumerate(sources):
        sample.append((i, s, kind.run(state, s, mix)))
        sync()
    del state
    bench.free(device)
    limits = mix["check"]["limits"]
    program, _ = bench.judge(ref_mod, graph, sample, mix, limits, log)
    controls = {}
    for name, fn in ref_mod.CONTROLS.items():
        t0 = time.perf_counter()
        ctl = [(i, s, fn(graph, s, mix)) for i, s, _ in sample]
        controls[name], _ = bench.judge(ref_mod, graph, ctl, mix, limits, log)
        controls[name]["seconds"] = time.perf_counter() - t0
    row = {"seed": seed, "n": graph.n, "nnz": graph.nnz, "program": program, "controls": controls}
    if hasattr(ref_mod, "readings"):  # what the kind's mix parameters were chosen from
        row["readings"] = ref_mod.readings(graph, mix)
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--queries", type=int, default=None)
    p.add_argument("--rehearse-scale", type=int, default=None)
    args = p.parse_args(argv)
    caches_in_checkout()
    from graphbench.core import port

    cell = find_cell(args.workload)
    if args.rehearse_scale is None:
        port.build_kernels()
    queries = args.queries or int(cell.mix["check"]["sample"])
    log = lambda line: print(line, file=sys.stderr, flush=True)  # noqa: E731
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = readings(cell, seed, queries, args.rehearse_scale, log)
        rows.append(row)
        print(json.dumps(row), flush=True)
    lower = {k: max(r["program"][k] for r in rows) for k in cell.mix["check"]["limits"]}
    upper = {name: {k: min(r["controls"][name][k] for r in rows) for k in cell.mix["check"]["limits"]}
             for name in rows[0]["controls"]}
    print(json.dumps({"workload": cell.name, "seeds": len(rows), "lower": lower, "control_upper": upper,
                      "limits": cell.mix["check"]["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
