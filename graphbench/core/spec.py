"""A run's cell, found by name: its entry in ``BENCHMARK.json``, its
configuration, its traffic mix, and the modules of its generator, its query
kind and its metrics.

Nothing here knows a cell, a configuration, a mix or a metric by name.  Each
lives in a file of its own, found from the name that ``BENCHMARK.json`` gives:

* ``configs[i]["file"]``: the configuration (JSON);
* ``graphbench/generators/<config["generator"]>.py``: its edges;
* ``graphbench/traffic/<cell["traffic"]>.json``: the mix, whose ``"query"``
  names the kind;
* ``graphbench/queries/<kind>.py``: the call into the program;
* ``graphbench/reference/<kind>.py``: the plain reference, its controls and
  the comparison;
* ``graphbench/metrics/<metric name>.py``: one reader a metric.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]  # the checkout: BENCHMARK.json, graphbench/, the program


def caches_in_checkout() -> None:
    """Every kernel cache under the checkout's ``build/``, at fixed paths (the
    program's own nvcc build already goes to ``build/spla_tpu_torch``).  Set
    before torch is imported."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: tuple  # the BENCHMARK.json entries that this cell reports with --trace 0
    per_layer: tuple  # and with --trace 1


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; raises KeyError if there is none."""
    bench = load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(ROOT / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(ROOT / "graphbench" / "traffic" / f"{w['traffic']}.json") as f:
        mix = json.load(f)
    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                end_to_end=tuple(m for m in bench["end_to_end"] if _reports(m, name)),
                per_layer=tuple(m for m in bench["per_layer"] if _reports(m, name)))


def load_module(kind: str, name: str):
    """``graphbench/<kind>/<name>.py`` as a module (cached in ``sys.modules``)."""
    path = ROOT / "graphbench" / kind / f"{name}.py"
    key = f"graphbench.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing: {kind} {name!r} has no file")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod
