"""The triangle-count kind: its plain reference against hand-made graphs, its
first control against the program, and ``k4_roofline``'s bytes against
``chip_smoke.py``'s bound for kernel 4."""

import importlib.util
import itertools
import json
import subprocess
import sys

import pytest
import torch

from graphbench.core import bench
from graphbench.core.graph import Graph
from graphbench.core.spec import ROOT, find_cell, load_module

TC = load_module("reference", "tc")


def undirected(n, edges):
    """A Graph of the undirected ``(u, v)`` edges, both directions, sorted; weight 1."""
    edges = list(edges)
    pairs = sorted({(u, v) for u, v in edges} | {(v, u) for u, v in edges})
    r, c = zip(*pairs) if pairs else ((), ())
    return Graph(n=n, rows=torch.tensor(r, dtype=torch.int32), cols=torch.tensor(c, dtype=torch.int32),
                 weights=torch.ones(len(pairs), dtype=torch.float32), checksum=0)


def intersection_count(graph) -> int:
    """Σ over the stored entries (i, j) of |N(i) ∩ N(j)|, by sorted-row merges: 6 × the triangles."""
    rows, cols = graph.rows.tolist(), graph.cols.tolist()
    adj = [[] for _ in range(graph.n)]
    for r, c in zip(rows, cols):
        adj[r].append(c)
    count = 0
    for i, j in zip(rows, cols):
        a, b, x, y = adj[i], adj[j], 0, 0
        while x < len(a) and y < len(b):
            if a[x] == b[y]:
                count, x, y = count + 1, x + 1, y + 1
            elif a[x] < b[y]:
                x += 1
            else:
                y += 1
    return count


K4 = undirected(4, itertools.combinations(range(4), 2))  # 4 triangles
TREE = undirected(7, [(0, 1), (0, 2), (1, 3), (1, 4), (2, 5), (2, 6)])  # none
BIPARTITE = undirected(6, [(u, v) for u in range(3) for v in range(3, 6)])  # none
TWO = undirected(9, [(0, 1), (1, 2), (0, 2), (2, 3), (6, 7), (7, 8), (6, 8), (5, 8)])  # 2


@pytest.mark.parametrize("graph,triangles", [(K4, 4), (TREE, 0), (BIPARTITE, 0), (TWO, 2)],
                         ids=["k4", "tree", "bipartite", "two"])
def test_ordered_count_is_the_sorted_intersection_count(graph, triangles):
    assert TC.ordered_count(graph) == triangles
    assert 6 * triangles == intersection_count(graph)
    assert TC.reference(graph, None, {}).tolist() == [6 * triangles]


def test_ordered_count_in_small_blocks(monkeypatch):
    """A block of one probe gives the same count as one block of all."""
    graph = undirected(40, [(u, v) for u in range(40) for v in range(u + 1, 40) if (u * 7 + v * 3) % 5 == 0])
    whole = TC.ordered_count(graph)
    monkeypatch.setattr(TC, "BLOCK", 1)
    assert TC.ordered_count(graph) == whole == intersection_count(graph) // 6 > 0


def test_controls_and_comparison_by_hand():
    # the triangle {7, 638, 639} has its largest vertex in the last 1/64 of 640 rows
    g = undirected(640, [(0, 1), (1, 2), (0, 2), (7, 638), (638, 639), (7, 639)])
    ref = TC.reference(g, None, {})
    assert ref.tolist() == [12]
    assert TC.CONTROLS["last_rows_dropped"](g, None, {}).tolist() == [6]
    assert TC.CONTROLS["half_mask"](g, None, {}).tolist() == [6]
    assert TC.compare(ref, ref, {}) == {"count_mismatch": 0.0}
    assert TC.compare(torch.tensor([13]), ref, {}) == {"count_mismatch": 1.0}
    assert TC.compare(torch.tensor([12, 0]), ref, {}) == {"count_mismatch": float("inf")}
    assert TC.readings(g, {}) == {"triangles": 2, "six_t": 12,
                                  "controls": {"last_rows_dropped": 6, "half_mask": 6}}


def test_the_tc_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from graphbench.core.spec import load_module\n"
            "load_module('reference', 'tc')\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-3000:]
    assert "spla_tpu_torch" not in done.stdout and "'jax'" not in done.stdout


@pytest.mark.parametrize("seed", [1, 2**31 + 3, 5])
def test_the_first_control_reads_not_correct_and_the_program_correct(seed):
    """``graphbench/control.py`` at scale 8: the program passes the limit, the
    first control (the last rows' edges left out) fails it."""
    spec = importlib.util.spec_from_file_location("graphbench_control", ROOT / "graphbench" / "control.py")
    control = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(control)
    c = find_cell("urand-tc")
    limits = c.mix["check"]["limits"]
    first = next(iter(TC.CONTROLS))
    assert first == "last_rows_dropped"
    row = control.readings(c, seed, 2, 8, log=lambda line: None)
    assert bench.verdict(row["program"], limits)
    assert not bench.verdict({k: v for k, v in row["controls"][first].items() if k in limits}, limits)
    assert row["readings"]["six_t"] == 6 * row["readings"]["triangles"] > 0


def test_k4_roofline_counts_the_bytes_of_chip_smokes_bound():
    """``k4_roofline``'s work is ``chip_smoke.py`` ``mxmt_bound``'s for kernel 4's
    structural count with mask = A = B (no values, 8 bytes written)."""
    code = ("import json, sys; sys.path.insert(0, '.')\n"
            "import torch\n"
            "import chip_smoke as CS\n"
            "from spla_tpu_torch.tools.graphs import random_graph\n"
            "from spla_tpu_torch import formats as F\n"
            "A = F.csr_from_scipy(random_graph(1000, 12, seed=2), device='cpu')\n"
            "ms, by = CS.mxmt_bound(A, A, False, out_bytes=8)\n"
            "print(json.dumps({'n': A.shape[0], 'nnz': int(A.nnz), 'cap': A.capacity,"
            " 'bytes': ms * CS.HBM_BYTES_S / 1e3, 'by': by}))\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    smoke = json.loads(done.stdout.strip().splitlines()[-1])
    assert smoke["by"] == "bytes" and smoke["cap"] == smoke["nnz"]
    nbytes, flops = load_module("metrics", "k4_roofline").mxmt_reduce_work(smoke["n"], smoke["nnz"])
    assert flops == 0 and nbytes == pytest.approx(smoke["bytes"], rel=1e-12)
