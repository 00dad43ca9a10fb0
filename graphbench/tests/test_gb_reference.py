"""The plain references and their controls against hand-made graphs."""

import math

import pytest
import torch

from graphbench.core.graph import Graph
from graphbench.core.spec import load_module

BFS = load_module("reference", "bfs")
SSSP = load_module("reference", "sssp")
PR = load_module("reference", "pr")


def undirected(n, edges):
    """A Graph of the undirected ``(u, v, w)`` edges, both directions, sorted."""
    trip = sorted({(u, v, w) for u, v, w in edges} | {(v, u, w) for u, v, w in edges})
    r, c, w = zip(*trip)
    return Graph(n=n, rows=torch.tensor(r, dtype=torch.int32), cols=torch.tensor(c, dtype=torch.int32),
                 weights=torch.tensor(w, dtype=torch.float32), checksum=0)


# 0-1-2-3 a path, 1-4, 5-6 apart, 7 isolated
G1 = undirected(8, [(0, 1, 5), (1, 2, 1), (2, 3, 1), (1, 4, 10), (5, 6, 2), (0, 4, 20)])


def test_bfs_depths_by_hand():
    assert BFS.reference(G1, 0, {}).tolist() == [1, 2, 3, 4, 2, 0, 0, 0]
    assert BFS.reference(G1, 3, {}).tolist() == [4, 3, 2, 1, 4, 0, 0, 0]
    assert BFS.reference(G1, 5, {}).tolist() == [0, 0, 0, 0, 0, 1, 2, 0]


def test_bfs_control_drops_the_last_level():
    out = BFS.CONTROLS["one_level_short"](G1, 0, {})
    assert out.tolist() == [1, 2, 3, 0, 2, 0, 0, 0]
    ref = BFS.reference(G1, 0, {})
    assert BFS.compare(out, ref, {}) == {"depth_mismatch": 1.0}
    assert BFS.compare(ref, ref, {}) == {"depth_mismatch": 0.0}


def test_sssp_distances_by_hand():
    inf = math.inf
    assert SSSP.reference(G1, 0, {}).tolist() == [0, 5, 6, 7, 15, inf, inf, inf]
    assert SSSP.reference(G1, 4, {}).tolist() == [15, 10, 11, 12, 0, inf, inf, inf]
    assert SSSP.reference(G1, 6, {}).tolist() == [inf, inf, inf, inf, inf, 2, 0, inf]


def test_sssp_controls():
    ref = SSSP.reference(G1, 0, {})
    short = SSSP.CONTROLS["one_round_short"](G1, 0, {})
    assert SSSP.compare(short, ref, {})["dist_mismatch"] >= 1
    # bfloat16 holds whole numbers to 256 exactly: a chain past it reads wrong
    chain = undirected(4, [(0, 1, 255), (1, 2, 255), (2, 3, 3)])
    assert SSSP.reference(chain, 0, {}).tolist() == [0, 255, 510, 513]
    assert SSSP.compare(SSSP.CONTROLS["bf16"](chain, 0, {}), SSSP.reference(chain, 0, {}), {})["dist_mismatch"] == 1
    assert SSSP.compare(SSSP.CONTROLS["bf16"](G1, 0, {}), ref, {})["dist_mismatch"] == 0


def test_sssp_nan_never_matches():
    ref = SSSP.reference(G1, 0, {})
    out = ref.clone()
    out[1] = math.nan
    assert SSSP.compare(out, ref, {}) == {"dist_mismatch": 1.0}


MIX = {"alpha": 0.85, "eps": 1e-9}


def pagerank_by_hand(g, alpha, eps):
    """GAP's iteration in float64 with dense Python lists."""
    n = g.n
    nbrs = [[] for _ in range(n)]
    for r, c in zip(g.rows.tolist(), g.cols.tolist()):
        nbrs[r].append(c)
    p = [1.0 / n] * n
    while True:
        q = [(1 - alpha) / n + sum(alpha * p[j] / len(nbrs[j]) for j in nbrs[i]) for i in range(n)]
        err = math.sqrt(sum((a - b) ** 2 for a, b in zip(p, q)))
        p = q
        if err <= eps:
            return p


def test_pagerank_by_hand():
    want = pagerank_by_hand(G1, 0.85, 1e-9)
    got = PR.reference(G1, None, MIX)
    assert got.dtype == torch.float64
    assert max(abs(a - b) for a, b in zip(got.tolist(), want)) < 1e-12
    assert got[7] == pytest.approx(0.15 / 8)  # an isolated vertex keeps (1 - alpha) / n


def test_pagerank_compare_and_control():
    ref = PR.reference(G1, None, MIX)
    assert PR.compare(ref.float(), ref, MIX)["rank_rel_l2"] < 1e-7
    ctl = PR.CONTROLS["bf16"](G1, None, MIX)
    assert PR.compare(ctl, ref, MIX)["rank_rel_l2"] > 1e-3
    early = PR.ranks(G1, {"alpha": 0.85, "eps": 1e-3})
    assert PR.compare(early, ref, MIX)["rank_rel_l2"] > 1e-4
    short = PR.CONTROLS["one_iteration_short"](G1, None, MIX)
    assert 0 < PR.compare(short, ref, MIX)["rank_rel_l2"] < 1e-7
    assert math.isinf(PR.compare(ref[:3], ref, MIX)["rank_rel_l2"])


def steps_by_hand(g, alpha, iters):
    """The L1 and L2 norms of each of ``iters`` steps of GAP's iteration, by dense Python lists."""
    n = g.n
    nbrs = [[] for _ in range(n)]
    for r, c in zip(g.rows.tolist(), g.cols.tolist()):
        nbrs[r].append(c)
    p, l1, l2 = [1.0 / n] * n, [], []
    for _ in range(iters):
        q = [(1 - alpha) / n + sum(alpha * p[j] / len(nbrs[j]) for j in nbrs[i]) for i in range(n)]
        l1.append(sum(abs(a - b) for a, b in zip(p, q)))
        l2.append(math.sqrt(sum((a - b) ** 2 for a, b in zip(p, q))))
        p = q
    return l1, l2


@pytest.mark.parametrize("l1_stop,max_iters,eps", [(1e-4, 20, 1e-6), (1e-4, 5, 1e-3), (1e-9, 60, 1e-12)])
def test_pagerank_readings_find_gaps_stop_and_the_mixs(l1_stop, max_iters, eps):
    mix = {"alpha": 0.85, "eps": eps, "gap_stop": {"l1": l1_stop, "max_iters": max_iters}}
    got = PR.readings(G1, mix)
    l1, l2 = steps_by_hand(G1, 0.85, len(got["step_l1"]))
    assert got["step_l1"] == pytest.approx(l1, rel=1e-9, abs=1e-15)
    assert got["step_l2"] == pytest.approx(l2, rel=1e-9, abs=1e-15)
    gap = next(i for i, v in enumerate(l1, 1) if v < l1_stop or i >= max_iters)
    mine = next(i for i, v in enumerate(l2, 1) if v <= eps)
    assert (got["gap_iterations"], got["eps_iterations"]) == (gap, mine)
    assert len(l1) == max(gap, mine)  # it stops once both have
    ref = PR.reference(G1, None, mix)
    assert torch.equal(ref, PR.ranks(G1, mix, max_iters=mine))  # the reference stops where eps does
