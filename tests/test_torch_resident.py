"""The resident route of spla_tpu_torch's BFS and SSSP (kernel 6's plain
versions, the dispatch gate, ``formats.is_skewed``) against spla_tpu on the
same numpy graphs.

Depths and distances must match bitwise: the distances are the least
fixpoint of ``d[j] = min(d[j], d[i] + w)`` in f32, which every order of
relaxation reaches (IEEE addition is monotone and commutative).  The TPU
resident kernels run in Pallas interpret mode on the smallest graphs that
still give 30+ levels.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import spla_tpu.algorithms as JALG
import spla_tpu.formats as JF

from spla_tpu_torch import Descriptor, algorithms as alg, formats as F
from spla_tpu_torch.interop import from_spla_tpu, to_numpy
from spla_tpu_torch.kernels import resident as K6
from spla_tpu_torch.tools.graphs import (barbell_graph, path_graph, random_graph, road_edges,
                                         road_graphs)

INF = np.float32(np.inf)


def _road(side, seed=9):
    """The road class of bench_suite.py:323-333 (``side`` a power of two):
    uniform(0.1, 1.0) weights, symmetrized by maximum."""
    r, c = road_edges(side)
    n = side * side
    w = sp.csr_matrix((np.random.default_rng(seed).uniform(0.1, 1.0, r.size).astype(np.float32),
                       (r, c)), shape=(n, n))
    return w.maximum(w.T).tocsr()


def _random_symmetric(n=300, seed=5):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, 2 * n), rng.integers(0, n, 2 * n)
    keep = r != c
    a = sp.coo_matrix((rng.uniform(0.1, 2.0, int(keep.sum())).astype(np.float32),
                       (r[keep], c[keep])), shape=(n, n)).tocsr()
    return a.maximum(a.T).tocsr()


def _reset_stats():
    for k in alg.STATS:
        alg.STATS[k] = 0


GRAPHS = {"road16": lambda: _road(16), "random300": _random_symmetric}


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_plain_matches_the_pallas_resident_kernel(graph, kind):
    """Kernel 6's plain versions against spla_tpu's bfs_resident /
    sssp_resident (the TPU kernel it replaces) in interpret mode."""
    from spla_tpu.pallas.cellpack_native import _native_lib
    from spla_tpu.pallas.spmv import bfs_resident, build_fused_cell_spmv_arrays, sssp_resident

    if _native_lib() is None:
        pytest.skip("no native toolchain for spla_tpu's packer")
    a = GRAPHS[graph]()
    n = a.shape[0]
    coo = a.tocoo()
    bfs = kind == "bfs"
    fmt = build_fused_cell_spmv_arrays(n, n, coo.row.astype(np.int32), coo.col.astype(np.int32),
                                       np.ones(coo.nnz, np.float32) if bfs else coo.data,
                                       cw=1024, pattern=bfs)
    want = (bfs_resident if bfs else sssp_resident)(fmt, jnp.int32(0))
    assert want is not None, "the TPU resident gate must pass at this size"
    want = np.asarray(want).reshape(-1)[:n]
    A = F.csr_from_scipy(a, fill=INF, device="cpu")
    got, stats = (K6.bfs_resident_plain if bfs else K6.sssp_resident_plain)(A, 0)
    np.testing.assert_array_equal(to_numpy(got), want)
    rounds, capped, wide = stats.tolist()
    assert capped == 0 and rounds >= 1 and wide == 0
    if bfs:
        assert rounds == want.max()
        assert graph != "road16" or rounds == 31


@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_public_resident_route_matches_spla_tpu(kind, monkeypatch):
    """The public bfs / sssp on a side-32 road grid take the resident route
    (one host read) and equal spla_tpu's public functions on the CPU and
    the port's level loop."""
    a = _road(32)
    bfs = kind == "bfs"
    JA = JF.csr_from_scipy(a.astype(np.int32)) if bfs else JF.csr_from_scipy(a, fill=INF)
    fn = alg.bfs if bfs else alg.sssp
    want = np.asarray((JALG.bfs if bfs else JALG.sssp)(JA, 0).values)
    A = from_spla_tpu(JA, "cpu")
    _reset_stats()
    got = fn(A, 0).values
    assert alg.STATS["resident"] == alg.STATS["host_syncs"] == 1
    assert alg.STATS["level_loop"] == 0 and alg.STATS["capped"] == 0
    if bfs:
        assert alg.STATS["levels"] == 63
    np.testing.assert_array_equal(to_numpy(got), want)
    monkeypatch.setattr(alg, "RESIDENT_BYTES", 0)
    assert torch.equal(fn(A, 0).values, got)
    assert alg.STATS["level_loop"] == 1


@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_directed_resident_pushes_over_A(kind):
    """A directed grid (edges towards larger Morton ids, plus a few random
    ones): the resident route pushes over CSR(A), spla_tpu pulls over Aᵀ."""
    r, c = road_edges(32)
    keep = r < c
    rng = np.random.default_rng(3)
    n = 32 * 32
    r = np.concatenate([r[keep], rng.integers(0, n, 40)])
    c = np.concatenate([c[keep], rng.integers(0, n, 40)])
    a = sp.coo_matrix((rng.uniform(0.1, 1.0, r.size).astype(np.float32), (r, c)), shape=(n, n)).tocsr()
    a.sum_duplicates()
    a.setdiag(0)
    a.eliminate_zeros()
    bfs = kind == "bfs"
    JA = JF.csr_from_scipy(a.astype(np.int32)) if bfs else JF.csr_from_scipy(a, fill=INF)
    A = from_spla_tpu(JA, "cpu")
    assert alg._default_At(A) is not A  # really directed
    _reset_stats()
    got = (alg.bfs if bfs else alg.sssp)(A, 5).values
    assert alg.STATS["resident"] == 1
    want = np.asarray((JALG.bfs if bfs else JALG.sssp)(JA, 5).values)
    np.testing.assert_array_equal(to_numpy(got), want)


def test_resident_cap_stops_a_negative_cycle():
    """0 -> 1 -> 2 -> 0 weighs -1, so Bellman-Ford never settles: the
    resident route stops after n + 2 rounds and counts the run as capped
    (the level loop has no cap)."""
    a = sp.csr_matrix((np.array([1.0, 1.0, -3.0, 1.0], np.float32), ([0, 1, 2, 2], [1, 2, 0, 3])),
                      shape=(5, 5))
    A = F.csr_from_scipy(a, fill=INF, device="cpu")
    _reset_stats()
    d = to_numpy(alg.sssp(A, 0).values)
    assert alg.STATS["resident"] == alg.STATS["capped"] == 1
    assert alg.STATS["levels"] == 5 + 2
    assert np.isinf(d[4]) and np.all(np.isfinite(d[:4]))
    v = to_numpy(alg.bfs(A, 0).values)
    np.testing.assert_array_equal(v, [1, 2, 3, 4, 0])
    assert alg.STATS["capped"] == 1  # BFS ends by itself


def _star(n=400):
    """A ring plus a hub joined to every vertex: skewed by the JAX rule."""
    i = np.arange(n)
    r = np.concatenate([i, (i + 1) % n, np.zeros(n - 1, np.int64), i[1:]])
    c = np.concatenate([(i + 1) % n, i, i[1:], np.zeros(n - 1, np.int64)])
    w = np.random.default_rng(4).uniform(0.1, 1.0, r.size).astype(np.float32)
    a = sp.coo_matrix((w, (r, c)), shape=(n, n)).tocsr()
    a.sum_duplicates()
    return a.maximum(a.T).tocsr()


@pytest.mark.parametrize("graph", ["road", "star", "random"])
def test_is_skewed_matches_spla_tpu(graph):
    from spla_tpu.pallas.spmv import _skew_stats, is_skewed

    a = {"road": lambda: _road(16), "star": _star, "random": _random_symmetric}[graph]()
    JA = JF.csr_from_scipy(a, fill=INF)
    A = from_spla_tpu(JA, "cpu")
    assert F.skew_stats(A) == _skew_stats(JA)
    assert F.is_skewed(A) == is_skewed(JA) == (graph == "star")


@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_skewed_graph_keeps_the_level_loop(kind):
    a = _star()
    bfs = kind == "bfs"
    JA = JF.csr_from_scipy(a.astype(np.int32)) if bfs else JF.csr_from_scipy(a, fill=INF)
    _reset_stats()
    got = (alg.bfs if bfs else alg.sssp)(from_spla_tpu(JA, "cpu"), 3).values
    assert alg.STATS["level_loop"] == 1 and alg.STATS["resident"] == 0
    want = np.asarray((JALG.bfs if bfs else JALG.sssp)(JA, 3).values)
    np.testing.assert_array_equal(to_numpy(got), want)


def test_int_and_non_finite_sssp_keep_the_level_loop():
    """int weights (the JAX gate's f32 condition) and a NaN weight (whose
    NaN distances would depend on the order of the kernel's relaxations)
    route SSSP to the level loop; the same graphs' BFS stays resident."""
    a = _road(8)
    ai = a.copy()
    ai.data = np.arange(1, a.nnz + 1, dtype=np.int32) % 7 + 1
    an = a.copy()
    an.data[5] = np.nan
    for m, fill in ((ai, np.int32(0)), (an, INF)):
        A = F.csr_from_scipy(m, fill=fill, device="cpu")
        _reset_stats()
        alg.sssp(A, 0, At=A)
        assert alg.STATS["level_loop"] == 1 and alg.STATS["resident"] == 0
        alg.bfs(A, 0, At=A)
        assert alg.STATS["resident"] == 1
    JAi = JF.csr_from_scipy(ai, fill=np.int32(0))
    np.testing.assert_array_equal(to_numpy(alg.sssp(from_spla_tpu(JAi, "cpu"), 0).values),
                                  np.asarray(JALG.sssp(JAi, 0).values))


def test_resident_ignores_the_descriptor():
    a = _road(16)
    A = F.csr_from_scipy(a, fill=INF, device="cpu")
    _reset_stats()
    outs = [alg.sssp(A, 0, d).values for d in (None, Descriptor(push_only=True),
                                               Descriptor(pull_only=True))]
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert alg.STATS["resident"] == 3 and alg.STATS["push"] == alg.STATS["pull"] == 0


def test_resident_bytes_of_the_benchmark_graphs():
    """The gate on the graphs in use: the side-1024 road BFS grid (2 x 2 x
    1024 x 1023 entries) and the side-512 road SSSP grid fit the 50 MB L2
    budget; the n = 2^20, degree-16 random graph does not."""
    assert alg.RESIDENT_BYTES == 50 * 1024 * 1024
    assert alg.resident_bytes(1 << 20, 4 * 1024 * 1023, False) == 33_538_052 <= alg.RESIDENT_BYTES
    assert alg.resident_bytes(1 << 18, 4 * 512 * 511, True) == 13_615_108 <= alg.RESIDENT_BYTES
    assert alg.resident_bytes(1 << 20, 16_777_062, False) > alg.RESIDENT_BYTES


@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_gate_reads_nothing_on_the_host_beyond_the_budget(kind, monkeypatch):
    """Over the byte budget the gate decides without ``is_skewed`` or the
    finite-weight check, both of which read the matrix on the host."""
    def host_read(_):
        raise AssertionError("the gate read the matrix on the host")

    monkeypatch.setattr(alg, "RESIDENT_BYTES", 0)
    monkeypatch.setattr(alg, "is_skewed", host_read)
    monkeypatch.setattr(alg, "_finite", host_read)
    A = F.csr_from_scipy(_road(8), fill=INF, device="cpu")
    _reset_stats()
    (alg.bfs if kind == "bfs" else alg.sssp)(A, 0, At=A)
    assert alg.STATS["level_loop"] == 1 and alg.STATS["resident"] == 0


LEVEL_GRAPHS = {"path": lambda: path_graph(300), "barbell": lambda: barbell_graph(20, 200, 6)}


def _rounds_numpy(a, source, sssp, wide_above):
    """(rounds, capped, wide) of the synchronous queue traversal from
    ``source`` in numpy: a round walks the rows of its queue; the next queue
    holds the vertices it reached first (BFS) or lowered (SSSP, from the
    distances at the round's start); wide counts the rounds whose queue
    held more than ``wide_above`` vertices."""
    n = a.shape[0]
    d = np.full(n, np.inf, np.float32)
    d[source] = 0
    queue = np.array([source])
    rounds = wide = 0
    while queue.size and rounds < n + 2:
        rounds += 1
        wide += queue.size > wide_above
        sub = a[queue].tocoo()
        if sssp:
            hits = np.full(n, np.inf, np.float32)
            np.minimum.at(hits, sub.col, d[queue[sub.row]] + sub.data)
            new = np.minimum(d, hits)
            queue, d = np.flatnonzero(new < d), new
        else:
            queue = np.unique(sub.col[np.isinf(d[sub.col])])
            d[queue] = rounds
    return rounds, int(queue.size > 0), wide


@pytest.mark.parametrize("graph", list(LEVEL_GRAPHS))
@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_plain_wide_rounds_match_numpy(graph, kind, monkeypatch):
    """The plain versions' stats against the numpy definition, with T cut
    (kernel 6's CTAs of 4 threads: T = 32 / G) so that the small barbell's
    blocks make wide rounds and its paths narrow ones; the public route
    sums the wide rounds into ``STATS["wide_rounds"]``."""
    monkeypatch.setattr(K6, "CTA_THREADS", 4)
    a = LEVEL_GRAPHS[graph]()
    A = F.csr_from_scipy(a, fill=INF, device="cpu")
    plan = K6.resident_plan(A)
    assert plan.wide_above == K6.LEAD_CTAS * 4 // plan.team
    _, stats = (K6.bfs_resident_plain if kind == "bfs" else K6.sssp_resident_plain)(A, 0)
    want = _rounds_numpy(a, 0, kind == "sssp", plan.wide_above)
    assert tuple(stats.tolist()) == want
    rounds, _, wide = want
    _reset_stats()
    (alg.bfs if kind == "bfs" else alg.sssp)(A, 0, At=A)
    assert alg.STATS["resident"] == 1 and alg.STATS["wide_rounds"] == wide
    if graph == "path":
        assert rounds == a.shape[0] and wide == 0
    else:
        assert 0 < wide < rounds


def _team_numpy(nnz, n):
    """The least power of two from 2 to 32 at or above half the mean out-degree."""
    for g in (2, 4, 8, 16):
        if g >= nnz / max(n, 1) / 2:
            return g
    return 32


RANDOM_DENSE = sp.random(64, 64, density=0.9, random_state=1, format="csr", dtype=np.float32)
PLAN_GRAPHS = {"path": lambda: path_graph(50), "road16": lambda: _road(16),
               "random300": _random_symmetric, "random_deg16": lambda: random_graph(2000, 16),
               "dense": lambda: RANDOM_DENSE, "empty": lambda: sp.csr_matrix((10, 10), dtype=np.float32)}


@pytest.mark.parametrize("graph", list(PLAN_GRAPHS))
def test_resident_plan_matches_definition(graph):
    """G from kernel 1's rule on the mean out-degree, T the lead cluster's
    teams; cached per indptr tensor."""
    a = PLAN_GRAPHS[graph]()
    A = F.csr_from_scipy(a, fill=INF, device="cpu")
    plan = K6.resident_plan(A)
    g = _team_numpy(a.nnz, a.shape[0])
    assert plan == K6.ResidentPlan(g, K6.LEAD_CTAS * K6.CTA_THREADS // g)
    assert K6.resident_plan(A) is plan
    assert {"path": 2, "road16": 2, "random_deg16": 8, "dense": 32, "empty": 2}.get(graph, g) == g


@pytest.mark.parametrize("graph", list(LEVEL_GRAPHS))
@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_plain_levels_match_spla_tpu(graph, kind):
    """Kernel 6's plain versions on the path and barbell graphs against
    spla_tpu's bfs / sssp on the CPU (its XLA level loop)."""
    a = LEVEL_GRAPHS[graph]()
    bfs = kind == "bfs"
    JA = JF.csr_from_scipy(a.astype(np.int32)) if bfs else JF.csr_from_scipy(a, fill=INF)
    want = np.asarray((JALG.bfs if bfs else JALG.sssp)(JA, 0, At=JA).values)
    A = F.csr_from_scipy(a, fill=INF, device="cpu")
    got, stats = (K6.bfs_resident_plain if bfs else K6.sssp_resident_plain)(A, 0)
    np.testing.assert_array_equal(to_numpy(got), want)
    if bfs:
        assert stats.tolist()[0] == want.max()


@pytest.mark.parametrize("sides", [(16, 8), (32, 16)])
def test_road_graphs_match_bench_suite(sides):
    """``road_graphs`` builds its BFS grid with ``road_grid``; both graphs
    equal bench_suite.py:226-253,323-334's, which keep the Morton ids as
    vertex ids and draw the corner's weights in edge order."""
    side, side_s = sides
    rr, cc = road_edges(side)
    n, nrs = side * side, side_s * side_s
    want = sp.csr_matrix((np.ones(rr.size, np.float32), (rr, cc)), shape=(n, n))
    sel = (rr < nrs) & (cc < nrs)
    w = sp.csr_matrix((np.random.default_rng(9).uniform(0.1, 1.0, int(sel.sum())).astype(np.float32),
                       (rr[sel], cc[sel])), shape=(nrs, nrs))
    want_w = w.maximum(w.T).tocsr()
    road, road_w = road_graphs(side, side_s)
    for got, ref in ((road, want), (road_w, want_w)):
        assert got.shape == ref.shape and (got != ref).nnz == 0
