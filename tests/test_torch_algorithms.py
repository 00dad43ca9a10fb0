"""spla_tpu_torch's BFS / SSSP / PageRank against spla_tpu on the same graphs.

BFS depths and SSSP distances must match bitwise in every traversal mode;
PageRank within rtol=1e-5, atol=1e-5 (f32 sums in another order).  The
tests of the traversal modes gate the resident route off
(``RESIDENT_BYTES = 0``), as spla_tpu's tests gate ``RESIDENT_VMEM``;
tests/test_torch_resident.py covers that route.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as cg
import torch

import jax.numpy as jnp

import spla_tpu.algorithms as JALG
import spla_tpu.formats as JF

from spla_tpu_torch import Descriptor, algorithms as alg, formats as F
from spla_tpu_torch.interop import from_spla_tpu, to_numpy
from spla_tpu_torch.tools.graphs import skewed_graph

N = 500
MODES = {"default": None, "push_only": Descriptor(push_only=True),
         "pull_only": Descriptor(pull_only=True)}


def _graph(seed, symmetric, n=N, deg=3):
    """Random graph with a few isolated vertices; weights in [0.1, 2)."""
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n - 5, deg * n), rng.integers(0, n - 5, deg * n)
    keep = r != c
    a = sp.coo_matrix((np.ones(int(keep.sum()), np.float32), (r[keep], c[keep])),
                      shape=(n, n)).tocsr()
    a.sum_duplicates()
    a.data = rng.uniform(0.1, 2.0, a.nnz).astype(np.float32)
    if symmetric:  # symmetric weights too: the upper triangle mirrored
        u = sp.triu(a, k=1)
        a = (u + u.T).tocsr()
    return a


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("mode", list(MODES))
def test_bfs_matches_spla_tpu(symmetric, mode, monkeypatch):
    monkeypatch.setattr(alg, "RESIDENT_BYTES", 0)
    a = _graph(1, symmetric)
    JA = JF.csr_from_scipy(a.astype(np.int32))
    want = np.asarray(JALG.bfs(JA, 3).values)
    got = alg.bfs(from_spla_tpu(JA, "cpu"), 3, MODES[mode]).values
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("mode", list(MODES))
def test_sssp_matches_spla_tpu(symmetric, mode, monkeypatch):
    monkeypatch.setattr(alg, "RESIDENT_BYTES", 0)
    a = _graph(2, symmetric)
    JA = JF.csr_from_scipy(a, fill=np.float32(np.inf))
    want = np.asarray(JALG.sssp(JA, 3).values)
    got = alg.sssp(from_spla_tpu(JA, "cpu"), 3, MODES[mode]).values
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("kind", ["bfs", "sssp"])
@pytest.mark.parametrize("mode", list(MODES))
def test_skewed_graph_matches_spla_tpu(kind, mode):
    """bench_suite's skewed graph at n = 2^10 (directed, zipf out-degrees):
    the skew gate sends it to the level loop, whose depths and distances
    equal spla_tpu's bitwise in every mode."""
    a = skewed_graph(1 << 10)
    JA = JF.csr_from_scipy(a.astype(np.int32)) if kind == "bfs" else \
        JF.csr_from_scipy(a, fill=np.float32(np.inf))
    assert F.is_skewed(F.csr_from_scipy(a, device="cpu"))
    for k in alg.STATS:
        alg.STATS[k] = 0
    if kind == "bfs":
        want = np.asarray(JALG.bfs(JA, 0).values)
        got = alg.bfs(from_spla_tpu(JA, "cpu"), 0, MODES[mode]).values
    else:
        want = np.asarray(JALG.sssp(JA, 0).values)
        got = alg.sssp(from_spla_tpu(JA, "cpu"), 0, MODES[mode]).values
    assert alg.STATS["level_loop"] == 1 and alg.STATS["resident"] == 0 and alg.STATS["levels"] > 2
    np.testing.assert_array_equal(to_numpy(got), want)


def test_pr_matches_spla_tpu():
    a = _graph(3, True)
    outdeg = np.asarray(a.sum(axis=0)).ravel()
    outdeg[outdeg == 0] = 1
    JA = JF.csr_from_scipy(a.multiply(0.85 / outdeg).tocsr().astype(np.float32))
    want = np.asarray(JALG.pr(JA, 0.85, 1e-6).values)
    got = alg.pr(from_spla_tpu(JA, "cpu"), 0.85, 1e-6).values
    np.testing.assert_allclose(to_numpy(got), want, rtol=1e-5, atol=1e-5)


def test_sssp_matches_the_pallas_level_loop(monkeypatch):
    """The whole TPU SSSP loop (fused_spmv2d_adaptive min-plus +
    sssp_level_update_auto, the resident kernel gated off), in interpret
    mode, against the port's SSSP in every mode."""
    from spla_tpu.pallas.cellpack_native import _native_lib
    import spla_tpu.pallas.spmv as SP

    if _native_lib() is None:
        pytest.skip("no native toolchain for spla_tpu's packer")
    monkeypatch.setattr(SP, "RESIDENT_VMEM", 0)
    monkeypatch.setattr(alg, "RESIDENT_BYTES", 0)
    a = _graph(4, True, n=300)
    coo = a.tocoo()
    fmt = SP.build_fused_cell_spmv_arrays(300, 300, coo.row.astype(np.int32),
                                          coo.col.astype(np.int32), coo.data, cw=1024)
    want = np.asarray(JALG._sssp_kernel_pallas(fmt, jnp.int32(2)))
    A = from_spla_tpu(JF.csr_from_scipy(a, fill=np.float32(np.inf)), "cpu")
    for d in MODES.values():
        got = alg.sssp(A, 2, d, At=A).values
        np.testing.assert_array_equal(to_numpy(got), want)


def test_pin_unreached_sssp_is_inf():
    """Deliberate difference from the C++ spla: unreached is +inf, not FLT_MAX."""
    a = _graph(5, True)
    d = to_numpy(alg.sssp(from_spla_tpu(JF.csr_from_scipy(a, fill=np.float32(np.inf)), "cpu"),
                          0).values)
    ref = cg.dijkstra(a, indices=0)
    assert np.isinf(ref[-1]) and np.all(np.isposinf(d[np.isinf(ref)]))
    np.testing.assert_allclose(d[np.isfinite(ref)], ref[np.isfinite(ref)], rtol=1e-5)


def test_pin_unreached_sssp_with_int32_weights_is_inf():
    """A reference fault the port does not copy: on int32 weights spla_tpu
    reports each unreached vertex as 2147483648.0, not +inf.  Its XLA path
    passes inf as init to masked_spmv (spla_tpu/algorithms.py:413-419),
    which casts init to the values' dtype (spla_tpu/ops/spmv.py:69), the
    largest int32.  The port gives +inf there, as scipy's dijkstra does,
    and spla_tpu's distances everywhere else."""
    rng = np.random.default_rng(2)
    n = 200
    r, c = rng.integers(0, n, 800), rng.integers(0, n, 800)
    a = sp.csr_matrix((rng.integers(1, 5, 800).astype(np.int32), (r, c)), shape=(n, n))
    JA = JF.csr_from_scipy(a)
    want = np.asarray(JALG.sssp(JA, 5).values)
    got = to_numpy(alg.sssp(from_spla_tpu(JA, "cpu"), 5).values)
    ref = cg.dijkstra(a, indices=5)
    unreached = np.isinf(ref)
    assert unreached.sum() >= 3
    assert np.all(np.isposinf(got[unreached]))
    np.testing.assert_array_equal(want[unreached], np.float32(2147483648.0))
    np.testing.assert_array_equal(got[~unreached], want[~unreached])
    np.testing.assert_array_equal(got[~unreached], ref[~unreached])


def test_pin_directed_pull_uses_the_transpose(monkeypatch):
    """Deliberate difference from the C++ spla: pull over a directed graph
    walks Aᵀ, so the default traversal follows A's edges (0 -> 1 -> 2) in
    every mode.  ``At=A`` declares the graph undirected; on a directed one,
    pull then walks the edges backwards, as in spla_tpu."""
    monkeypatch.setattr(alg, "RESIDENT_BYTES", 0)
    a = sp.csr_matrix((np.ones(2, np.float32), ([0, 1], [1, 2])), shape=(3, 3))
    A = from_spla_tpu(JF.csr_from_scipy(a.astype(np.int32)), "cpu")
    for d in MODES.values():
        np.testing.assert_array_equal(to_numpy(alg.bfs(A, 0, d).values), [1, 2, 3])
    np.testing.assert_array_equal(to_numpy(alg.bfs(A, 2, MODES["pull_only"], At=A).values),
                                  [3, 2, 1])
    assert alg._default_At(A) is not A
    S = from_spla_tpu(JF.csr_from_scipy((a + a.T).astype(np.int32)), "cpu")
    assert alg._default_At(S) is S  # symmetric: A itself


def test_naive_oracles_match():
    a = _graph(6, False, n=60)
    csr = a.tocsr()
    adj = [list(csr.indices[csr.indptr[i]:csr.indptr[i + 1]]) for i in range(60)]
    w = [list(csr.data[csr.indptr[i]:csr.indptr[i + 1]]) for i in range(60)]
    np.testing.assert_array_equal(alg.bfs_naive(adj, 0), JALG.bfs_naive(adj, 0))
    np.testing.assert_array_equal(alg.sssp_naive(adj, w, 0), JALG.sssp_naive(adj, w, 0))
    at = csr.T.tocsr()
    adj_in = [list(at.indices[at.indptr[i]:at.indptr[i + 1]]) for i in range(60)]
    w_in = [[0.85 / 3] * len(r) for r in adj_in]
    np.testing.assert_array_equal(alg.pr_naive(adj_in, w_in, 0.85, 1e-4),
                                  JALG.pr_naive(adj_in, w_in, 0.85, 1e-4))
    A = from_spla_tpu(JF.csr_from_scipy(a.astype(np.int32)), "cpu")
    np.testing.assert_array_equal(to_numpy(alg.bfs(A, 0).values), alg.bfs_naive(adj, 0))


def test_front_factor_of_descriptor():
    assert alg._front_factor_of(None) == 0.1
    assert alg._front_factor_of(Descriptor(push_only=True)) == 1.0
    assert alg._front_factor_of(Descriptor(pull_only=True)) == 0.0
    assert alg._front_factor_of(Descriptor(front_factor=0.25)) == 0.25


def test_stats_count_levels_and_host_syncs(monkeypatch):
    monkeypatch.setattr(alg, "RESIDENT_BYTES", 0)
    a = _graph(7, True)
    A = from_spla_tpu(JF.csr_from_scipy(a.astype(np.int32)), "cpu")
    for k in alg.STATS:
        alg.STATS[k] = 0
    v = to_numpy(alg.bfs(A, 0, At=A).values)
    assert alg.STATS["levels"] == alg.STATS["host_syncs"] == v.max()
    assert alg.STATS["push"] + alg.STATS["pull"] == alg.STATS["levels"]
    assert alg.STATS["level_loop"] == 1 and alg.STATS["resident"] == 0
    assert torch.is_tensor(alg.bfs(A, 0, At=A).values)
