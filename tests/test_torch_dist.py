"""spla_tpu_torch.parallel against spla_tpu.parallel at S = 4, on the CPU.

The JAX side runs on conftest's virtual devices (``make_device_mesh(4)``);
the port's side runs in a world of 4 gloo ranks, spawned once for the
module, each rank a process of one torch thread that takes jobs from
``tests/torch_dist_jobs.py`` (the ranks import that module, which imports
no jax).  Both sides get the same shards: the port's are built from the
JAX package's arrays (``interop.sharded_csr_from_numpy``).  A port
function returns its rank's ``[mloc]`` rows; the ranks' rows stacked are
JAX's ``[S, mloc]`` result.

Tolerances: f32 PLUS folds within rtol 1e-5 (atol 1e-6 for sums that
cancel), PageRank within rtol 1e-4, atol 1e-8 (``test_dist.py:187``): the
order of the sums differs; BFS depths, SSSP distances (min-plus: every
round folds the same float sums), integer results, TC and stats bitwise.

The ``_pallas`` functions run kernel 1's plain version here.  Three are
held against JAX's own ``_pallas`` (interpret mode, ~15 s of compiling
each, in three child processes started with the module, so that they run
beside the rest of the file); the ``_overlap`` ones, which compute the
same function, against the JAX package's XLA route at the same exchange
cap, to keep this file near a minute.
"""

import io
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax

import spla_tpu.formats as JF
import spla_tpu.op as JOP
import spla_tpu.parallel as JP
from spla_tpu.reorder import deal_permutation as j_deal, relabel_degree_sorted as j_relabel

import torch_dist_jobs as J
from spla_tpu_torch import formats as F, parallel as P
from spla_tpu_torch.interop import csr_from_numpy, to_numpy
from spla_tpu_torch.parallel import World, dist_ops
from spla_tpu_torch.reorder import deal_permutation, relabel_degree_sorted

S = 4
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def mesh():
    return JP.make_device_mesh(S)


@pytest.fixture(scope="module")
def world():
    with World(S, threads=1) as w:
        yield w


def random_undirected(n, avg_deg, seed, weighted=False):
    """test_dist.py's graph: symmetric, no self loops, 0/1 or uniform(0.1, 2) weights."""
    rng = np.random.default_rng(seed)
    m = n * avg_deg // 2
    r, c = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = r != c
    r, c = r[keep], c[keep]
    rows, cols = np.concatenate([r, c]), np.concatenate([c, r])
    if weighted:
        w = rng.uniform(0.1, 2.0, r.size).astype(np.float32)
        vals = np.concatenate([w, w])
    else:
        vals = np.ones(rows.size, np.float32)
    a = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    a.sum_duplicates()
    if not weighted:
        a.data[:] = 1
    return a.tocsr()


def lollipop(k=24, n=90):
    """A clique of k and a path to n: dense levels, then near-empty ones."""
    ci, cj = np.meshgrid(np.arange(k), np.arange(k))
    keep = ci.ravel() != cj.ravel()
    pr, pc = np.arange(k - 1, n - 1), np.arange(k, n)
    rows = np.concatenate([ci.ravel()[keep], pr, pc])
    cols = np.concatenate([cj.ravel()[keep], pc, pr])
    return sp.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)), shape=(n, n)).tocsr()


def scaled(a, alpha=0.85):
    outdeg = np.asarray(a.sum(axis=0)).ravel()
    outdeg[outdeg == 0] = 1.0
    return a.multiply(alpha / outdeg).tocsr().astype(np.float32)


def fields(sc):
    """The numpy fields of a spla_tpu ShardedCsr."""
    return {"shape": sc.shape, "n_shards": sc.n_shards, **{f: np.asarray(getattr(sc, f)) for f in
                                                           ("indptr", "cols", "values", "row_ids", "nnz", "fill")}}


def coo_fields(a, split=False, values=None):
    """The host COO a spla_tpu ShardedCellSpmv is packed from."""
    a = a.tocsr()
    a.sort_indices()
    c = a.tocoo()
    vals = np.broadcast_to(np.float32(values), c.data.shape) if values is not None else c.data
    return {"shape": a.shape, "n_shards": S, "rows": c.row, "cols": c.col, "values": vals, "split": split}


def stacked(results):
    return np.stack([np.asarray(r) for r in results])


def port_csr(a, fill=0):
    A = F.csr_from_scipy(a, fill=fill, device="cpu")
    return A, {f: to_numpy(getattr(A, f)) for f in ("indptr", "cols", "values", "row_ids", "nnz", "fill")}


# ---------------------------------------------------------------- the world and the partitioners


def test_parallel_exports_every_jax_name_and_imports_no_jax():
    assert set(JP.__all__) <= set(P.__all__)
    assert all(hasattr(P, name) for name in JP.__all__)
    r = subprocess.run([sys.executable, "-c",
                        "import sys, spla_tpu_torch.parallel, spla_tpu_torch.reorder, spla_tpu_torch\n"
                        "spla_tpu_torch.parallel\n"
                        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'spla_tpu')]\n"
                        "assert not bad, bad\n"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_mesh_and_collectives(world):
    info = world.run(J.mesh_info)
    assert [i["rank"] for i in info] == [i["axis_index"] for i in info] == list(range(S))
    assert all(i["size"] == S and i["backend"] == "gloo" and i["device"] == "cpu" for i in info)
    for i in info:
        np.testing.assert_array_equal(i["rows"], np.repeat(np.arange(S, dtype=np.int32), 3))
    out = world.run(J.collectives)
    flags = np.concatenate([[r % 2 == 0, True, False] for r in range(S)])
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o["psum"], [sum(range(1, S + 1)), -sum(range(S))])
        np.testing.assert_array_equal(o["pmax"], [S, 0])
        nxt = (r + 1) % S  # ppermute sends to r - 1: rank r holds rank r + 1's
        np.testing.assert_array_equal(o["ring"], [nxt + 1.0, -nxt])
        np.testing.assert_array_equal(o["ring_flags"], [nxt % 2 == 0, True, False])
        np.testing.assert_array_equal(o["flags"], flags)


def test_world_fails_and_closes_when_a_rank_dies():
    w = World(2, threads=1, timeout_s=30.0)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 exited|rank 0 failed"):
        w.run(J.die, 1)
    assert time.monotonic() - t0 < 30.0
    assert all(not p.is_alive() for p in w._procs or [])
    with pytest.raises(RuntimeError, match="closed"):
        w.run(J.mesh_info)


def test_reorder_matches_jax():
    rng = np.random.default_rng(3)
    deg = rng.zipf(2.0, 1000)
    for got, want in zip(deal_permutation(deg, 1000, 256), j_deal(deg, 1000, 256)):
        np.testing.assert_array_equal(got, want)
    rows = rng.integers(0, 301, 2000) ** 2 // 301
    for got, want in zip(relabel_degree_sorted(rows, rows, 301, S, 76), j_relabel(rows, rows, 301, S, 76)):
        np.testing.assert_array_equal(got, want)


def _same_shard(got, want, s):
    for f in ("indptr", "cols", "values", "row_ids", "nnz"):
        np.testing.assert_array_equal(to_numpy(getattr(got, f)), np.asarray(getattr(want, f))[s])
    assert got.shape == tuple(want.shape) and got.mloc == want.mloc and got.n_shards == want.n_shards


@pytest.mark.parametrize("kind", ["rows", "balanced", "split"])
def test_partitioners_match_jax(mesh, world, kind):
    # clustered heavy rows (test_dist.py:333): the balanced deal moves them apart
    n = 161
    rng = np.random.default_rng(5)
    heavy = np.repeat(np.arange(16), 24)
    r = np.concatenate([heavy, rng.integers(16, n, 150)])
    c = np.concatenate([rng.integers(0, n, heavy.size), rng.integers(0, n, 150)])
    a = sp.coo_matrix((np.ones(r.size, np.float32), (r, c)), shape=(n, n))
    a = ((a + a.T) > 0).astype(np.int32).tocsr()
    A, host = port_csr(a)
    JA = JF.csr_from_scipy(a)
    if kind == "rows":
        got, want = P.shard_csr_by_rows(A, S), [JP.shard_csr_by_rows(JA, S, mesh)]
        got = [got]
    elif kind == "balanced":
        got, g_old, g_new = P.shard_csr_by_rows_balanced(A, S)
        want, w_old, w_new = JP.shard_csr_by_rows_balanced(JA, S, mesh)
        np.testing.assert_array_equal(g_old, w_old)
        np.testing.assert_array_equal(g_new, w_new)
        got, want = [got], [want]
    else:
        got, want = P.shard_csr_split_diag(A, S), JP.shard_csr_split_diag(JA, S, mesh)
    for g, w in zip(got, want):
        for s in range(S):
            _same_shard(g[s], w, s)
    # the same shards, made on each rank with its mesh
    on_ranks = world.run(J.partition, kind, {"shape": a.shape, **host}, S)
    for s, res in enumerate(on_ranks):
        res = res if kind != "rows" else (res,)
        for g, w in zip(res, want):
            for f in ("indptr", "cols", "values", "row_ids", "nnz"):
                np.testing.assert_array_equal(g[f], np.asarray(getattr(w, f))[s])
    x = np.arange(n, dtype=np.float32)
    np.testing.assert_array_equal(P.shard_vector_by_rows(x, S, want[0].mloc).numpy(),
                                  np.asarray(JP.shard_vector_by_rows(x, S, want[0].mloc, mesh)))


# ---------------------------------------------------------------- SpMV, PageRank, BFS, SSSP


SPMV_CASES = {"MULT/PLUS f32": ("MULT", "PLUS", np.float32, 0.0),
              "PLUS/MIN f32": ("PLUS", "MIN", np.float32, np.inf),
              "MULT/PLUS i32": ("MULT", "PLUS", np.int32, 0),
              "MIN/MAX i32": ("MIN", "MAX", np.int32, -(1 << 30))}


@pytest.mark.parametrize("case", list(SPMV_CASES))
def test_dist_masked_spmv_matches_jax(mesh, world, case):
    mul, add, dtype, init = SPMV_CASES[case]
    tname = "FLOAT" if dtype == np.float32 else "INT"
    n = 203  # S does not divide it
    rng = np.random.default_rng(1)
    a = random_undirected(n, 6, 0, weighted=True)
    a.data = (a.data * 4 - 4).astype(dtype) if dtype == np.int32 else a.data
    a = a.astype(dtype)
    sc = JP.shard_csr_by_rows(JF.csr_from_scipy(a), S, mesh)
    x = rng.normal(size=n).astype(np.float32) if dtype == np.float32 else rng.integers(-9, 10, n).astype(dtype)
    xs = JP.shard_vector_by_rows(x, S, sc.mloc, mesh)
    want = np.asarray(JP.dist_masked_spmv(mesh, sc, xs, getattr(JOP, f"{mul}_{tname}"),
                                          getattr(JOP, f"{add}_{tname}"), init))
    got = stacked(world.run(J.masked_spmv, fields(sc), np.asarray(xs), f"{mul}_{tname}", f"{add}_{tname}", init))
    assert got.dtype == want.dtype
    if case == "MULT/PLUS f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("overlap", [False, True])
def test_dist_pagerank_matches_jax(mesh, world, overlap):
    As = JF.csr_from_scipy(scaled(random_undirected(130, 5, 21)))
    if overlap:
        diag, off = JP.shard_csr_split_diag(As, S, mesh)
        want = np.asarray(JP.dist_pagerank_overlap(mesh, diag, off, 0.85, 1e-6))
        got = stacked(world.run(J.pagerank, fields(diag), 0.85, 1e-6, fields(off)))
    else:
        sc = JP.shard_csr_by_rows(As, S, mesh)
        want = np.asarray(JP.dist_pagerank(mesh, sc, 0.85, 1e-6))
        got = stacked(world.run(J.pagerank, fields(sc), 0.85, 1e-6))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-8)


CAPS = {"ladder": None, "dense": 0, "one tier": 6, "tuple": (1, 8)}


@pytest.mark.parametrize("cap", list(CAPS))
@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_dist_traversals_match_jax(mesh, world, kind, cap):
    frontier_cap = CAPS[cap]
    a = lollipop()
    if kind == "sssp":
        a.data = np.random.default_rng(4).uniform(0.1, 2.0, a.nnz).astype(np.float32)
        a = ((a + a.T) / 2).tocsr()
    sc = JP.shard_csr_by_rows(JF.csr_from_scipy(a), S, mesh)
    fn = JP.dist_bfs if kind == "bfs" else JP.dist_sssp
    want, want_stats = fn(mesh, sc, 3, frontier_cap=frontier_cap, with_stats=True)
    res = world.run(J.traversal, kind, fields(sc), 3, frontier_cap)
    np.testing.assert_array_equal(stacked([r[0] for r in res]), np.asarray(want))
    for _, stats, reads in res:
        assert stats == want_stats
        assert reads == stats["levels" if kind == "bfs" else "rounds"]  # one host read a step


def test_balanced_bfs_reads_back_through_the_permutation(mesh, world):
    a = random_undirected(161, 5, 8)
    Ja = JF.csr_from_scipy(a.astype(np.int32))
    bal, _, new_of_old = JP.shard_csr_by_rows_balanced(Ja, S, mesh)
    want = np.asarray(JP.dist_bfs(mesh, bal, int(new_of_old[3])))
    res = world.run(J.traversal, "bfs", fields(bal), int(new_of_old[3]), None)
    got = stacked([r[0] for r in res])
    np.testing.assert_array_equal(got, want)
    adj = [a.indices[a.indptr[i]:a.indptr[i + 1]].tolist() for i in range(a.shape[0])]
    from spla_tpu_torch.algorithms import bfs_naive

    np.testing.assert_array_equal(got.ravel()[new_of_old], bfs_naive(adj, 3))


# ---------------------------------------------------------------- the kernel-1 loops (dist_cell)


PALLAS_CASES = {"pagerank": (lambda: scaled(random_undirected(130, 5, 12)), (0.85, 1e-5), None),
                "bfs": (lambda: random_undirected(150, 6, 13), (0,), 1.0),
                "sssp": (lambda: random_undirected(110, 6, 14, weighted=True), (0,), None)}


def _jax_pallas(mesh, kind):
    """JAX's ``dist_{kind}_pallas`` on ``PALLAS_CASES[kind]`` (interpret mode)
    where its native packer builds, else its XLA loop at the same cap."""
    from spla_tpu.pallas.cellpack_native import _native_lib

    make, args, values = PALLAS_CASES[kind]
    a = make()
    if _native_lib() is not None:
        cell = JP.shard_cell_spmv(JF.csr_from_scipy(a), S, mesh, cw=1024, values=values)
        return np.asarray(getattr(JP, f"dist_{kind}_pallas")(mesh, cell, *args))
    sc = JP.shard_csr_by_rows(JF.csr_from_scipy(a if values is None else (a != 0).astype(np.float32)), S, mesh)
    xla = {"pagerank": JP.dist_pagerank, "bfs": JP.dist_bfs, "sssp": JP.dist_sssp}[kind]
    caps = {} if kind == "pagerank" else {"frontier_cap": max(sc.mloc // 16, 32)}
    return np.asarray(xla(mesh, sc, *args, **caps))


# a child process: JAX's _pallas result of one kind, as a .npy on stdout
_PALLAS_CHILD = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, sys.argv[1])
import numpy as np
import test_torch_dist as T
np.save(sys.stdout.buffer, T._jax_pallas(T.JP.make_device_mesh(T.S), sys.argv[2]))
"""


class _PallasChildren:
    """The JAX ``_pallas`` result of each kind, each computed in a child
    process started with the module: their compiles (15 s each, most of it
    tracing under the GIL) run beside each other and beside this file's
    other tests.  ``self[kind]`` waits for that child."""

    def __init__(self):
        self.procs = {kind: subprocess.Popen([sys.executable, "-c", _PALLAS_CHILD, str(REPO / "tests"), kind],
                                             cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
                      for kind in PALLAS_CASES}
        self.got = {}

    def __getitem__(self, kind):
        if kind not in self.got:
            out, err = self.procs[kind].communicate(timeout=300)
            assert self.procs[kind].returncode == 0, err.decode()[-3000:]
            self.got[kind] = np.load(io.BytesIO(out))
        return self.got[kind]

    def close(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module", autouse=True)
def jax_pallas():
    children = _PallasChildren()
    yield children
    children.close()


OVERLAP_CASES = [("pagerank", None), *((kind, cap) for kind in ("bfs", "sssp") for cap in (None, 0, 4))]


@pytest.mark.parametrize("kind,frontier_cap", OVERLAP_CASES)
def test_dist_pallas_overlap_matches_jax(mesh, world, kind, frontier_cap):
    """The ``_overlap`` loops against the JAX package's XLA loops at the same
    cap (``dist_pagerank_overlap`` for PageRank), and against the port's own
    loop without the split."""
    make, args, values = PALLAS_CASES[kind]
    a = make()
    if kind == "pagerank":
        diag, off = JP.shard_csr_split_diag(JF.csr_from_scipy(a), S, mesh)
        want = np.asarray(JP.dist_pagerank_overlap(mesh, diag, off, *args))
        kwargs = {}
    else:
        sc = JP.shard_csr_by_rows(JF.csr_from_scipy(a), S, mesh)
        cap = max(sc.mloc // 16, 32) if frontier_cap is None else frontier_cap
        want = np.asarray((JP.dist_bfs if kind == "bfs" else JP.dist_sssp)(mesh, sc, 0, frontier_cap=cap))
        kwargs = {"frontier_cap": frontier_cap}
    name = f"dist_{kind}_pallas"
    got = stacked(world.run(J.pallas, f"{name}_overlap", coo_fields(a, split=True, values=values), *args, **kwargs))
    plain = stacked(world.run(J.pallas, name, coo_fields(a, values=values), *args, **kwargs))
    if kind == "bfs":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, plain)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-8)
        np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-8)


# ---------------------------------------------------------------- SpGEMM


def _stored(d, s=None):
    """Each rank's stored (row, col, value) of a result, from the port's
    numpy fields or (rank s of) a spla_tpu ShardedCsr."""
    if s is not None:
        d = {f: np.asarray(getattr(d, f))[s] for f in ("row_ids", "cols", "values", "nnz")}
    k = int(d["nnz"])
    return d["row_ids"][:k], d["cols"][:k], d["values"][:k]


@pytest.mark.parametrize("shape", ["square", "rectangular"])
def test_dist_mxm_matches_jax(mesh, world, shape):
    if shape == "square":
        a, b = random_undirected(117, 5, 7, weighted=True), random_undirected(117, 4, 8, weighted=True)
    else:
        a = sp.random(90, 140, density=0.06, random_state=1, dtype=np.float32).tocsr()
        b = sp.random(140, 75, density=0.08, random_state=2, dtype=np.float32).tocsr()
    As, Bs = (JP.shard_csr_by_rows(JF.csr_from_scipy(x), S, mesh) for x in (a, b))
    want = JP.dist_mxm(mesh, As, Bs, JOP.MULT_FLOAT, JOP.PLUS_FLOAT, 0.0)
    got = world.run(J.mxm, fields(As), fields(Bs), "MULT_FLOAT", "PLUS_FLOAT", 0.0)
    assert len({g["cols"].shape for g in got}) == 1  # one capacity on every rank
    for s, g in enumerate(got):
        for x, y in zip(_stored(g)[:2], _stored(want, s)[:2]):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(_stored(g)[2], _stored(want, s)[2], rtol=1e-5, atol=1e-6)
    assert world.run(J.caps, fields(As), fields(Bs))[0][0] == JP.count_dist_mxm_cap(As, Bs)


def test_pin_dist_mxm_truncation_reports_capacity(mesh, world):
    """With more entries than ``out_capacity`` the first ones in (row,
    column) order are stored and ``nnz`` is the capacity, as
    ``spla_tpu.parallel.dist_mxm`` clamps it (``dist_spgemm.py:181``) and as
    the port's single-card ``mxm`` does; ``spla_tpu.ops.mxm`` reports the
    uncut count (``tests/test_torch_mxm.py::test_mxm_out_capacity``)."""
    a = random_undirected(117, 5, 7, weighted=True)
    As = JP.shard_csr_by_rows(JF.csr_from_scipy(a), S, mesh)
    want = JP.dist_mxm(mesh, As, As, JOP.MULT_FLOAT, JOP.PLUS_FLOAT, 0.0, out_capacity=20)
    full = JP.dist_mxm(mesh, As, As, JOP.MULT_FLOAT, JOP.PLUS_FLOAT, 0.0)
    got = world.run(J.mxm, fields(As), fields(As), "MULT_FLOAT", "PLUS_FLOAT", 0.0, out_capacity=20)
    for s, g in enumerate(got):
        assert int(g["nnz"]) == int(np.asarray(want.nnz)[s]) == 20 < int(np.asarray(full.nnz)[s])
        w = {f: np.asarray(getattr(want, f))[s][:20] for f in ("row_ids", "cols", "values")}
        np.testing.assert_array_equal(g["row_ids"], w["row_ids"])
        np.testing.assert_array_equal(g["cols"], w["cols"])
        np.testing.assert_allclose(g["values"], w["values"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_dist_tc_matches_jax(mesh, world, dtype):
    a = random_undirected(96, 8, 9).astype(dtype)
    As = JP.shard_csr_by_rows(JF.csr_from_scipy(a), S, mesh)
    want = JP.dist_tc(mesh, As)
    assert world.run(J.tc, fields(As)) == [want] * S
    adj = [a.indices[a.indptr[i]:a.indptr[i + 1]].tolist() for i in range(a.shape[0])]
    from spla_tpu_torch.algorithms import tc_naive

    assert want == tc_naive(adj)


@pytest.mark.parametrize("products_cap", [None, 40])
def test_dist_mxmT_masked_reduce_matches_jax(mesh, world, products_cap):
    """A signed mask (the GTZERO select keeps half), f32 values, an init,
    and a ``products_cap`` that drops a step's later products."""
    rng = np.random.default_rng(2)
    a = random_undirected(80, 6, 3, weighted=True)
    mask = a.copy()
    mask.data = rng.choice([-1.0, 1.0], mask.nnz).astype(np.float32)
    Ms, As = (JP.shard_csr_by_rows(JF.csr_from_scipy(x), S, mesh) for x in (mask, a))
    want = JP.dist_mxmT_masked_reduce(mesh, Ms, As, As, JOP.MULT_FLOAT, JOP.PLUS_FLOAT, JOP.GTZERO_FLOAT, 1.5,
                                      products_cap=products_cap)
    got = world.run(J.mxmT_reduce, fields(Ms), fields(As), fields(As), "MULT_FLOAT", "PLUS_FLOAT",
                    "GTZERO_FLOAT", 1.5, products_cap)
    for g in got:
        assert g.dtype == want.dtype
        np.testing.assert_allclose(g, want, rtol=1e-5)
    assert world.run(J.caps, fields(Ms), fields(As))[0][1] == JP.count_dist_mxmT_cap(Ms, As)


def test_pin_dist_tc_int32_sum_wraps_on_the_cpu(mesh, world):
    """On CPU tensors the sum is taken in the value dtype, as the JAX
    package's is: int32 wraps past 2^31 (on the card kernel 4 sums in
    int64: ``tests/test_torch_cuda.py::test_pin_dist_tc_sums_in_int64_on_the_card``)."""
    a = random_undirected(60, 8, 6).astype(np.int32)
    a.data[:] = 30_000  # every product 9e8: the sum passes 2^31
    As = JP.shard_csr_by_rows(JF.csr_from_scipy(a), S, mesh)
    want = JP.dist_tc(mesh, As)
    got = world.run(J.tc, fields(As))
    from spla_tpu_torch.algorithms import tc_naive

    exact = tc_naive([a.indices[a.indptr[i]:a.indptr[i + 1]].tolist() for i in range(a.shape[0])]) * 30_000**2
    wrapped = (exact + (1 << 31)) % (1 << 32) - (1 << 31)
    assert exact > 1 << 31 and got == [want] * S and want == wrapped


def test_dist_mxmT_masked_reduce_folds_with_plus_only():
    with pytest.raises(NotImplementedError, match="PLUS only"):
        P.dist_mxmT_masked_reduce(None, None, None, None, None, JOP.MIN_FLOAT, None, 0)


# ---------------------------------------------------------------- worlds of other sizes


@pytest.mark.parametrize("size", [1, 2])
def test_small_worlds_on_a_graph_they_do_not_divide(size):
    """m = 257 (``__graft_entry__.py``'s dry run) on worlds of 1 and 2
    ranks, against the JAX package at the same S."""
    from __graft_entry__ import _small_graph

    As = _small_graph(n=257, deg=6, seed=1)
    jmesh = JP.make_device_mesh(size)
    sc = JP.shard_csr_by_rows(JF.csr_from_scipy(As), size, jmesh)
    scb = JP.shard_csr_by_rows(JF.csr_from_scipy((As != 0).astype(np.int32)), size, jmesh)
    want_p = np.asarray(JP.dist_pagerank(jmesh, sc, 0.85, 1e-3))
    want_v, want_stats = JP.dist_bfs(jmesh, scb, 0, frontier_cap=8, with_stats=True)
    with World(size, threads=1) as w:
        got_p = stacked(w.run(J.pagerank, fields(sc), 0.85, 1e-3))
        res = w.run(J.traversal, "bfs", fields(scb), 0, 8)
    np.testing.assert_allclose(got_p, want_p, rtol=1e-4, atol=1e-8)
    np.testing.assert_array_equal(stacked([r[0] for r in res]), np.asarray(want_v))
    assert all(r[1] == want_stats for r in res)


def test_small_graphs_stats_equal_the_recorded_jax_stats(mesh, world):
    """The stats that chip_smoke.py holds its 4-rank gloo world on the card
    to (``tools.dist_times.JAX_STATS_S4``) are the JAX package's at S = 4,
    and the port's on the CPU."""
    from spla_tpu_torch.tools import dist_times as DT
    from spla_tpu_torch.tools.graphs import random_graph, road_grid

    a = random_graph(DT.SMALL["n"], DT.SMALL["deg"])
    aw = a.copy()
    aw.data = np.random.default_rng(2).uniform(0.1, 2.0, a.nnz).astype(np.float32)
    want = {"bfs": JP.dist_bfs(mesh, JP.shard_csr_by_rows(JF.csr_from_scipy(a.astype(np.int32)), S, mesh), 0,
                               with_stats=True)[1],
            "sssp": JP.dist_sssp(mesh, JP.shard_csr_by_rows(JF.csr_from_scipy(aw.T.tocsr()), S, mesh), 0,
                                 with_stats=True)[1],
            "road_bfs": JP.dist_bfs(mesh, JP.shard_csr_by_rows(JF.csr_from_scipy(road_grid(DT.SMALL["road"])), S,
                                                               mesh), 0, with_stats=True)[1]}
    assert want == DT.JAX_STATS_S4
    assert world.run(J.small_stats) == [want] * S


# last in the file: the children computing JAX's side have had the rest of it to finish
@pytest.mark.parametrize("kind", list(PALLAS_CASES))
def test_dist_pallas_matches_jax_pallas(jax_pallas, world, kind):
    """Against JAX's own ``_pallas`` loop (interpret mode) where its native
    packer builds, else against its XLA loop at the same cap."""
    make, args, values = PALLAS_CASES[kind]
    want = jax_pallas[kind]
    got = stacked(world.run(J.pallas, f"dist_{kind}_pallas", coo_fields(make(), values=values), *args))
    if kind == "pagerank":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-8)
    elif kind == "bfs":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4)  # test_dist.py:216: the cell kernel's own fold order
