"""spla_tpu_torch's traversal kernels (kernel 2, the push SpMV, and kernel 3,
the level update; their plain versions, and those of the push levels that
fuse them) against spla_tpu on the same inputs, the push levels' degree
offsets against numpy, and the whole BFS level loop against spla_tpu's
Pallas loop in interpret mode.

Depths, hits, distances, counts and lists must match bitwise.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import spla_tpu.formats as JF
import spla_tpu.op as JOP
import spla_tpu.ops.spmv as JS

from spla_tpu_torch import Descriptor, algorithms as alg, formats as F, op as OP
from spla_tpu_torch.interop import from_spla_tpu, to_numpy
from spla_tpu_torch.kernels import frontier as KF, level_update as K3, traversal as K2

N = 300


def _directed(seed=0, n=N, deg=4):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, deg * n), rng.integers(0, n, deg * n)
    a = sp.coo_matrix((rng.uniform(0.1, 2.0, r.size).astype(np.float32), (r, c)),
                      shape=(n, n)).tocsr()
    a.sum_duplicates()
    return a


@pytest.mark.parametrize("k", [1, 20, 150])
def test_push_matches_pull_over_the_transpose(k):
    """Kernel 2 pushes a frontier list over CSR(A); spla_tpu pulls over
    CSR(Aᵀ) with the frontier as x's validity mask."""
    a = _directed(seed=k)
    JA = JF.csr_from_scipy(a, fill=np.float32(np.inf))
    JAt = JF.csr_transpose_host(JA)
    A = from_spla_tpu(JA, "cpu")
    rng = np.random.default_rng(k)
    front = np.sort(rng.choice(N, k, replace=False)).astype(np.int32)
    active = np.zeros(N, bool)
    active[front] = True
    x = rng.uniform(0, 5, N).astype(np.float32)

    want = JS.masked_spmv_structural(JAt, jnp.asarray(active))
    got = K2.spmv_push_structural(A, torch.from_numpy(front))
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))

    want, _ = JS.masked_spmv(JAt, jnp.asarray(x), lambda av, xv: xv + av, JOP.MIN_FLOAT,
                             np.float32(np.inf), x_valid=jnp.asarray(active))
    got = K2.spmv_push(A, torch.from_numpy(front), torch.from_numpy(x), OP.PLUS_FLOAT,
                       OP.MIN_FLOAT, np.inf)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def _fused_pattern_format(a):
    from spla_tpu.pallas.cellpack_native import _native_lib
    from spla_tpu.pallas.spmv import build_fused_cell_spmv_arrays

    if _native_lib() is None:
        pytest.skip("no native toolchain for spla_tpu's packer")
    coo = a.tocoo()
    return build_fused_cell_spmv_arrays(a.shape[0], a.shape[1], coo.row.astype(np.int32),
                                        coo.col.astype(np.int32), np.ones(coo.nnz, np.float32),
                                        cw=1024, pattern=True)


def test_bfs_level_update_matches_pallas():
    """Kernel 3 (BFS) against spla_tpu's bfs_level_update, interpret mode."""
    from spla_tpu.pallas.spmv import bfs_level_update

    fmt = _fused_pattern_format(_directed())
    R = fmt.n_row_blocks * 128
    rng = np.random.default_rng(3)
    hits = (rng.random((R, 128)) < 0.2).astype(np.float32)
    v = np.where(rng.random((R, 128)) < 0.5, 0, 2).astype(np.int32)
    front = ((v == 0) & (rng.random((R, 128)) < 0.1)).astype(np.float32)
    jv, jf, _, jcnt = bfs_level_update(fmt, jnp.asarray(hits), jnp.asarray(v), jnp.asarray(front),
                                       jnp.int32(3))
    tv, tf = torch.from_numpy(v.ravel()), torch.from_numpy(front.ravel() > 0)
    lst = torch.empty(tv.shape[0], dtype=torch.int32)
    cnt = torch.zeros(1, dtype=torch.int32)
    K3.bfs_level_update(torch.from_numpy(hits.ravel() > 0), tv, tf, 3, lst, cnt)
    np.testing.assert_array_equal(to_numpy(tv), np.asarray(jv).ravel())
    np.testing.assert_array_equal(to_numpy(tf), np.asarray(jf).ravel() > 0)
    assert int(cnt) == int(jcnt)
    np.testing.assert_array_equal(to_numpy(lst[: int(cnt)]), np.nonzero(np.asarray(jf).ravel())[0])


def test_sssp_level_update_matches_pallas():
    """Kernel 3 (SSSP) against spla_tpu's sssp_level_update: the feedback
    vector there is ``changed ? v' : +inf`` here."""
    from spla_tpu.pallas.spmv import sssp_level_update

    fmt = _fused_pattern_format(_directed())
    R = fmt.n_row_blocks * 128
    rng = np.random.default_rng(4)
    hits = np.where(rng.random((R, 128)) < 0.6, np.inf, rng.uniform(0, 4, (R, 128))).astype(np.float32)
    v = np.where(rng.random((R, 128)) < 0.4, np.inf, rng.uniform(0, 4, (R, 128))).astype(np.float32)
    jv, jfdb, _, jcnt = sssp_level_update(fmt, jnp.asarray(hits), jnp.asarray(v))
    tv = torch.from_numpy(v.ravel().copy())
    changed = torch.zeros(tv.shape[0], dtype=torch.bool)
    lst = torch.empty(tv.shape[0], dtype=torch.int32)
    cnt = torch.zeros(1, dtype=torch.int32)
    K3.sssp_level_update(torch.from_numpy(hits.ravel()), tv, changed, lst, cnt)
    np.testing.assert_array_equal(to_numpy(tv), np.asarray(jv).ravel())
    fdb = torch.where(changed, tv, torch.tensor(float("inf")))
    np.testing.assert_array_equal(to_numpy(fdb), np.asarray(jfdb).ravel())
    assert int(cnt) == int(jcnt)
    np.testing.assert_array_equal(to_numpy(lst[: int(cnt)]), np.nonzero(to_numpy(changed))[0])


def test_bfs_matches_the_pallas_level_loop(monkeypatch):
    """The whole TPU BFS loop (fused_spmv2d_adaptive + bfs_level_update_auto,
    the resident kernel gated off) against the port's BFS level loop in
    every mode."""
    import spla_tpu.pallas.spmv as SP
    from spla_tpu.algorithms import _bfs_kernel_pallas

    monkeypatch.setattr(SP, "RESIDENT_VMEM", 0)
    monkeypatch.setattr(alg, "RESIDENT_BYTES", 0)
    a = _directed(seed=7)
    a = ((a + a.T) > 0).astype(np.float32).tocsr()
    fmt = _fused_pattern_format(a)
    want = np.asarray(_bfs_kernel_pallas(fmt, jnp.int32(5)))
    A = F.csr_from_scipy(a.astype(np.int32), device="cpu")
    for d in (None, Descriptor(push_only=True), Descriptor(pull_only=True)):
        got = alg.bfs(A, 5, d, At=A).values
        np.testing.assert_array_equal(to_numpy(got), want)


def _padded(a, R):
    """a (n x n) as an R x R matrix whose extra vertices have no edges."""
    n = a.shape[0]
    indptr = np.concatenate([a.indptr, np.full(R - n, a.indptr[-1])])
    return sp.csr_matrix((a.data, a.indices, indptr), shape=(R, R))


def _state_after(kind, A, source, levels):
    """A run's state after ``levels`` push levels, by the plain versions."""
    S = (KF.bfs_state if kind == "bfs" else KF.sssp_state)(A, source)
    for _ in range(levels):
        (K2.bfs_push_level if kind == "bfs" else K2.sssp_push_level)(S)
        KF.read_count(S)
    return S


def test_bfs_push_level_matches_pallas():
    """Kernel 2's BFS push level (plain version) against spla_tpu's
    bfs_level_update, in interpret mode, applied to the push that spla_tpu
    pulls over the transpose from the same frontier: depths, frontier, count
    and list, and the list's degree offsets."""
    from spla_tpu.pallas.spmv import bfs_level_update

    a = _directed(seed=11)
    fmt = _fused_pattern_format(a)
    R = fmt.n_row_blocks * 128 * 128
    a = _padded(a, R)
    S = _state_after("bfs", F.csr_from_scipy(a, device="cpu"), 3, 2)
    lst = to_numpy(S.lists[S.level % 2, :S.k])
    assert S.k > 5
    active = np.zeros(R, bool)
    active[lst] = True
    hits = np.asarray(JS.masked_spmv_structural(JF.csr_transpose_host(JF.csr_from_scipy(a)),
                                                jnp.asarray(active)))
    v, front = to_numpy(S.v).copy(), to_numpy(S.mask).copy()
    jv, jf, _, jcnt = bfs_level_update(fmt, jnp.asarray(hits.reshape(-1, 128)),
                                       jnp.asarray(v.reshape(-1, 128)),
                                       jnp.asarray(front.reshape(-1, 128).astype(np.float32)),
                                       jnp.int32(S.level + 1))
    K2.bfs_push_level(S)
    assert KF.read_count(S) == int(jcnt)
    np.testing.assert_array_equal(to_numpy(S.v), np.asarray(jv).ravel())
    np.testing.assert_array_equal(to_numpy(S.mask), np.asarray(jf).ravel() > 0)
    got = to_numpy(S.lists[S.level % 2, :S.k])
    np.testing.assert_array_equal(np.sort(got), np.nonzero(np.asarray(jf).ravel())[0])
    deg = np.diff(a.indptr)[got]
    np.testing.assert_array_equal(to_numpy(S.eoff[S.level % 2, :S.k]), np.cumsum(deg) - deg)
    assert S.edges == deg.sum()


def test_sssp_push_level_matches_pallas():
    """Kernel 2's SSSP push level (plain version) against spla_tpu's
    sssp_level_update, in interpret mode, applied to spla_tpu's min-plus pull
    over the transpose of the same changed set: distances, changed set,
    count and list."""
    from spla_tpu.pallas.spmv import sssp_level_update

    a = _directed(seed=12)
    fmt = _fused_pattern_format(a)
    R = fmt.n_row_blocks * 128 * 128
    a = _padded(a, R)
    S = _state_after("sssp", F.csr_from_scipy(a, fill=np.float32(np.inf), device="cpu"), 4, 2)
    lst = to_numpy(S.lists[S.level % 2, :S.k])
    assert S.k > 5
    active = np.zeros(R, bool)
    active[lst] = True
    v = to_numpy(S.v).copy()
    JAt = JF.csr_transpose_host(JF.csr_from_scipy(a, fill=np.float32(np.inf)))
    hits, _ = JS.masked_spmv(JAt, jnp.asarray(v), lambda av, xv: xv + av, JOP.MIN_FLOAT,
                             np.float32(np.inf), x_valid=jnp.asarray(active))
    jv, jfdb, _, jcnt = sssp_level_update(fmt, jnp.asarray(hits).reshape(-1, 128),
                                          jnp.asarray(v.reshape(-1, 128)))
    K2.sssp_push_level(S)
    assert KF.read_count(S) == int(jcnt)
    np.testing.assert_array_equal(to_numpy(S.v), np.asarray(jv).ravel())
    fdb = torch.where(S.mask, S.v, torch.tensor(float("inf")))
    np.testing.assert_array_equal(to_numpy(fdb), np.asarray(jfdb).ravel())
    got = to_numpy(S.lists[S.level % 2, :S.k])
    np.testing.assert_array_equal(np.sort(got), np.nonzero(to_numpy(S.mask))[0])


@pytest.mark.parametrize("case", ["one vertex", "empty rows", "hub row", "mixed"])
def test_degree_offsets_match_numpy(case):
    """The push levels' plan: a list's degree offsets and edge count, against
    numpy, for a frontier of one vertex, rows with no entries (repeated
    offsets), a hub row, and all of them in one list."""
    rng = np.random.default_rng(13)
    n = 400
    deg = rng.integers(0, 6, n)
    deg[rng.choice(n, 40, replace=False)] = 0
    deg[17] = 5000
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    lst = {"one vertex": np.array([17]), "empty rows": np.flatnonzero(deg == 0)[:9],
           "hub row": np.array([3, 17, 4]), "mixed": rng.permutation(n)[:150]}[case].astype(np.int32)
    eoff, total = KF.degree_offsets(torch.from_numpy(indptr), torch.from_numpy(lst))
    want = deg[lst]
    np.testing.assert_array_equal(to_numpy(eoff), np.cumsum(want) - want)
    assert eoff.dtype == torch.int32 and total == want.sum()


def test_level_times_tool_runs_on_the_cpu():
    """tools/level_times.py end to end at its small sizes on the CPU: a row
    for each graph's runs, with the level loop's split and the kernels'
    times; the device fields are null there (not measured)."""
    from spla_tpu_torch.tools import level_times as LT

    rows = LT.main(["--device", "cpu", "--small", "--reps", "2", "--label", "t"])
    assert [(r["graph"], r["kind"]) for r in rows] == [
        ("road1024", "bfs"), ("road512", "sssp"), ("road3072", "bfs"), ("rand20", "bfs"),
        ("rand20", "sssp"), ("skewed", "bfs"), ("skewed", "sssp")]
    for r in rows:
        assert r["label"] == "t" and r["device"] == "cpu" and r["card"] is None
        assert r["levels"] == r["push"] + r["pull"] == r["host_syncs"] > 0
        assert len(r["walls_ms"]) == 3 and r["read_ms"] >= 0 and r["host_ms"] >= 0
        assert "device_busy_ms" not in r
        k = r["kernels"]
        assert k["frontier"] > 0 and k["frontier_edges"] >= 0
        for name in ("spmv_push MIN-plus", "spmv_push structural", "bfs_level_update", "sssp_level_update"):
            assert k[name]["graph_ms"] is None and k[name]["eager_ms"] > 0 and k[name]["host_us"] > 0
