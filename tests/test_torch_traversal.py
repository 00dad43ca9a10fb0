"""spla_tpu_torch's traversal kernels (kernel 2, the push SpMV, and kernel 3,
the level update; their plain versions) against spla_tpu on the same inputs,
and the whole BFS level loop against spla_tpu's Pallas loop in interpret mode.

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
from spla_tpu_torch.kernels import level_update as K3, traversal as K2

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
