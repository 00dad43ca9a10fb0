"""spla_tpu_torch's matrix ops, BSR products and builders against spla_tpu
on the same numpy inputs (carried across by ``interop.from_spla_tpu``), and
the whole op-layer chain of ``chip_smoke.py``'s ``ops`` slice at n = 1,000.

Tolerances: f32 PLUS folds (``m_reduce_by_row``/``_by_column``,
``v_reduce``) and the BSR products within rtol=1e-5, atol=1e-5, the fold
order differs; everything else (indices, nnz, capacity, int, uint,
MIN/MAX/FIRST and element-wise f32 results, every structure) bitwise.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import spla_tpu.formats as JF
import spla_tpu.op as JOP
import spla_tpu.ops as JOPS
from spla_tpu.containers import DenseVec as JDenseVec

import spla_tpu_torch.ops as OPS
from spla_tpu_torch import formats as F, op as OP
from spla_tpu_torch.containers import BsrMatrix, DenseVec
from spla_tpu_torch.interop import from_spla_tpu, to_numpy

NP_DTYPES = {"FLOAT": np.float32, "INT": np.int32, "UINT": np.uint32}
INF = np.float32(np.inf)


def same(got, want, float_plus=False):
    """Every field of a port container (or tensor, or tuple of them) equal to
    spla_tpu's: bitwise, or within the f32 PLUS tolerance for values."""
    if isinstance(want, tuple) and not isinstance(got, tuple):
        assert got == want
        return
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w, float_plus)
        return
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__
        for f in dataclasses.fields(want):
            same(getattr(got, f.name), getattr(want, f.name),
                 float_plus and f.name in ("value", "values", "blocks"))
        return
    if isinstance(want, int):
        assert got == want
        return
    g, w = to_numpy(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape, w.shape)
    if float_plus:
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(g, w)


def ops_of(name, tname):
    return getattr(JOP, f"{name}_{tname}"), getattr(OP, f"{name}_{tname}")


def _values(rng, tname, size):
    if tname == "FLOAT":
        return rng.uniform(-3, 3, size).astype(np.float32)
    if tname == "INT":
        return rng.integers(-9, 10, size).astype(np.int32)
    return rng.integers(0, 20, size).astype(np.uint32)


def mat(rng, tname, fill, shape=(30, 24), density=0.15, extra=4, empty_row=None, coo=False):
    """A spla_tpu CSR (or COO) matrix of random entries and the port's copy;
    ``extra`` padding slots; ``empty_row`` holds none; density 0 is empty."""
    m, n = shape
    k = int(density * m * n)
    flat = rng.choice(m * n, k, replace=False)
    r, c = flat // n, flat % n
    if empty_row is not None:
        r, c = r[r != empty_row], c[r != empty_row]
    vals = _values(rng, tname, r.size)
    build = JF.coo_from_entries if coo else JF.csr_from_entries
    j = build(shape, r, c, vals, fill=fill, dtype=NP_DTYPES[tname], capacity=r.size + extra)
    return j, from_spla_tpu(j, "cpu")


# (op, type, A's fill, B's fill): zero and non-zero fills, +inf with MIN
EWISE = [("PLUS", "INT", 0, 0), ("PLUS", "FLOAT", 0.0, 0.0), ("MIN", "FLOAT", INF, INF),
         ("MAX", "UINT", 0, 3), ("MINUS", "INT", 2, 0), ("FIRST", "FLOAT", 0.0, 0.0)]
MATS = ["csr-csr", "coo-csr capacity-above", "empty-csr"]


@pytest.mark.parametrize("inputs", MATS)
@pytest.mark.parametrize("case", EWISE, ids=lambda c: f"{c[0]}_{c[1]}_{c[2]}_{c[3]}")
def test_m_eadd_and_m_emult_match_spla_tpu(case, inputs):
    """Includes entries cancelling to the result's fill (PLUS INT), which
    both drop, and an out_capacity above the count."""
    name, tname, fa, fb = case
    rng = np.random.default_rng([EWISE.index(case), MATS.index(inputs)])
    ja, a = mat(rng, tname, fa, density=0 if inputs == "empty-csr" else 0.15, coo=inputs.startswith("coo"))
    jb, b = mat(rng, tname, fb)
    jop, op = ops_of(name, tname)
    cap = 500 if inputs.endswith("capacity-above") else None
    same(OPS.m_eadd(a, b, op, cap), JOPS.m_eadd(ja, jb, jop, cap))
    same(OPS.m_emult(a, b, op, cap), JOPS.m_emult(ja, jb, jop, cap))


def test_pin_merge_and_kron_truncate_to_nnz_equal_capacity():
    """The port's one difference from spla_tpu here: with more result entries
    than out_capacity, both store the first ones in (row, column) order,
    but the port's nnz is the capacity where spla_tpu reports the uncut
    count."""
    rng = np.random.default_rng(20)
    (ja, a), (jb, b) = mat(rng, "INT", 0), mat(rng, "INT", 0)
    cases = [(OPS.m_eadd(a, b, OP.PLUS_INT, 50), JOPS.m_eadd(ja, jb, JOP.PLUS_INT, 50)),
             (OPS.kron(a, b, OP.MULT_INT, 70), JOPS.kron(ja, jb, JOP.MULT_INT, 70))]
    for got, want in cases:
        assert int(want.nnz) > want.capacity == got.capacity
        assert int(got.nnz) == got.capacity
        same(got, dataclasses.replace(want, nnz=jnp.asarray(got.capacity, jnp.int32)))


# (op, type, init, fill, COO input): the scatter folds and, for BOR and LOR, the scan fold
REDUCE = [("PLUS", "FLOAT", 0.5, 0.0, False), ("MIN", "FLOAT", INF, INF, True),
          ("MAX", "INT", -100, 0, False), ("PLUS", "UINT", 3, 0, True), ("BOR", "INT", 0, 0, True),
          ("LOR", "FLOAT", 0.0, 0.0, False)]


@pytest.mark.parametrize("case", REDUCE, ids=lambda c: f"{c[0]}_{c[1]}_{'coo' if c[4] else 'csr'}")
def test_m_reduce_by_row_and_column_match_spla_tpu(case):
    name, tname, init, fill, coo = case
    ja, a = mat(np.random.default_rng(21), tname, fill, empty_row=3, coo=coo)
    jop, op = ops_of(name, tname)
    fp = case[:2] == ("PLUS", "FLOAT")
    same(OPS.m_reduce_by_row(a, op, init), JOPS.m_reduce_by_row(ja, jop, init), fp)
    same(OPS.m_reduce_by_column(a, op, init), JOPS.m_reduce_by_column(ja, jop, init), fp)


@pytest.mark.parametrize("case", [("IDENTITY", "FLOAT", 0.0, False), ("AINV", "INT", 5, False),
                                  ("BNOT", "UINT", 0, True), ("ABS", "FLOAT", INF, True)],
                         ids=lambda c: f"{c[0]}_{c[1]}_{'coo' if c[3] else 'csr'}")
def test_m_transpose_matches_spla_tpu(case):
    name, tname, fill, coo = case
    ja, a = mat(np.random.default_rng(22), tname, fill, coo=coo)
    jop, op = ops_of(name, tname)
    same(OPS.m_transpose(a, op), JOPS.m_transpose(ja, jop))


@pytest.mark.parametrize("cap", [None, 40, 2], ids=["default", "above", "below"])
def test_m_extract_row_and_column_match_spla_tpu(cap):
    """Rows and columns with entries, the empty row 3, and an out_capacity
    above and below their count (both packages clamp nnz to it)."""
    ja, a = mat(np.random.default_rng(23), "INT", 7, density=0.3, empty_row=3)
    jop, op = ops_of("AINV", "INT")
    for index in (0, 3, 29):
        same(OPS.m_extract_row(a, index, op, cap), JOPS.m_extract_row(ja, index, jop, cap))
    for index in (0, 5, 23):
        same(OPS.m_extract_column(a, index, op, cap), JOPS.m_extract_column(ja, index, jop, cap))
    same(OPS.m_extract_row(a, torch.tensor(5), op, cap), JOPS.m_extract_row(ja, 5, jop, cap))
    same(OPS.m_extract_column(a, torch.tensor(5), op, cap), JOPS.m_extract_column(ja, 5, jop, cap))


@pytest.mark.parametrize("case", [("MULT", "INT", 0, None), ("PLUS", "FLOAT", 1.0, 400),
                                  ("FIRST", "UINT", 0, None), ("MIN", "FLOAT", INF, None)],
                         ids=lambda c: f"{c[0]}_{c[1]}")
def test_kron_matches_spla_tpu(case):
    name, tname, fill, cap = case
    rng = np.random.default_rng(24)
    ja, a = mat(rng, tname, fill, shape=(6, 5), density=0.4, coo=True)
    jb, b = mat(rng, tname, fill, shape=(4, 7), density=0.3)
    jop, op = ops_of(name, tname)
    same(OPS.kron(a, b, op, cap), JOPS.kron(ja, jb, jop, cap))


def test_matrix_builders_and_coo_to_dense_match_spla_tpu():
    rows, cols, vals = [2, 0, 2, 1], [1, 3, 1, 0], [1, 2, 3, 4]
    for kw in ({}, {"reduce_fn": np.add, "capacity": 7}):
        got = F.coo_from_entries((3, 4), rows, cols, vals, fill=-1, dtype=np.int32, device="cpu", **kw)
        want = JF.coo_from_entries((3, 4), rows, cols, vals, fill=-1, dtype=np.int32, **kw)
        same(got, want)
        same(F.coo_to_dense(got), JF.coo_to_dense(want))
        same(F.csr_from_entries((3, 4), rows, cols, vals, fill=-1, dtype=np.int32, device="cpu", **kw),
             JF.csr_from_entries((3, 4), rows, cols, vals, fill=-1, dtype=np.int32, **kw))
    assert got.dtype == torch.int32
    with pytest.raises(ValueError):
        F.coo_from_entries((3, 4), rows, cols, vals, capacity=2, device="cpu")


# ---------------------------------------------------------------- BSR


def banded(n, half, seed, dtype=np.float32):
    """n x n band of half-bandwidth ``half``, values from a seed."""
    rng = np.random.default_rng(seed)
    offs = np.arange(-half, half + 1)
    r = np.repeat(np.arange(n), offs.size)
    c = r + np.tile(offs, n)
    keep = (c >= 0) & (c < n)
    r, c = r[keep], c[keep]
    vals = rng.uniform(0.5, 1.5, r.size) if dtype == np.float32 else rng.integers(-50, 50, r.size)
    return sp.csr_matrix((vals.astype(dtype), (r, c)), shape=(n, n))


@pytest.mark.parametrize("block,fill", [(32, 0.0), (64, 0.0), (16, 0.5)])
def test_bsr_from_csr_host_matches_spla_tpu(block, fill):
    a = sp.random(150, 130, density=0.05, random_state=31, dtype=np.float32, format="csr")
    ja = JF.csr_from_scipy(a, fill=fill)
    got = F.bsr_from_csr_host(from_spla_tpu(ja, "cpu"), block=block)
    assert isinstance(got, BsrMatrix) and got.block_shape == (-(-150 // block), -(-130 // block))
    same(got, JF.bsr_from_csr_host(ja, block=block))
    same(from_spla_tpu(JF.bsr_from_csr_host(ja, block=block), "cpu"), JF.bsr_from_csr_host(ja, block=block))


@pytest.mark.parametrize("case", ["f32 MULT", "f32 op_mul", "f32 DenseVec init", "i32 MULT", "fill 0.5"])
def test_bsr_spmv_matches_spla_tpu(case):
    """f32 within the PLUS tolerance; i32 bitwise; a fill of 0.5 makes the
    unstored elements of stored blocks count, in both packages; capacity 64
    leaves padding blocks."""
    dtype = np.int32 if case.startswith("i32") else np.float32
    a = banded(300, 3, 32, dtype)
    ja = JF.csr_from_scipy(a, fill=0.5 if case == "fill 0.5" else 0)
    jb = JF.bsr_from_csr_host(ja, block=32, capacity=64)
    b = from_spla_tpu(jb, "cpu")
    assert int(b.nnzb) < b.capacity
    x = np.random.default_rng(33).uniform(-1, 1, 300).astype(np.float32)
    if dtype == np.int32:
        x = np.random.default_rng(33).integers(-9, 9, 300).astype(np.int32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    if case == "f32 op_mul":
        got = OPS.bsr_spmv(b, xt, op_mul=OP.MINUS_FLOAT)
        want = JOPS.bsr_spmv(jb, xj, op_mul=JOP.MINUS_FLOAT)
    elif case == "f32 DenseVec init":
        got = OPS.bsr_spmv(b, DenseVec(xt, torch.tensor(0.0)), op_add=OP.PLUS_FLOAT, init=2.0)
        want = JOPS.bsr_spmv(jb, JDenseVec(xj, jnp.float32(0)), op_add=JOP.PLUS_FLOAT, init=2.0)
    else:
        got, want = OPS.bsr_spmv(b, xt), JOPS.bsr_spmv(jb, xj)
    same(got, want, float_plus=dtype == np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_bsr_spmm_matches_spla_tpu(dtype):
    a = sp.random(200, 150, density=0.08, random_state=5, dtype=np.float32, format="csr")
    if dtype == np.int32:
        a.data = np.random.default_rng(5).integers(-20, 20, a.nnz).astype(np.float32)
    ja = JF.csr_from_scipy(a.astype(dtype))
    jb = JF.bsr_from_csr_host(ja, block=64)
    X = np.random.default_rng(6).integers(-5, 5, (150, 17)).astype(dtype)
    same(OPS.bsr_spmm(from_spla_tpu(jb, "cpu"), torch.from_numpy(X)), JOPS.bsr_spmm(jb, jnp.asarray(X)),
         float_plus=dtype == np.float32)


def test_bsr_spmv_rejects_non_plus_accumulator():
    b = F.bsr_from_csr_host(F.csr_from_scipy(sp.identity(8, np.float32, format="csr"), device="cpu"), block=8)
    with pytest.raises(AssertionError, match="PLUS only"):
        OPS.bsr_spmv(b, torch.ones(8), op_add=OP.MIN_FLOAT)
    np.testing.assert_array_equal(OPS.bsr_spmv(b, torch.ones(8), op_add=OP.PLUS_FLOAT).numpy(), np.ones(8))


# ---------------------------------------------------------------- the whole slice


def ops_chain(pkg, m, A, B, K, u, v, d, d2, band, x, X):
    """The chain of chip_smoke.py's ops slice, written once for both
    packages (``pkg``: spla_tpu.ops or spla_tpu_torch.ops; ``m``: its op
    module); returns every result by name."""
    R = {}
    R["At"] = At = pkg.m_transpose(A, m.IDENTITY_FLOAT)
    R["sym"] = pkg.m_eadd(A, At, m.PLUS_FLOAT)
    R["recip"] = pkg.m_emult(A, At, m.MIN_FLOAT)
    R["out_deg"] = pkg.m_reduce_by_row(A, m.PLUS_FLOAT, 0.0)
    R["in_deg"] = pkg.m_reduce_by_column(A, m.PLUS_FLOAT, 0.0)
    R["row"] = pkg.m_extract_row(A, 17, m.IDENTITY_FLOAT)
    R["col"] = pkg.m_extract_column(A, 17, m.IDENTITY_FLOAT)
    R["kron"] = pkg.kron(K, B, m.MULT_FLOAT)
    R["eadd"] = pkg.v_eadd(u, v, m.PLUS_FLOAT)
    R["eadd_dense"] = pkg.v_eadd(u, d, m.MIN_FLOAT)
    R["emult"] = pkg.v_emult(u, v, m.MULT_FLOAT)
    R["map"] = pkg.v_map(R["eadd"], m.AINV_FLOAT)
    R["assign"] = pkg.v_assign_masked(d, u, 0.25, m.SECOND_FLOAT, m.GTZERO_FLOAT)
    R["fdb"] = pkg.v_eadd_fdb(d, v, m.MIN_FLOAT)
    R["fdb_dense"] = pkg.v_eadd_fdb(d, d2, m.MIN_FLOAT)
    R["reduce"] = pkg.v_reduce(0.0, R["eadd"], m.PLUS_FLOAT)
    R["reduce_dense"] = pkg.v_reduce(0.0, d, m.PLUS_FLOAT)
    R["count"] = pkg.v_count_mf(R["emult"])
    R["count_dense"] = pkg.v_count_mf(d)
    R["spmv"] = pkg.bsr_spmv(band, x)
    R["spmm"] = pkg.bsr_spmm(band, X)
    return R


def test_whole_ops_slice_matches_spla_tpu():
    """n = 1,000: the graph, its transpose, union, reciprocal edges, degrees,
    a hub's row and column, a kron, the vector chain and the BSR products,
    every result compared."""
    n = 1000
    rng = np.random.default_rng(40)
    a = sp.random(n, n, density=0.008, random_state=41, dtype=np.float32).toarray()
    a += sp.random(n, n, density=0.002, random_state=42, dtype=np.float32).toarray().T
    a[17, rng.choice(n, 60, replace=False)] = 2.0  # a hub row and column
    a[rng.choice(n, 60, replace=False), 17] = 3.0
    a = sp.csr_matrix(a)
    k = sp.random(32, 32, density=0.1, random_state=43, dtype=np.float32, format="csr")
    b = sp.csr_matrix((rng.uniform(0.5, 1.5, 32).astype(np.float32),
                       (rng.integers(0, 32, 32), rng.integers(0, 32, 32))), shape=(32, 32))
    idx_u, idx_v = rng.choice(n, 200, replace=False), rng.choice(n, 200, replace=False)
    dvals = rng.uniform(-1, 1, n).astype(np.float32)
    dvals[rng.random(n) < 0.3] = 0
    jin = dict(
        A=JF.csr_from_scipy(a), B=JF.csr_from_scipy(b), K=JF.csr_from_scipy(k),
        u=JF.sparse_vec_from_entries(n, idx_u, rng.uniform(-1, 1, 200), dtype=np.float32),
        v=JF.sparse_vec_from_entries(n, idx_v, rng.uniform(-1, 1, 200), dtype=np.float32),
        d=JDenseVec(jnp.asarray(dvals), jnp.float32(0)),
        d2=JDenseVec(jnp.asarray(rng.uniform(-1, 1, n).astype(np.float32)), jnp.float32(0)),
        band=JF.bsr_from_csr_host(JF.csr_from_scipy(banded(n, 20, 44)), block=64),
        x=jnp.asarray(rng.uniform(-1, 1, n).astype(np.float32)),
        X=jnp.asarray(rng.uniform(-1, 1, (n, 8)).astype(np.float32)))
    tin = {key: (torch.from_numpy(np.array(val)) if key in ("x", "X") else from_spla_tpu(val, "cpu"))
           for key, val in jin.items()}
    want = ops_chain(JOPS, JOP, **jin)
    got = ops_chain(OPS, OP, **tin)
    for key in want:
        fp = key in ("out_deg", "in_deg", "reduce", "reduce_dense", "spmv", "spmm")
        same(got[key], want[key], float_plus=fp)
    assert int(got["recip"].nnz) > 0 and int(got["col"].nnz) >= 60


def test_ops_times_inputs_and_calls_at_a_cut_size(monkeypatch):
    """tools/ops_times.py, which builds chip_smoke.py's ops slice, at a cut
    size on the CPU: every call runs, the union equals scipy's A + Aᵀ, and
    every call's byte count is positive."""
    from spla_tpu_torch.tools import ops_times as OT
    for name, value in dict(N=1 << 12, N_VEC_NNZ=1 << 8, N_KRON=1 << 6, N_KRON_B=32, N_BAND=1 << 10,
                            HALF_BAND=8, BLOCK=32, SPMM_COLS=4).items():
        monkeypatch.setattr(OT, name, value)
    I = OT.build_inputs("cpu")
    I["At"] = OPS.m_transpose(I["A"], OP.IDENTITY_FLOAT)
    I["band"] = F.bsr_from_csr_host(I["Band"], block=OT.BLOCK)
    R = {name: call() for name, call in OT.calls(I).items()}
    a = I["A_sp"]
    ref = (a + a.T).tocsr()
    ref.sort_indices()
    got = R["m_eadd"]
    np.testing.assert_array_equal(got.indptr.numpy(), ref.indptr)
    np.testing.assert_array_equal(got.cols[:ref.nnz].numpy(), ref.indices)
    np.testing.assert_array_equal(got.values[:ref.nnz].numpy(), ref.data)
    work = OT.work(I, R)
    assert set(work) == set(R) and all(nbytes > 0 for nbytes, _ in work.values())
