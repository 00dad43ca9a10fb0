"""spla_tpu_torch's masked SpGEMM-T, triangle counting and their helpers
against spla_tpu on the same numpy inputs, and kernels 4 and 5's plain
versions against the TPU kernels they replace (Pallas interpret mode).

Tolerances: f32 PLUS results within rtol=1e-5, atol=1e-5 (the summation
order differs); everything else bitwise.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import spla_tpu.algorithms as JALG
import spla_tpu.formats as JF
import spla_tpu.op as JOP
import spla_tpu.ops as JOPS
from spla_tpu.containers import CooMatrix as JCoo
from spla_tpu.ops.spgemm import _expand_schedule as j_expand_schedule
from spla_tpu.utils.search import bisect_steps as j_bisect_steps, rowwise_find as j_rowwise_find

from spla_tpu_torch import algorithms as alg, formats as F, op as OP
from spla_tpu_torch.interop import from_spla_tpu, to_numpy
from spla_tpu_torch.kernels import mxmt as K
from spla_tpu_torch.ops import matrix as TM, spgemm as TG
from spla_tpu_torch.utils.primitives import expand_schedule
from spla_tpu_torch.utils.search import bisect_steps, rowwise_find

N = 60
NP_DTYPES = {"FLOAT": np.float32, "INT": np.int32, "UINT": np.uint32}


def _close(got, want, float_plus=False):
    got, want = to_numpy(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if float_plus:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, equal_nan=True)
    else:
        np.testing.assert_array_equal(got, want)


def _csr_same(got, want, float_plus=False):
    assert got.shape == tuple(want.shape)
    for f in ("indptr", "cols", "row_ids", "nnz"):
        _close(getattr(got, f), getattr(want, f))
    _close(got.values, want.values, float_plus)
    _close(got.fill, want.fill)


def _values(rng, tname, size):
    if tname == "FLOAT":
        return rng.uniform(-2, 2, size).astype(np.float32)
    if tname == "INT":
        return rng.integers(-5, 6, size).astype(np.int32)
    return rng.integers(0, 10, size).astype(np.uint32)


def _random_csr(rng, n, deg, tname, empty_row=None, dup_rows=0):
    """n x n CSR with rows sorted by column; ``dup_rows`` rows repeat some
    of their columns (kept as separate entries); ``empty_row`` has none."""
    rows, cols = rng.integers(0, n, deg * n), rng.integers(0, n, deg * n)
    if empty_row is not None:
        keep = rows != empty_row
        rows, cols = rows[keep], cols[keep]
    a = sp.coo_matrix((np.ones(rows.size), (rows, cols)), shape=(n, n)).tocsr()
    a.sum_duplicates()
    r, c = a.tocoo().row, a.tocoo().col
    for i in rng.choice(np.unique(r), dup_rows, replace=False):  # repeat 2 columns of row i
        extra = c[r == i][:2]
        r, c = np.concatenate([r, np.full(extra.size, i)]), np.concatenate([c, extra])
    order = np.lexsort((c, r))
    r, c = r[order], c[order]
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=n), out=indptr[1:])
    return sp.csr_matrix((_values(rng, tname, r.size), c, indptr), shape=(n, n))


def _mask_csr(rng, n, tname):
    """A mask pattern with row 3 empty; values from {-1, 1, 2} ({0, 1, 2}
    for UINT), so GTZERO deselects some entries."""
    m = _random_csr(rng, n, 4, "FLOAT", empty_row=3)
    choices = [0, 1, 2] if tname == "UINT" else [-1, 1, 2]
    m.data = rng.choice(choices, m.nnz).astype(NP_DTYPES[tname])
    return m


def _operands(tname, seed, fill):
    rng = np.random.default_rng(seed)
    dt = NP_DTYPES[tname]
    a = _random_csr(rng, N, 5, tname, empty_row=7)
    b = _random_csr(rng, N, 5, tname, dup_rows=6)
    m = _mask_csr(rng, N, tname)
    fillv = dt(fill)
    # capacities above nnz: the pads must never count
    js = [JF.csr_from_scipy(x, fill=fillv, capacity=x.nnz + 9) for x in (m, a, b)]
    return js, [from_spla_tpu(j, "cpu") for j in js]


SEMIRINGS = [
    ("MULT", "PLUS", "FLOAT", 0, False),
    ("PLUS", "MIN", "FLOAT", np.inf, False),
    ("MIN", "MAX", "FLOAT", -np.inf, False),
    ("SECOND", "MIN", "FLOAT", np.inf, False),
    ("MULT", "PLUS", "INT", 0, False),
    ("FIRST", "MAX", "INT", np.iinfo(np.int32).min, False),
    ("MULT", "BOR", "INT", 0, False),  # no scatter kind: the segmented-scan fold
    ("MULT", "PLUS", "UINT", 0, False),
    ("MULT", "PLUS", "INT", 0, True),  # struct_only
]


@pytest.mark.parametrize("mul,add,tname,init,struct_only", SEMIRINGS)
def test_mxmT_masked_matches_spla_tpu(mul, add, tname, init, struct_only):
    """The public mxmT_masked on spla_tpu's XLA path and the port's plain
    path: a mask that GTZERO partly deselects, an empty row in A and in
    the mask, capacities above nnz, duplicate columns in B's rows."""
    (jm, ja, jb), (tm, ta, tb) = _operands(tname, 11, init)
    jt, tt = getattr(JOP, tname), getattr(OP, tname)
    jops = (JOP.lookup(mul, jt), JOP.lookup(add, jt), JOP.lookup("GTZERO", jt))
    tops = (OP.lookup(mul, tt), OP.lookup(add, tt), OP.lookup("GTZERO", tt))
    want = JOPS.mxmT_masked(jm, ja, jb, *jops, init, struct_only=struct_only)
    got = TG.mxmT_masked(tm, ta, tb, *tops, init, struct_only=struct_only)
    assert int(want.nnz) > 0
    _csr_same(got, want, float_plus=tname == "FLOAT" and add == "PLUS")


def test_mxmT_masked_capacities_and_empty_mask():
    """out_capacity above the result, a products_cap that truncates (spla_tpu
    drops the later slots; so does the plain path), and a mask with nnz 0."""
    (jm, ja, jb), (tm, ta, tb) = _operands("INT", 12, 0)
    jops = (JOP.MULT_INT, JOP.PLUS_INT, JOP.GTZERO_INT)
    tops = (OP.MULT_INT, OP.PLUS_INT, OP.GTZERO_INT)
    cap = jm.capacity + 20
    _csr_same(TG.mxmT_masked(tm, ta, tb, *tops, 0, out_capacity=cap),
              JOPS.mxmT_masked(jm, ja, jb, *jops, 0, out_capacity=cap))
    half = TG.count_mxmT_products(tm, tb) // 2
    _csr_same(TG.mxmT_masked(tm, ta, tb, *tops, 0, products_cap=half),
              JOPS.mxmT_masked(jm, ja, jb, *jops, 0, products_cap=half))
    je = JF.csr_from_scipy(sp.csr_matrix((N, N), dtype=np.int32), capacity=4)
    te = from_spla_tpu(je, "cpu")
    got = TG.mxmT_masked(te, ta, tb, *tops, 0)
    _csr_same(got, JOPS.mxmT_masked(je, ja, jb, *jops, 0))
    assert int(got.nnz) == 0
    assert int(TG.mxmT_masked_reduce(te, ta, tb, OP.MULT_INT, OP.GTZERO_INT)) == 0


def test_plain_versions_split_the_mask_into_ranges(monkeypatch):
    """With a small PRODUCT_CHUNK the plain versions expand the mask in
    several ranges of whole entries; results do not change."""
    (_, _, _), (tm, ta, tb) = _operands("FLOAT", 13, np.inf)
    sel = tm.valid_mask()
    one = K.mxmt_masked_plain(tm, ta, tb, OP.PLUS_FLOAT, OP.MIN_FLOAT, np.inf, sel)
    total = K.mxmt_reduce_plain(tm, ta, tb, OP.MULT_FLOAT, sel)
    monkeypatch.setattr(K, "PRODUCT_CHUNK", 17)
    deg = torch.where(sel, (tb.indptr[1:] - tb.indptr[:-1])[tm.cols.long().clamp(0, N - 1)], 0)
    ranges = K._entry_ranges(deg.long())
    assert len(ranges) > 5 and ranges[-1][1] == tm.capacity
    assert sum(r[2] for r in ranges) == TG.count_mxmT_products(tm, tb)
    many = K.mxmt_masked_plain(tm, ta, tb, OP.PLUS_FLOAT, OP.MIN_FLOAT, np.inf, sel)
    for a, b in zip(one, many):
        _close(a, to_numpy(b))
    _close(K.mxmt_reduce_plain(tm, ta, tb, OP.MULT_FLOAT, sel), to_numpy(total), True)


def _pallas_inputs(a, b, mcoo):
    from spla_tpu.pallas.mxmt import pairs_available

    if not pairs_available():
        pytest.skip("no native toolchain for spla_tpu's job builder")
    return (mcoo.row.astype(np.int32), mcoo.col.astype(np.int32),
            a.indptr.astype(np.int32), a.indices.astype(np.int32), a.data.astype(np.float32),
            b.indptr.astype(np.int32), b.indices.astype(np.int32), b.data.astype(np.float32))


def _port_operands(a, b, mcoo):
    n = a.shape[0]
    mask = sp.csr_matrix((np.ones(mcoo.nnz, np.float32), (mcoo.row, mcoo.col)), shape=(n, n))
    ta, tb, tm = (F.csr_from_scipy(x, device="cpu") for x in (a, b, mask))
    return tm, ta, tb


@pytest.mark.parametrize("add", ["PLUS", "MIN"])
def test_kernel5_plain_matches_pallas_job_partials(add):
    """Kernel 5's plain version against pallas_mxmT_job_partials in
    interpret mode, its job partials folded per mask entry (as
    tests/test_pallas.py does)."""
    from spla_tpu.pallas.mxmt import pallas_mxmT_job_partials

    n = 150
    a = sp.random(n, n, density=0.08, random_state=51, dtype=np.float32).tocsr()
    a.sort_indices()
    mcoo = sp.random(n, n, density=0.05, random_state=52).tocsr().tocoo()
    inputs = _pallas_inputs(a, a, mcoo)
    ident = 0.0 if add == "PLUS" else np.inf
    partials, seg, njr = pallas_mxmT_job_partials(
        *inputs, op_add=jnp.add if add == "PLUS" else jnp.minimum, identity=ident)
    want = np.full(mcoo.nnz, ident, np.float32)
    (np.add if add == "PLUS" else np.minimum).at(want, seg[:njr], np.asarray(partials)[:njr])
    tm, ta, tb = _port_operands(a, a, mcoo)
    out, has = K.mxmt_masked_plain(tm, ta, tb, OP.MULT_FLOAT, getattr(OP, f"{add}_FLOAT"), ident,
                                   tm.valid_mask())
    dense = a.toarray() @ a.toarray().T
    assert bool(has.any()) and not bool(has.all())
    _close(has, (a.astype(bool) @ a.astype(bool).T).toarray()[mcoo.row, mcoo.col])
    _close(out, want, float_plus=add == "PLUS")
    if add == "PLUS":
        np.testing.assert_allclose(to_numpy(out), dense[mcoo.row, mcoo.col], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", ["general", "heavy_rows"])
def test_kernel4_plain_matches_pallas_reduce(shape):
    """Kernel 4's plain version against pallas_mxmT_reduce in interpret mode:
    a general masked A·Bᵀ and rows of ~80 entries (the TPU's chunk
    staircase)."""
    from spla_tpu.pallas.mxmt import pallas_mxmT_reduce

    if shape == "general":
        n = 300
        a = sp.random(n, n, density=0.05, random_state=21, dtype=np.float32).tocsr()
        b = sp.random(n, n, density=0.06, random_state=22, dtype=np.float32).tocsr()
        mcoo = sp.random(n, n, density=0.04, random_state=23, dtype=np.float32).tocsr().tocoo()
    else:
        n = 200
        d = (np.random.default_rng(41).random((n, n)) < 0.4).astype(np.float32)
        a = b = sp.csr_matrix(d)
        mcoo = a.tocoo()
    a.sort_indices()
    b.sort_indices()
    want = pallas_mxmT_reduce(*_pallas_inputs(a, b, mcoo))
    tm, ta, tb = _port_operands(a, b, mcoo)
    got = K.mxmt_reduce_plain(tm, ta, tb, OP.MULT_FLOAT, tm.valid_mask())
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    dense = a.toarray().astype(np.float64) @ b.toarray().T
    np.testing.assert_allclose(float(got), dense[mcoo.row, mcoo.col].sum(), rtol=1e-9)


def _tc_graph(seed, n=200, deg=6):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, n * deg // 2), rng.integers(0, n, n * deg // 2)
    keep = r != c
    a = sp.coo_matrix((np.ones(2 * int(keep.sum()), np.float32),
                       (np.concatenate([r[keep], c[keep]]), np.concatenate([c[keep], r[keep]]))),
                      shape=(n, n)).tocsr()
    a.sum_duplicates()
    a.data[:] = 1.0
    return a


@pytest.mark.parametrize("values", ["pattern", "valued", "signed"])
def test_tc_matches_spla_tpu_and_tc_naive(values):
    """tc on a 0/1 pattern (structural path), on values in {1, 2, 3} and on
    values in {-1, 1, 2} (GTZERO deselects mask entries)."""
    a = _tc_graph(31).astype(np.int32)
    rng = np.random.default_rng(32)
    if values == "valued":
        a.data = rng.integers(1, 4, a.nnz).astype(np.int32)
    elif values == "signed":
        a.data = rng.choice([-1, 1, 2], a.nnz).astype(np.int32)
    JA = JF.csr_from_scipy(a, capacity=a.nnz + 5)
    got = alg.tc(from_spla_tpu(JA, "cpu"))
    assert isinstance(got, int)
    assert got == JALG.tc(JA)
    adj = [list(a.indices[a.indptr[i]:a.indptr[i + 1]]) for i in range(a.shape[0])]
    if values == "pattern":
        assert got == alg.tc_naive(adj) == JALG.tc_naive(adj) == int(a.multiply(a @ a).sum())
        assert got > 0
    else:  # the masked sum of A·Aᵀ over the mask entries GTZERO keeps
        d = a.toarray().astype(np.int64)
        assert got == int(((d @ d.T) * (d > 0)).sum())


@pytest.mark.parametrize("values", ["pattern", "valued"])
def test_tc_on_uint_values_matches_spla_tpu(values):
    """tc on a UINT graph takes UINT's MULT, PLUS and GTZERO (unsigned
    compares; on the card, kernel 4's u32 instance), and equals spla_tpu's
    tc and the int64 masked sum: a pattern, and values in {1, 2, 3}."""
    a = _tc_graph(34).astype(np.uint32)
    if values == "valued":
        a.data = np.random.default_rng(35).integers(1, 4, a.nnz).astype(np.uint32)
    JA = JF.csr_from_scipy(a, capacity=a.nnz + 5)
    got = alg.tc(from_spla_tpu(JA, "cpu"))
    d = a.toarray().astype(np.int64)
    assert got == JALG.tc(JA) == int(((d @ d.T) * (d > 0)).sum()) > 0


def _in_store(owner, tensors):
    """The fact of ``owner`` on ``tensors`` in the store of derived facts
    (``formats.derived``); fails if it was never built."""
    def unbuilt():
        raise AssertionError(f"no {owner.__name__} fact in the store")
    return F.derived(owner, tensors, unbuilt)


def test_tc_float_values_and_pattern_cache():
    a = _tc_graph(33)
    JA = JF.csr_from_scipy(a)
    A = from_spla_tpu(JA, "cpu")
    assert alg.tc(A) == JALG.tc(JA) == int(a.multiply(a @ a).sum())
    assert _in_store(alg._is_pattern, (A.values, A.nnz)) is True
    aw = a.copy()
    aw.data = np.random.default_rng(34).uniform(0.5, 2.0, a.nnz).astype(np.float32)
    JW = JF.csr_from_scipy(aw)
    W = from_spla_tpu(JW, "cpu")
    assert alg.tc(W) == JALG.tc(JW)
    assert _in_store(alg._is_pattern, (W.values, W.nnz)) is False


def test_coo_to_csr_and_csr_to_dense_match_spla_tpu():
    rng = np.random.default_rng(7)
    a = _random_csr(rng, 40, 3, "FLOAT", empty_row=39)
    JA = JF.csr_from_scipy(a, fill=np.float32(-1), capacity=a.nnz + 6)
    A = from_spla_tpu(JA, "cpu")
    _close(F.csr_to_dense(A), JF.csr_to_dense(JA))
    jc = JF.csr_to_coo(JA)
    tc_ = F.csr_to_coo(A)
    for f in ("rows", "cols", "values", "nnz"):
        _close(getattr(tc_, f), getattr(jc, f))
    # nnz below the stored count: indptr clamps to it
    jcut = JCoo(shape=jc.shape, rows=jc.rows, cols=jc.cols, values=jc.values,
                nnz=jnp.int32(a.nnz - 5), fill=jc.fill)
    for jcoo in (jc, jcut):
        got = F.coo_to_csr(from_spla_tpu(jcoo, "cpu"))
        want = JF.coo_to_csr(jcoo)
        for f in ("indptr", "cols", "values", "row_ids", "nnz"):
            _close(getattr(got, f), getattr(want, f))


def test_rowwise_find_and_bisect_steps_match_spla_tpu():
    """Lower-bound bisection: with duplicate columns in a row, the first
    one matches; missing keys and empty windows are not found."""
    flat = np.array([1, 3, 3, 3, 7, 2, 2, 9, 4, 5, 5, 6], np.int32)
    lo = np.array([0, 0, 0, 0, 5, 5, 8, 8, 8, 12, 4], np.int32)
    hi = np.array([5, 5, 5, 5, 8, 8, 12, 12, 12, 12, 4], np.int32)
    keys = np.array([3, 7, 4, 0, 2, 9, 5, 6, 8, 1, 7], np.int32)
    for steps in (j_bisect_steps(5), 32):
        jp, jf = j_rowwise_find(jnp.asarray(flat), jnp.asarray(lo), jnp.asarray(hi),
                                jnp.asarray(keys), steps=steps)
        tp, tf = rowwise_find(torch.from_numpy(flat), torch.from_numpy(lo), torch.from_numpy(hi),
                              torch.from_numpy(keys), steps=steps)
        _close(tf, jf)
        _close(tp[tf], np.asarray(jp)[np.asarray(jf)])
    assert to_numpy(tp).tolist()[:2] == [1, 4]
    for w in (0, 1, 2, 3, 7, 8, 1000, 1 << 20):
        assert bisect_steps(w) == j_bisect_steps(w)


def test_expand_schedule_matches_spla_tpu():
    deg = np.array([3, 0, 2, 0, 0, 4, 1], np.int32)
    valid = np.array([1, 1, 1, 1, 0, 1, 0], bool)
    for cap in (10, 14, 6):
        want = j_expand_schedule(jnp.asarray(deg), jnp.asarray(valid), cap)
        got = expand_schedule(torch.from_numpy(deg), torch.from_numpy(valid), cap)
        for g, w in zip(got, want):
            _close(g, w)


@pytest.mark.parametrize("tname,opname", [("FLOAT", "PLUS"), ("INT", "PLUS"), ("INT", "MAX"),
                                          ("INT", "BOR")])
def test_m_reduce_matches_spla_tpu(tname, opname):
    rng = np.random.default_rng(8)
    a = _random_csr(rng, 30, 3, tname)
    JA = JF.csr_from_scipy(a, capacity=a.nnz + 3)
    jop, top = JOP.lookup(opname, getattr(JOP, tname)), OP.lookup(opname, getattr(OP, tname))
    want = JOPS.m_reduce(1, JA, jop).value
    got = TM.m_reduce(1, from_spla_tpu(JA, "cpu"), top).value
    _close(got, want, float_plus=tname == "FLOAT")


def test_product_counts_match_spla_tpu():
    (jm, ja, jb), (tm, ta, tb) = _operands("FLOAT", 14, 0)
    assert TG.count_mxmT_products(tm, tb) == JOPS.count_mxmT_products(jm, jb) > 0
    assert TG.count_mxm_products(ta, tb) == JOPS.count_mxm_products(ja, jb) > 0


def test_dispatch_stats_on_cpu_take_the_torch_path():
    (_, _, _), (tm, ta, tb) = _operands("FLOAT", 15, 0)
    before = dict(TG.DISPATCH_STATS)
    TG.mxmT_masked(tm, ta, tb, OP.MULT_FLOAT, OP.PLUS_FLOAT, OP.GTZERO_FLOAT, 0.0)
    TG.mxmT_masked_reduce(tm, ta, tb, OP.MULT_FLOAT, OP.GTZERO_FLOAT)
    assert TG.DISPATCH_STATS["mxmT_torch"] == before["mxmT_torch"] + 2
    assert TG.DISPATCH_STATS["mxmT_kernel"] == before["mxmT_kernel"]


def test_reduce_equals_the_sum_of_mxmT_masked():
    """mxmT_masked_reduce is the sum of mxmT_masked's values (i32 bitwise;
    f32 against a float64 dense product)."""
    (_, _, _), (tm, ta, tb) = _operands("INT", 16, 0)
    r = TG.mxmT_masked(tm, ta, tb, OP.MULT_INT, OP.PLUS_INT, OP.GTZERO_INT, 0)
    total = TG.mxmT_masked_reduce(tm, ta, tb, OP.MULT_INT, OP.GTZERO_INT)
    assert total.dtype == torch.int64
    assert int(total) == int(TM.m_reduce(0, r, OP.PLUS_INT).value)
    hits = TG.mxmT_masked_reduce(tm, ta, tb, OP.MULT_INT, OP.GTZERO_INT, struct_only=True)
    ones = TG.mxmT_masked(tm, ta, tb, OP.MULT_INT, OP.PLUS_INT, OP.GTZERO_INT, 0, struct_only=True)
    assert hits.dtype == torch.int64 and int(hits) == int(ones.values[: int(ones.nnz)].sum())


# ---------------------------------------------------------------- kernels 4 and 5's plan


def _csr_kept(n, rows, cols, vals, extra=9):
    """n x n CSR on the CPU of the given entries, duplicates kept, rows
    sorted by column, with ``extra`` capacity beyond nnz."""
    order = np.lexsort((cols, rows))
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    a = sp.csr_matrix((vals[order], cols[order], indptr), shape=(n, n))
    return F.csr_from_scipy(a, capacity=a.nnz + extra, device="cpu")


def _plan_operands(seed=61, n=300):
    """A, B and a mask on n vertices built to reach each branch of the plan
    and of the kernels: B's row 5 holds 2,500 entries (duplicate columns,
    two HUB_CHUNK chunks) and row 6 holds 300 (one chunk); A's row 9 holds
    280 distinct columns (above A_STAGE); mask row 3 is empty, row 11 holds
    100 entries (more than a window), and column 5 and row 9 are reached; values
    in {-1, 1, 2}, so GTZERO deselects some entries; capacities above nnz."""
    rng = np.random.default_rng(seed)

    def csr(rows, cols):
        return _csr_kept(n, rows, cols, rng.choice([-1, 1, 2], rows.size).astype(np.int32))

    ar = np.concatenate([rng.integers(0, n, 4 * n), np.full(280, 9)])
    ac = np.concatenate([rng.integers(0, n, 4 * n), rng.choice(n, 280, replace=False)])
    br = np.concatenate([rng.integers(0, n, 4 * n), np.full(2500, 5), np.full(300, 6)])
    bc = np.concatenate([rng.integers(0, n, 4 * n), rng.integers(0, n, 2800)])
    mr = np.concatenate([rng.integers(0, n, 3 * n), np.full(100, 11), rng.integers(0, n, 40), np.full(40, 9)])
    mc = np.concatenate([rng.integers(0, n, 3 * n), rng.choice(n, 100, replace=False), np.full(40, 5),
                         rng.integers(0, n, 40)])
    keep = mr != 3
    mask = sp.coo_matrix((np.ones(int(keep.sum())), (mr[keep], mc[keep])), shape=(n, n)).tocsr()
    mc_ = mask.tocoo()
    return csr(mc_.row, mc_.col), csr(ar, ac), csr(br, bc)


def _plan_reference(mask, B):
    """numpy: the hub entries [(entry, row, [(c0, c1)])] of kernels 4 and
    5's plan."""
    mip, bip = to_numpy(mask.indptr).astype(np.int64), to_numpy(B.indptr).astype(np.int64)
    mcols = to_numpy(mask.cols)
    hubs = []
    for i in range(mask.shape[0]):
        for e in range(mip[i], mip[i + 1]):
            j = mcols[e]
            lo, hi = bip[j], bip[j + 1]
            if hi - lo > K.HUB_LEN:
                hubs.append((e, i, [(c, min(c + K.HUB_CHUNK, hi)) for c in range(lo, hi, K.HUB_CHUNK)]))
    return hubs


def test_mxmt_plan_matches_numpy():
    """The plan built on the CPU against a numpy reference: the stored
    entries (the windows end at indptr[m], not at the capacity), the hub
    entries whose B row (duplicates counted) exceeds HUB_LEN with their
    HUB_CHUNK chunks; cached per tensor."""
    mask, A, B = _plan_operands()
    plan = K.mxmt_plan(mask, B)
    hubs = _plan_reference(mask, B)
    assert plan.stored == int(mask.nnz) == int(mask.indptr[-1]) < mask.capacity
    chunks = [(e, i, c0, c1) for e, i, cs in hubs for c0, c1 in cs]
    got = list(zip(*(to_numpy(t).tolist() for t in (plan.chunk_entry, plan.chunk_row, plan.chunk_c0,
                                                     plan.chunk_c1))))
    assert (plan.nhub, plan.nchunks) == (len(hubs), len(chunks)) and got == chunks
    assert {len(cs) for _, _, cs in hubs} == {1, 2}
    first = np.cumsum([0] + [len(cs) for _, _, cs in hubs])
    np.testing.assert_array_equal(to_numpy(plan.chunk_first), first)
    np.testing.assert_array_equal(to_numpy(plan.chunk_hub), np.repeat(np.arange(len(hubs)),
                                                                      [len(cs) for _, _, cs in hubs]))
    assert plan.part is not None and plan.done.shape == (plan.nhub,) and not bool(plan.done.any())
    assert K.mxmt_plan(mask, B) is plan
    assert K.mxmt_plan(mask, A) is not plan  # another B


def test_mxmt_plan_of_an_empty_mask_and_team_sizes():
    """A mask with no stored entry has no window and no hub.  Every entry
    is walked by a team of two lanes, so B rows of any mean length up to
    HUB_LEN (the sizes at which kernel 1's rule would pick teams of 2 to
    16) leave the plan without hubs; longer rows are all hubs."""
    (_, _, _), (_, ta, tb) = _operands("INT", 17, 0)
    empty = F.csr_from_entries((N, N), [], [], [], dtype="int32", capacity=4, device="cpu")
    plan = K.mxmt_plan(empty, tb)
    assert (plan.stored, plan.nhub, plan.nchunks) == (0, 0, 0)
    for deg in (1, 48, 96, 192, 256, 400):
        rows = np.repeat(np.arange(40), deg)
        b = _csr_kept(40, rows, np.arange(rows.size) % 40, np.ones(rows.size, np.int32))
        m = F.csr_from_entries((40, 40), np.arange(40), np.arange(40), np.ones(40), dtype="int32",
                               device="cpu")
        plan = K.mxmt_plan(m, b)
        hubs = 40 if deg > K.HUB_LEN else 0
        assert (plan.stored, plan.nhub, plan.nchunks) == (40, hubs, hubs)


def _intersections_numpy(mask, A, B, sel):
    """numpy per stored entry: (hits, sum of A*B products in int64) over
    B's row j (duplicates counted), each column matched to the first of its
    equals in A's row i."""
    mip, aip, bip = (to_numpy(M.indptr).astype(np.int64) for M in (mask, A, B))
    mrow, mcol = to_numpy(mask.row_ids), to_numpy(mask.cols)
    acol, aval, bcol, bval = (to_numpy(t).astype(np.int64) for t in (A.cols, A.values, B.cols, B.values))
    hits = np.zeros(mask.capacity, np.int64)
    sums = np.zeros(mask.capacity, np.int64)
    for e in range(int(mip[-1])):
        if not sel[e]:
            continue
        i, j = mrow[e], mcol[e]
        row = acol[aip[i]:aip[i + 1]]
        for t in range(bip[j], bip[j + 1]):
            p = np.searchsorted(row, bcol[t])
            if p < row.size and row[p] == bcol[t]:
                hits[e] += 1
                sums[e] += aval[aip[i] + p] * bval[t]
    return hits, sums


def test_plain_versions_on_the_plan_graph():
    """Kernels 4 and 5's plain versions on the plan's graph (long rows of A
    and B, duplicates, an empty and a long mask row, unselected entries,
    capacity padding) against a numpy loop; sel None selects every stored
    entry."""
    mask, A, B = _plan_operands()
    sel = OP.GTZERO_INT(mask.values) & mask.valid_mask()
    assert not bool(sel[: int(mask.nnz)].all())
    hits, sums = _intersections_numpy(mask, A, B, to_numpy(sel))
    out, has = K.mxmt_masked_plain(mask, A, B, OP.MULT_INT, OP.PLUS_INT, 0, sel)
    np.testing.assert_array_equal(to_numpy(has), hits > 0)
    np.testing.assert_array_equal(to_numpy(out), sums.astype(np.int32))
    assert int(K.mxmt_reduce_plain(mask, A, B, OP.MULT_INT, sel)) == int(sums.sum())
    all_hits, _ = _intersections_numpy(mask, A, B, np.ones(mask.capacity, bool))
    assert int(K.mxmt_reduce_plain(mask, A, B, None, struct_only=True)) == int(all_hits.sum())
    out, has = K.mxmt_masked_plain(mask, A, B, None, OP.PLUS_INT, 0, struct_only=True)
    np.testing.assert_array_equal(to_numpy(out), all_hits.astype(np.int32))
    assert not bool(has[int(mask.nnz):].any())


def test_mxmt_gather_plain_matches_numpy():
    """The gather floor's plain version: per stored mask entry the XOR of
    B's row j (columns, and with values their 32 bits); 0 on padding."""
    from spla_tpu_torch.kernels import probe as K8

    mask, _, B = _plan_operands()
    mip, bip = to_numpy(mask.indptr), to_numpy(B.indptr)
    mcol, bcol = to_numpy(mask.cols), to_numpy(B.cols)
    bval = to_numpy(B.values).view(np.int32)
    for values in (True, False):
        want = np.zeros(mask.capacity, np.int32)
        for e in range(mip[-1]):
            j = mcol[e]
            words = bcol[bip[j]:bip[j + 1]] ^ (bval[bip[j]:bip[j + 1]] if values else 0)
            want[e] = np.bitwise_xor.reduce(words) if words.size else 0
        np.testing.assert_array_equal(to_numpy(K8.mxmt_gather(mask, B, values)), want)


def test_pin_tc_int32_sum_wraps_on_the_cpu():
    """tc of int32 values whose products fit int32 but whose sum passes
    2^31: the CPU path (mxmT_masked + m_reduce(PLUS_INT)) wraps in int32,
    where kernel 4 sums in int64 (test_torch_cuda.py
    test_tc_int32_sum_is_exact_on_the_card)."""
    a = _tc_graph(31).astype(np.int32)
    a.data[:] = 40_000
    d = a.toarray().astype(np.int64)
    exact = int(((d @ d.T) * (d > 0)).sum())
    assert exact > 2**31
    wrapped = (exact + 2**31) % 2**32 - 2**31
    assert alg.tc(F.csr_from_scipy(a, device="cpu")) == wrapped != exact
