"""spla_tpu_torch's mxm against spla_tpu's on the same numpy inputs, and
kernel 9's plain version against spla_tpu's numeric phase and its Pallas
ESC path (interpret mode).

Tolerances: f32 PLUS within rtol=1e-5, atol=1e-5 (the summation order
differs); everything else bitwise.  Only stored entries are compared
(``indptr``, and ``cols``, ``row_ids`` and ``values`` below ``nnz``):
spla_tpu's XLA path pads its result to ``products_cap``, the port to the
number of distinct (i, j) that products reach.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import spla_tpu.formats as JF
import spla_tpu.op as JOP
import spla_tpu.ops as JOPS
from spla_tpu.ops import spgemm as JG

from spla_tpu_torch import formats as F, op as OP
from spla_tpu_torch.containers import Scalar
from spla_tpu_torch.formats import stored_finite
from spla_tpu_torch.interop import from_spla_tpu, to_numpy
from spla_tpu_torch.kernels import spgemm as K9
from spla_tpu_torch.ops import spgemm as TG
from spla_tpu_torch.tools.graphs import spgemm_bins

NP_DTYPES = {"FLOAT": np.float32, "INT": np.int32}


def _stored(r):
    """indptr, and cols, row_ids and values below nnz, of a spla_tpu or port CSR."""
    d = to_numpy(r) if isinstance(r.values, torch.Tensor) else \
        {f: np.asarray(getattr(r, f)) for f in ("indptr", "cols", "row_ids", "values", "nnz")}
    k = int(d["nnz"])
    return d["indptr"], d["cols"][:k], d["row_ids"][:k], d["values"][:k], k


def _same(got, want, float_plus=False, nnz=True):
    g, w = _stored(got), _stored(want)
    if nnz:
        assert g[4] == w[4]
    for x, y in zip(g[:3], w[:3]):
        np.testing.assert_array_equal(x, y)
    assert g[3].dtype == w[3].dtype
    if float_plus:
        np.testing.assert_allclose(g[3], w[3], rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(g[3], w[3])


def _matrix(rng, m, n, density, tname, empty_rows=(), capacity_extra=0, fill=0):
    """m x n CSR, rows sorted by column, values in [-2, 2) (FLOAT) or
    [-5, 6) (INT), the rows in ``empty_rows`` empty; spla_tpu's and the
    port's."""
    a = sp.random(m, n, density=density, random_state=rng, dtype=np.float32).tocsr()
    for r in empty_rows:
        a.data[a.indptr[r]:a.indptr[r + 1]] = 0
    a.eliminate_zeros()
    if tname == "FLOAT":
        a.data = rng.uniform(-2, 2, a.nnz).astype(np.float32)
    else:
        a = a.astype(np.int32)
        a.data = rng.integers(-5, 6, a.nnz).astype(np.int32)
    j = JF.csr_from_scipy(a, fill=NP_DTYPES[tname](fill), capacity=a.nnz + capacity_extra)
    return a, j, from_spla_tpu(j, "cpu")


def _ops(mul, add, tname):
    return ((JOP.lookup(mul, getattr(JOP, tname)), JOP.lookup(add, getattr(JOP, tname))),
            (OP.lookup(mul, getattr(OP, tname)), OP.lookup(add, getattr(OP, tname))))


SEMIRINGS = [
    ("MULT", "PLUS", "FLOAT", 0.0),
    ("PLUS", "MIN", "FLOAT", np.inf),
    ("MULT", "PLUS", "INT", 0),
    ("PLUS", "MIN", "INT", np.iinfo(np.int32).max),
    ("PLUS", "MAX", "INT", np.iinfo(np.int32).min),
]


@pytest.mark.parametrize("mul,add,tname,init", SEMIRINGS)
def test_mxm_matches_spla_tpu(mul, add, tname, init):
    """The public mxm on spla_tpu's XLA path and the port's plain path:
    rectangular A (45 x 30) x B (30 x 50), empty rows in A and B,
    capacities above the stored counts."""
    rng = np.random.default_rng(31)
    _, ja, ta = _matrix(rng, 45, 30, 0.15, tname, empty_rows=(3, 17), capacity_extra=7, fill=init)
    _, jb, tb = _matrix(rng, 30, 50, 0.15, tname, empty_rows=(5,), capacity_extra=3, fill=init)
    (jm, jadd), (tm, tadd) = _ops(mul, add, tname)
    want = JOPS.mxm(ja, jb, jm, jadd, init)
    got = TG.mxm(ta, tb, tm, tadd, init)
    assert got.shape == (45, 50) and int(want.nnz) > 100
    _same(got, want, float_plus=tname == "FLOAT" and add == "PLUS")
    assert to_numpy(got.fill) == NP_DTYPES[tname](init)
    # the capacity: the distinct (i, j) that products reach; the padding row m
    assert got.capacity == (_pattern(ta) @ _pattern(tb)).nnz
    assert np.all(to_numpy(got.row_ids)[int(got.nnz):] == 45)


def _pattern(t):
    d = to_numpy(t)
    k = int(d["nnz"])
    return sp.csr_matrix((np.ones(k), d["cols"][:k], d["indptr"]), shape=t.shape)


def test_mxm_matches_scipy_in_float64():
    """MULT/PLUS f32 against scipy's A @ B, rows sorted by column."""
    rng = np.random.default_rng(32)
    a, _, ta = _matrix(rng, 40, 60, 0.1, "FLOAT")
    b, _, tb = _matrix(rng, 60, 35, 0.1, "FLOAT")
    got = TG.mxm(ta, tb, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0)
    ref = (a.astype(np.float64) @ b.astype(np.float64)).tocsr()
    ref.sort_indices()
    indptr, cols, rows, vals, k = _stored(got)
    assert k == ref.nnz
    np.testing.assert_array_equal(indptr, ref.indptr)
    np.testing.assert_array_equal(cols, ref.indices)
    np.testing.assert_array_equal(rows, np.repeat(np.arange(40), np.diff(ref.indptr)))
    np.testing.assert_allclose(vals, ref.data, rtol=1e-5, atol=1e-5)


def test_mxm_drops_init_valued_folds():
    """Accumulated values equal to init are not stored (cpu_mxm.hpp R_tmp[j]
    != I), as in tests/test_spgemm.py::test_mxm_identity_sparsification; and
    on a larger ±1 graph whose sums cancel, bitwise against spla_tpu."""
    a = JF.csr_from_entries((2, 2), [0, 0], [0, 1], [1.0, -1.0], fill=0.0)
    b = JF.csr_from_entries((2, 2), [0, 1], [0, 0], [1.0, 1.0], fill=0.0)
    got = TG.mxm(from_spla_tpu(a, "cpu"), from_spla_tpu(b, "cpu"), OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0)
    assert int(got.nnz) == 0 and int(JOPS.mxm(a, b, JOP.MULT_FLOAT, JOP.PLUS_FLOAT, 0.0).nnz) == 0
    assert got.capacity == 1 and to_numpy(got.indptr).tolist() == [0, 0, 0]
    rng = np.random.default_rng(33)
    a = sp.random(60, 60, density=0.1, random_state=rng, dtype=np.float32).tocsr().astype(np.int32)
    a.data = rng.choice([-1, 1], a.nnz).astype(np.int32)
    ja = JF.csr_from_scipy(a)
    want = JOPS.mxm(ja, ja, JOP.MULT_INT, JOP.PLUS_INT, 0)
    got = TG.mxm(from_spla_tpu(ja, "cpu"), from_spla_tpu(ja, "cpu"), OP.MULT_INT, OP.PLUS_INT, 0)
    dropped = (_pattern(from_spla_tpu(ja, "cpu")) @ _pattern(from_spla_tpu(ja, "cpu"))).nnz - int(got.nnz)
    assert dropped > 10
    _same(got, want)


def test_mxm_products_cap_truncates_as_spla_tpu():
    """A products_cap below the product count keeps the first products in
    expansion order, bitwise as spla_tpu's XLA path (i32)."""
    rng = np.random.default_rng(34)
    _, ja, ta = _matrix(rng, 50, 50, 0.12, "INT")
    total = JOPS.count_mxm_products(ja, ja)
    assert TG.count_mxm_products(ta, ta) == total
    for cap in (1, total // 3, total - 1):
        want = JOPS.mxm(ja, ja, JOP.MULT_INT, JOP.PLUS_INT, 0, products_cap=cap)
        got = TG.mxm(ta, ta, OP.MULT_INT, OP.PLUS_INT, 0, products_cap=cap)
        _same(got, want)
        assert int(got.nnz) < int(TG.mxm(ta, ta, OP.MULT_INT, OP.PLUS_INT, 0).nnz)


def test_pin_mxm_products_cap_truncates_at_the_dense_size():
    """ROADMAP queue 3 item 3, a reference fault the port does not copy: with
    products_cap >= 2^22 on MULT/PLUS f32, init 0, spla_tpu takes its dense
    product (``_mxm_dense_try``, spla_tpu/ops/spgemm.py:402-405,441-462) and
    returns the whole product, which is recorded; the port keeps the first
    2^22 products in expansion order (A's entries in order, each over B's
    row), as spla_tpu's XLA path does below the dense size.  Held against a
    numpy expansion cut there (values within the f32 PLUS tolerance)."""
    n, deg, cap = 2048, 48, 1 << 22
    rng = np.random.default_rng(37)
    cols = np.concatenate([np.sort(rng.choice(n, deg, replace=False)) for _ in range(n)]).astype(np.int32)
    indptr = np.arange(0, n * deg + 1, deg)
    a = sp.csr_matrix((rng.uniform(0.5, 1.5, n * deg).astype(np.float32), cols, indptr), shape=(n, n))
    ja, ta = JF.csr_from_scipy(a), from_spla_tpu(JF.csr_from_scipy(a), "cpu")
    assert a.nnz == 98304 and JOPS.count_mxm_products(ja, ja) > cap
    got = TG.mxm(ta, ta, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0, products_cap=cap)
    # the expansion: entry e of A (row i, column p) meets B's row p
    deg_b = np.diff(a.indptr)[a.indices]
    src = np.repeat(np.arange(a.nnz), deg_b)[:cap]
    t = a.indptr[a.indices[src]] + np.arange(src.size) - np.repeat(np.cumsum(deg_b) - deg_b, deg_b)[:cap]
    rows = np.repeat(np.arange(n), np.diff(a.indptr))
    ref = sp.coo_matrix((a.data[src].astype(np.float64) * a.data[t], (rows[src], a.indices[t])),
                        shape=(n, n)).tocsr()
    ref.sort_indices()
    g = to_numpy(got)
    k = int(g["nnz"])
    assert k == ref.nnz < (a @ a).nnz
    np.testing.assert_array_equal(g["indptr"], ref.indptr)
    np.testing.assert_array_equal(g["cols"][:k], ref.indices)
    np.testing.assert_allclose(g["values"][:k], ref.data, rtol=1e-5, atol=1e-5)
    want = JOPS.mxm(ja, ja, JOP.MULT_FLOAT, JOP.PLUS_FLOAT, 0.0, products_cap=cap)
    assert int(np.asarray(want.nnz)) == (a @ a).nnz  # the whole product, past the cap


@pytest.mark.parametrize("block", [256, 1024, 5000])
def test_mxm_product_windows_match_spla_tpu(block):
    """block_products folds windows of about that many products and merges
    them: against spla_tpu's blocked and unblocked results (f32 PLUS within
    the tolerance); i32 MIN bitwise against the port's unblocked result,
    which test_mxm_matches_spla_tpu holds to spla_tpu's."""
    rng = np.random.default_rng(35)
    _, ja, ta = _matrix(rng, 80, 80, 0.1, "FLOAT")
    assert JOPS.count_mxm_products(ja, ja) > 5000
    unblocked = JOPS.mxm(ja, ja, JOP.MULT_FLOAT, JOP.PLUS_FLOAT, 0.0)
    blocked = JOPS.mxm(ja, ja, JOP.MULT_FLOAT, JOP.PLUS_FLOAT, 0.0, block_products=block)
    got = TG.mxm(ta, ta, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0, block_products=block)
    _same(got, unblocked, float_plus=True)
    _same(got, blocked, float_plus=True)
    _, _, ti = _matrix(rng, 80, 80, 0.1, "INT", fill=np.iinfo(np.int32).max)
    big = np.iinfo(np.int32).max
    _same(TG.mxm(ti, ti, OP.PLUS_INT, OP.MIN_INT, big, block_products=block),
          TG.mxm(ti, ti, OP.PLUS_INT, OP.MIN_INT, big))


def test_pin_mxm_windows_fold_init_once():
    """A deliberate difference: with an init that is not op_add's identity,
    spla_tpu's product windows fold init into each window's partial sums and
    again at the merge (spla_tpu/ops/spgemm.py:526-527,536-538), so a blocked
    result differs from the unblocked one; the port folds init once, in
    every case (reference cpu_mxm.hpp:88-114 starts each row at init)."""
    rng = np.random.default_rng(36)
    _, ja, ta = _matrix(rng, 40, 40, 0.15, "FLOAT")
    unblocked = JOPS.mxm(ja, ja, JOP.MULT_FLOAT, JOP.PLUS_FLOAT, 1.0)
    blocked = JOPS.mxm(ja, ja, JOP.MULT_FLOAT, JOP.PLUS_FLOAT, 1.0, block_products=64)
    got = TG.mxm(ta, ta, OP.MULT_FLOAT, OP.PLUS_FLOAT, 1.0, block_products=64)
    _same(got, unblocked, float_plus=True)
    w = _stored(blocked)
    assert np.abs(w[3] - _stored(unblocked)[3]).max() >= 1.0  # spla_tpu's extra inits


def test_mxm_out_capacity():
    """With more entries than out_capacity the first ones in (row, column)
    order are stored, as spla_tpu stores them; the port's nnz is the
    capacity where spla_tpu's is the uncut count.  A larger out_capacity
    pads."""
    rng = np.random.default_rng(37)
    _, ja, ta = _matrix(rng, 40, 40, 0.15, "INT")
    full = TG.mxm(ta, ta, OP.MULT_INT, OP.PLUS_INT, 0)
    total = int(full.nnz)
    want = JOPS.mxm(ja, ja, JOP.MULT_INT, JOP.PLUS_INT, 0, out_capacity=25)
    got = TG.mxm(ta, ta, OP.MULT_INT, OP.PLUS_INT, 0, out_capacity=25)
    assert int(want.nnz) == total and int(got.nnz) == 25 and got.capacity == 25
    g, w = _stored(got), _stored(want)
    np.testing.assert_array_equal(g[0], w[0])
    for x, y in zip(g[1:4], w[1:4]):
        np.testing.assert_array_equal(x, y[:25])
    big = TG.mxm(ta, ta, OP.MULT_INT, OP.PLUS_INT, 0, out_capacity=total + 10)
    assert big.capacity == total + 10
    _same(big, full)
    assert np.all(to_numpy(big.values)[total:] == 0) and np.all(to_numpy(big.row_ids)[total:] == 40)


def test_mxm_plain_matches_spla_tpu_numeric():
    """kernels.spgemm.mxm_plain against spla_tpu's _mxm_numeric called
    directly (MULT/MAX f32, MULT/PLUS i32)."""
    rng = np.random.default_rng(38)
    _, ja, ta = _matrix(rng, 50, 40, 0.12, "FLOAT", capacity_extra=5)
    _, jb, tb = _matrix(rng, 40, 45, 0.12, "FLOAT")
    cap = JOPS.count_mxm_products(ja, jb)
    want = JG._mxm_numeric(ja, jb, jnp.float32(-np.inf), JOP.MULT_FLOAT, JOP.MAX_FLOAT, cap, None)
    _same(K9.mxm_plain(ta, tb, OP.MULT_FLOAT, OP.MAX_FLOAT, -np.inf), want)
    _, ja, ta = _matrix(rng, 50, 40, 0.12, "INT")
    _, jb, tb = _matrix(rng, 40, 45, 0.12, "INT")
    cap = JOPS.count_mxm_products(ja, jb)
    want = JG._mxm_numeric(ja, jb, jnp.int32(0), JOP.MULT_INT, JOP.PLUS_INT, cap, None)
    _same(K9.mxm_plain(ta, tb, OP.MULT_INT, OP.PLUS_INT, 0), want)
    # the kernel's wrapper on CPU tensors is its plain version
    _same(K9.mxm(ta, tb, OP.MULT_INT, OP.PLUS_INT, 0), want)


def test_mxm_plain_matches_the_pallas_esc_path(monkeypatch):
    """The Pallas ESC path (_mxm_pallas_try: three fused_cell_spmv_apply
    passes, interpret mode) against the port's plain version, MULT/PLUS
    f32, as tests/test_spgemm.py::test_mxm_pallas_esc_matches_scipy runs it."""
    from spla_tpu.pallas.cellpack_native import _native_lib

    if _native_lib() is None:
        pytest.skip("no native toolchain for spla_tpu's packer")
    monkeypatch.setenv("SPLA_FORCE_PALLAS_DISPATCH", "1")
    rng = np.random.default_rng(39)
    a = sp.random(300, 250, density=0.03, random_state=1, dtype=np.float32).tocsr()
    b = sp.random(250, 280, density=0.03, random_state=2, dtype=np.float32).tocsr()
    a.data[:] = rng.random(a.nnz, np.float32) + 0.5
    b.data[:] = rng.random(b.nnz, np.float32) + 0.5
    ja, jb = JF.csr_from_scipy(a), JF.csr_from_scipy(b)
    want = JOPS.mxm(ja, jb, JOP.MULT_FLOAT, JOP.PLUS_FLOAT, 0.0)
    prep = JG._MXM_ESC_CACHE.get(ja.cols, ("mxm_esc",))
    assert prep is not None and prep["ok"]  # the Pallas path was taken
    got = K9.mxm_plain(from_spla_tpu(ja, "cpu"), from_spla_tpu(jb, "cpu"), OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0)
    _same(got, want, float_plus=True)


def _plan_reference(a, b):
    """Each row's products, and its group: 0 small, 1 + c medium with a table
    of MEDIUM_SLOTS[c] slots (the least of them at or above twice its
    products), 5 large."""
    prods = np.array([np.diff(b.indptr)[a.indices[a.indptr[i]:a.indptr[i + 1]]].sum()
                      for i in range(a.shape[0])], np.int64)
    table = np.searchsorted(np.array(K9.MEDIUM_SLOTS), 2 * prods)
    group = np.where(prods <= K9.SMALL_MAX, 0, np.where(prods <= K9.MEDIUM_MAX, 1 + table, 5))
    return prods, group


def test_mxm_plan_fills_the_three_bins():
    """mxm_plan against numpy on graphs.spgemm_bins (small, medium and large
    rows): each row's products, the bins in row order (medium rows by table
    size), the cache; and every bin's rows through the plain version
    against scipy."""
    a, b = spgemm_bins(400)
    ta, tb = (from_spla_tpu(JF.csr_from_scipy(x), "cpu") for x in (a, b))
    plan = K9.mxm_plan(ta, tb)
    prods, group = _plan_reference(a, b)
    np.testing.assert_array_equal(to_numpy(plan.row_products), prods)
    counts = np.bincount(group, minlength=6)
    assert (plan.nsmall, *plan.medium_counts, plan.nlarge) == tuple(counts)
    assert plan.nsmall > 0 and plan.nlarge > 0 and np.count_nonzero(plan.medium_counts) >= 2
    assert plan.nmedium == sum(plan.medium_counts)
    np.testing.assert_array_equal(to_numpy(plan.rows), np.argsort(group, kind="stable"))
    assert plan.products == prods.sum()
    assert K9.mxm_plan(ta, tb) is plan
    got = K9.mxm(ta, tb, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0)
    ref = (a @ b).tocsr()
    ref.sort_indices()
    _, c, _, v, k = _stored(got)
    assert k == ref.nnz
    np.testing.assert_array_equal(c, ref.indices)
    np.testing.assert_allclose(v, ref.data, rtol=1e-5)


@pytest.mark.parametrize("n,shape,passes", [
    (2000, (16, 128, 1), 2),
    (1 << 18, (16, 1 << 14, 1), 3),
    (1 << 20, (16, 1 << 15, 2), 3),
    (1 << 24, (16, 1 << 15, 32), 3),
])
def test_cluster_shape(n, shape, passes):
    """The large rows' cluster at 132 SMs and 227 KB of shared memory a CTA:
    CLUSTER (16) CTAs, W the least power of two that covers n with them, at
    most 2^15 (128 KB of f32 values and 4 KB of bitmap), and the windows that cover n; a
    cluster of 8 holds twice as many columns a CTA, up to 2^15; the medium
    rows' radix passes (bytes of n - 1)."""
    assert K9.CLUSTER == 16
    c, w, windows = K9.cluster_shape(n, 132, K9.LARGE_SHARED_BYTES)
    assert (c, w, windows) == shape
    assert c * w * windows >= n > c * w * (windows - 1)
    assert 4 * w + w // 8 + K9.LARGE_STATIC_BYTES <= K9.LARGE_SHARED_BYTES
    c8, w8, windows8 = K9.cluster_shape(n, 132, K9.LARGE_SHARED_BYTES, 8)
    assert c8 == 8 and c8 * w8 * windows8 >= n and w8 == min(2 * w, 1 << 15)
    assert K9.cluster_shape(n, 4, K9.LARGE_SHARED_BYTES)[0] == 4  # no cluster wider than the card
    assert K9.radix_passes(n) == passes
    with pytest.raises(ValueError, match="hold no 32 columns"):
        K9.cluster_shape(n, 132, K9.LARGE_STATIC_BYTES + 64)


def test_mxm_codes_and_cpu_dispatch():
    """The gate is kernel 1's: the six muls, PLUS / MIN / MAX, f32 and i32;
    CPU tensors and explicit caps count as the torch path."""
    assert K9.mxm_codes(OP.MULT_FLOAT, OP.PLUS_FLOAT, torch.float32) == (1, 0, 0)
    assert K9.mxm_codes(OP.SECOND_INT, OP.MAX_INT, torch.int32) == (3, 5, 1)
    assert K9.mxm_codes(OP.MULT_INT, OP.BOR_INT, torch.int32) is None
    assert K9.mxm_codes(OP.MULT_UINT, OP.PLUS_UINT, torch.uint32) is None
    rng = np.random.default_rng(41)
    _, _, ta = _matrix(rng, 20, 20, 0.2, "FLOAT")
    before = dict(TG.DISPATCH_STATS)
    TG.mxm(ta, ta, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0)
    TG.mxm(ta, ta, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0, check_init_sparsify=False)
    assert TG.DISPATCH_STATS["mxm_torch"] == before["mxm_torch"] + 2
    assert TG.DISPATCH_STATS["mxm_kernel"] == before["mxm_kernel"]


def test_mxm_times_tool_graphs_and_kernel_names():
    """tools/mxm_times.py's graphs on the CPU (A = B, f32; A @ B for bins),
    its short kernel names, and its refusal of an unknown graph."""
    from spla_tpu_torch.tools import mxm_times as MT

    A, B = MT.operands("bins", torch.device("cpu"))
    assert A.values.dtype == torch.float32 and A.shape == B.shape and A is not B
    A, B = MT.operands("mx13", torch.device("cpu"))
    assert A is B and A.shape == (1 << 13, 1 << 13)
    assert MT.kernel_name("void (anonymous namespace)::numeric_small<float, 1, 0>(Operands, Bins, Out<float>)") \
        == "numeric_small"
    assert MT.kernel_name("_ZN41_GLOBAL__N__e3c8_9_spgemm_cu14symbolic_largeENS_8OperandsE") == "symbolic_large"
    assert MT.kernel_name("void (anonymous namespace)::numeric_medium<float, 1, 0>(Operands, Bins, long long, "
                          "long long, int, Out<float>)") == "numeric_medium"
    with pytest.raises(ValueError, match="unknown graphs"):
        MT.main(["--graphs", "mx99"])
    assert MT.cluster_settings("8,16,1") == [8, 16, 1]
    for bad in ("3", "8:512", "32", "16,0"):
        with pytest.raises(ValueError, match="--cluster"):
            MT.main(["--graphs", "mx13", "--cluster", bad])


def _dense_operands():
    """60 x 60 A and B, values in [0.5, 1.5), in which products reach slots
    that sum to 0: row 0 of A holds 1.0 at columns 1 and 2, and B 2.0 at
    (1, 3) and -2.0 at (2, 3) (a cancelling pair); row 5 of A holds one
    stored 0.0 (column 7); row 9 of A holds (9, 11) twice (duplicates
    added).  Returns scipy's CSR (duplicates and the stored 0.0 kept),
    spla_tpu's and the port's of each."""
    rng = np.random.default_rng(51)

    def entries(density):
        m = sp.random(60, 60, density=density, random_state=rng, dtype=np.float32).tocoo()
        return [m.row.tolist(), m.col.tolist(), rng.uniform(0.5, 1.5, m.nnz).tolist()]

    def build(rows, cols, vals):
        rows, cols, vals = np.array(rows), np.array(cols), np.array(vals, np.float32)
        order = np.lexsort((cols, rows))
        indptr = np.searchsorted(rows[order], np.arange(61))
        s = sp.csr_matrix((vals[order], cols[order].astype(np.int32), indptr), shape=(60, 60))
        return s, JF.csr_from_scipy(s), from_spla_tpu(JF.csr_from_scipy(s), "cpu")

    ra, ca, va = entries(0.1)
    keep = [i for i, r in enumerate(ra) if r not in (0, 5, 9)]
    ra, ca, va = ([x[i] for i in keep] for x in (ra, ca, va))
    ra += [0, 0, 5, 9, 9]
    ca += [1, 2, 7, 11, 11]
    va += [1.0, 1.0, 0.0, 0.5, 0.75]
    rb, cb, vb = entries(0.1)
    keep = [i for i, (r, c) in enumerate(zip(rb, cb)) if not (r in (1, 2) and c == 3)]
    rb, cb, vb = ([x[i] for i in keep] for x in (rb, cb, vb))
    rb += [1, 2, 7, 11]
    cb += [3, 3, 20, 30]
    vb += [2.0, -2.0, 1.0, 1.0]
    return build(ra, ca, va), build(rb, cb, vb)


def test_mxm_dense_route_matches_spla_tpu_dense_route():
    """The port's dense route (ops.spgemm._mxm_dense) against spla_tpu's
    (products_cap >= 2^22 takes ``_mxm_dense_try`` at any size, its
    capacity min(products_cap, m n)): indptr, columns and nnz bitwise,
    values within rtol 1e-5; against kernel 9's plain version every field
    (capacity, padding and fill too; values within rtol 1e-5); against
    scipy's float64 A @ B.  The stored 0.0 and the cancelling pair reach
    slots that sum to 0: the capacity (reached slots) exceeds nnz."""
    (a, ja, ta), (b, jb, tb) = _dense_operands()
    want = JOPS.mxm(ja, jb, JOP.MULT_FLOAT, JOP.PLUS_FLOAT, 0.0, products_cap=1 << 22)
    assert np.asarray(want.values).shape[0] == 60 * 60  # spla_tpu's dense route
    got = TG._mxm_dense(ta, tb)
    _same(got, want, float_plus=True)
    plain = K9.mxm_plain(ta, tb, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0)
    assert got.capacity == plain.capacity == (_pattern(ta) @ _pattern(tb)).nnz > int(got.nnz)
    for f in ("indptr", "cols", "row_ids", "nnz", "fill"):
        np.testing.assert_array_equal(to_numpy(getattr(got, f)), to_numpy(getattr(plain, f)))
    np.testing.assert_allclose(to_numpy(got.values), to_numpy(plain.values), rtol=1e-5, atol=1e-5)
    ref = (a.astype(np.float64) @ b.astype(np.float64)).tocsr()
    ref.eliminate_zeros()
    ref.sort_indices()
    g = to_numpy(got)
    k = int(g["nnz"])
    assert k == ref.nnz and int(g["indptr"][1] - g["indptr"][0]) > 0
    np.testing.assert_array_equal(g["indptr"], ref.indptr)
    np.testing.assert_array_equal(g["cols"][:k], ref.indices)
    np.testing.assert_allclose(g["values"][:k], ref.data, rtol=1e-5)
    assert 3 not in g["cols"][g["indptr"][0]:g["indptr"][1]]  # the cancelled slot (0, 3)


@pytest.mark.parametrize("extra", [-200, 0, 17])
def test_mxm_dense_route_out_capacity(extra):
    """With out_capacity below the entry count the first entries in (row,
    column) order are stored and nnz is the capacity; at or above it the
    rest is padding (row m, column 0, value 0): every field as kernel 9's
    plain version gives it, values within rtol 1e-5."""
    (_, _, ta), (_, _, tb) = _dense_operands()
    kept = int(K9.mxm_plain(ta, tb, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0).nnz)
    cap = kept + extra
    got = TG._mxm_dense(ta, tb, out_capacity=cap)
    plain = K9.mxm_plain(ta, tb, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0, out_capacity=cap)
    assert got.capacity == plain.capacity == cap and int(got.nnz) == min(kept, cap)
    for f in ("indptr", "cols", "row_ids", "nnz"):
        np.testing.assert_array_equal(to_numpy(getattr(got, f)), to_numpy(getattr(plain, f)))
    np.testing.assert_allclose(to_numpy(got.values), to_numpy(plain.values), rtol=1e-5, atol=1e-5)


def _gate_case(**change):
    """``mxm_dense_gate``'s arguments for a request it admits (4096^3 with
    the fewest products it takes), with ``change`` applied."""
    n = 4096
    args = {"op_mul": OP.MULT_FLOAT, "op_add": OP.PLUS_FLOAT, "dtypes": (torch.float32, torch.float32),
            "init": 0.0, "m": n, "k": n, "n": n,
            "products": int(np.ceil(max(TG.MXM_DENSE_MIN_PRODUCTS, TG.MXM_DENSE_PER_MKN * n ** 3))),
            "finite": lambda: True}
    args.update(change)
    return args


def _no_read():
    raise AssertionError("finite() was asked though another condition refused")


@pytest.mark.parametrize("change", [
    {"op_mul": OP.PLUS_FLOAT},
    {"op_add": OP.MAX_FLOAT},
    {"dtypes": (torch.int32, torch.int32)},
    {"dtypes": (torch.float32, torch.float64)},
    {"init": 1.0},
    {"init": torch.zeros((), device="meta")},
    {"init": "zero"},
    {"m": 1 << 17, "k": 1025, "n": 64, "products": 10 ** 13},
    {"m": 64, "k": 1025, "n": 1 << 17, "products": 10 ** 13},
    {"m": 1 << 14, "k": 64, "n": (1 << 13) + 1, "products": 10 ** 13},
    {"products": _gate_case()["products"] - 1},
    {"m": 64, "k": 64, "n": 64, "products": TG.MXM_DENSE_MIN_PRODUCTS - 1},
    {"finite": lambda: False},
], ids=["mul", "add", "i32", "B f64", "init 1", "init on a device", "init no number", "A over the cap",
        "B over the cap", "C over the cap", "too few for the density", "too few products", "not finite"])
def test_mxm_dense_gate_refuses(change):
    """mxm_dense_gate as a pure function: the base case is admitted (also
    with init as a Scalar, a CPU tensor or -0.0), and each condition alone
    refuses; the finiteness check, which reads the host, is asked last."""
    assert TG.mxm_dense_gate(**_gate_case())
    assert TG.mxm_dense_gate(**_gate_case(m=1 << 17, k=1 << 10, n=64, products=10 ** 13))  # at the cap
    for init in (Scalar(torch.zeros(())), torch.zeros(()), np.float32(0), -0.0):
        assert TG.mxm_dense_gate(**_gate_case(init=init))
    assert not TG.mxm_dense_gate(**_gate_case(**change))
    if "finite" not in change:
        assert not TG.mxm_dense_gate(**_gate_case(**change, finite=_no_read))


def test_pin_mxm_dense_route_keeps_infinite_values_out(monkeypatch):
    """A reference fault the port does not copy: spla_tpu's dense route puts
    a stored inf into a dense matrix whose absent entries are 0, so inf * 0
    gives NaN at slots that no product reaches.  With products_cap >= 2^22
    (its dense route) spla_tpu returns 10 entries, 4 of them NaN at
    unreached slots, which is recorded; its other route returns the 6
    reached ones.  The port's gate refuses the request for the inf alone
    (the density thresholds lifted), admits a finite copy, and its result
    equals the plain path's and spla_tpu's other route; the dense route on
    this graph would give NaN too."""
    rows, cols, vals = [0, 1, 1, 2, 3], [1, 2, 3, 3, 0], [np.inf, 1.0, 2.0, 3.0, 3.0]
    ja = JF.csr_from_entries((4, 4), rows, cols, vals, fill=0.0)
    ta = from_spla_tpu(ja, "cpu")
    reached = _stored(JOPS.mxm(ja, ja, JOP.MULT_FLOAT, JOP.PLUS_FLOAT, 0.0))
    assert reached[4] == 6 and not np.isnan(reached[3]).any()
    dense = _stored(JOPS.mxm(ja, ja, JOP.MULT_FLOAT, JOP.PLUS_FLOAT, 0.0, products_cap=1 << 22))
    nan = np.isnan(dense[3])
    assert dense[4] == 10 and nan.sum() == 4
    assert set(zip(dense[2][nan].tolist(), dense[1][nan].tolist())) == {(0, 0), (0, 1), (1, 1), (2, 1)}
    pattern = _pattern(ta) @ _pattern(ta)
    assert all(pattern[i, j] == 0 for i, j in zip(dense[2][nan], dense[1][nan]))  # no product reaches them
    got = TG.mxm(ta, ta, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0)
    _same(got, K9.mxm_plain(ta, ta, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0))
    _same(got, JOPS.mxm(ja, ja, JOP.MULT_FLOAT, JOP.PLUS_FLOAT, 0.0))
    monkeypatch.setattr(TG, "MXM_DENSE_MIN_PRODUCTS", 0)
    monkeypatch.setattr(TG, "MXM_DENSE_PER_MKN", 0.0)
    finite = from_spla_tpu(JF.csr_from_entries((4, 4), rows, cols, [1.0, 1.0, 2.0, 3.0, 3.0], fill=0.0), "cpu")
    for M, admitted in ((ta, False), (finite, True)):
        assert TG.mxm_dense_gate(OP.MULT_FLOAT, OP.PLUS_FLOAT, (torch.float32,) * 2, 0.0, 4, 4, 4,
                                 K9.mxm_plan(M, M).products, lambda: stored_finite(M)) is admitted
    assert np.isnan(to_numpy(TG._mxm_dense(ta, ta).values)).any()


def test_mxm_dense_route_not_on_cpu_tensors_or_with_caps(monkeypatch):
    """The dense route is for CUDA tensors: CPU tensors take the plain path
    even where the gate would admit the request, and so do products_cap
    and block_products; mxm_dense stays 0."""
    monkeypatch.setattr(TG, "MXM_DENSE_MIN_PRODUCTS", 0)
    monkeypatch.setattr(TG, "MXM_DENSE_PER_MKN", 0.0)
    (_, _, ta), (_, _, tb) = _dense_operands()
    before = dict(TG.DISPATCH_STATS)
    want = K9.mxm_plain(ta, tb, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0)
    assert TG.mxm_dense_gate(OP.MULT_FLOAT, OP.PLUS_FLOAT, (torch.float32,) * 2, 0.0, 60, 60, 60,
                             K9.mxm_plan(ta, tb).products, lambda: stored_finite(ta) and stored_finite(tb))
    _same(TG.mxm(ta, tb, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0), want)
    TG.mxm(ta, tb, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0, products_cap=10 ** 6)
    TG.mxm(ta, tb, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0, block_products=64)
    assert TG.DISPATCH_STATS["mxm_torch"] == before["mxm_torch"] + 3
    assert TG.DISPATCH_STATS["mxm_dense"] == before["mxm_dense"]


def test_mxm_times_dense_fit():
    """tools/mxm_times.py's crossover (log products interpolated in log
    time ratio between the rows about the change of winner) and the gate's
    fit, on made-up rows; the dense operands on the CPU."""
    from spla_tpu_torch.tools import mxm_times as MT

    rows = [{"products": p, "kernel9_ms": k, "dense_ms": 10.0} for p, k in ((4e8, 20.0), (1e8, 5.0), (2e8, 8.0))]
    at = MT.crossover(rows)
    assert 2e8 < at < 4e8
    assert abs(np.log(at / 2e8) / np.log(2) - np.log(10 / 8) / np.log(20 / 8)) < 1e-9
    assert MT.crossover([{"products": 1e8, "kernel9_ms": 5.0, "dense_ms": 10.0}]) is None
    fit = MT.fit_gate([(4096, 7e-4 * 4096 ** 3 + 1e6), (8192, 7e-4 * 8192 ** 3 + 1e6), (11585, 7e-4 * 11585 ** 3 + 1e6)])
    assert abs(fit["c_with_p0"] - 7e-4) < 1e-9 and abs(fit["p0"] - 1e6) < 1.0
    assert set(fit["c_per_n"]) == {4096, 8192, 11585}
    A = MT.dense_operand(300, 8, torch.device("cpu"))
    assert A.shape == (300, 300) and A.values.dtype == torch.float32 and F.stored_finite(A)
