"""spla_tpu_torch's masked SpMV (kernel 1's plain version and the public ops)
against spla_tpu on the same numpy inputs.

Tolerances: f32 PLUS results within rtol=1e-5, atol=1e-5 (the summation
order differs); int, bool, MIN and MAX results bitwise (NaN equal to NaN).
Kernel 1's plain version is also held against each TPU SpMV kernel whose
semantics it covers, in Pallas interpret mode.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import spla_tpu.formats as JF
import spla_tpu.op as JOP
import spla_tpu.ops.spmv as JS
from spla_tpu.containers import DenseVec as JDenseVec

from spla_tpu_torch import op as OP
from spla_tpu_torch.interop import from_spla_tpu, to_numpy
from spla_tpu_torch.kernels import spmv as K1
from spla_tpu_torch.ops import spmv as TS

N = 400


def _close(got, want, float_plus):
    got, want = to_numpy(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if float_plus:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, equal_nan=True)
    else:
        np.testing.assert_array_equal(got, want)


def _matrix(tname, fill, seed=0, n=N):
    a = sp.random(n, n, density=0.02, random_state=seed, dtype=np.float32).tocsr()
    a = a.multiply((np.arange(n) != 7)[:, None]).tocsr()  # row 7 empty
    a.eliminate_zeros()
    if tname != "FLOAT":
        a = (a * 100).astype({"INT": np.int32, "UINT": np.uint32}[tname])
    dt = a.dtype
    return a, JF.csr_from_scipy(a, fill=dt.type(fill), capacity=a.nnz + 7)


def _vector(tname, fill, seed=1, n=N):
    rng = np.random.default_rng(seed)
    if tname == "FLOAT":
        x = rng.uniform(-2, 2, n).astype(np.float32)
        x[3] = np.nan
    else:
        x = rng.integers(0, 50, n).astype({"INT": np.int32, "UINT": np.uint32}[tname])
    x[rng.random(n) < 0.3] = fill  # unstored entries
    return JDenseVec(jnp.asarray(x), jnp.asarray(fill, x.dtype))


SEMIRINGS = [
    ("MULT", "PLUS", "FLOAT", 0),
    ("PLUS", "MIN", "FLOAT", np.inf),
    ("MIN", "MAX", "FLOAT", -np.inf),
    ("SECOND", "MIN", "FLOAT", np.inf),  # vxm swaps the operands
    ("MINUS", "PLUS", "FLOAT", 0),  # not covered, not commutative: plain path, product order
    ("MULT", "PLUS", "INT", 0),
    ("FIRST", "MAX", "INT", np.iinfo(np.int32).min),
    ("BAND", "BOR", "INT", 0),  # the reference BFS semiring: segmented-scan fold
    ("MULT", "PLUS", "UINT", 0),
]


@pytest.mark.parametrize("mul,add,tname,fill", SEMIRINGS)
def test_public_spmv_matches_spla_tpu(mul, add, tname, fill):
    """mxv_masked, vxm_masked (sparse v) and vxm_masked_dense, with a mask
    select, on the XLA path of spla_tpu and the plain path here."""
    a, JA = _matrix(tname, fill)
    A = from_spla_tpu(JA, "cpu")
    jv = _vector(tname, fill)
    v = from_spla_tpu(jv, "cpu")
    jsv = JF.dense_to_sparse_vec(jv, capacity=N)
    sv = from_spla_tpu(jsv, "cpu")
    mvals = (np.random.default_rng(2).random(N) < 0.7).astype(np.float32)
    jmask = JDenseVec(jnp.asarray(mvals), jnp.float32(0))
    mask = from_spla_tpu(jmask, "cpu")
    jt, tt = getattr(JOP, tname), getattr(OP, tname)
    jops = (JOP.lookup(mul, jt), JOP.lookup(add, jt), JOP.NQZERO_FLOAT)
    tops = (OP.lookup(mul, tt), OP.lookup(add, tt), OP.NQZERO_FLOAT)
    fp = tname == "FLOAT" and add == "PLUS"

    want = JS.mxv_masked(jmask, JA, jv, *jops, fill)
    _close(TS.mxv_masked(mask, A, v, *tops, fill).values, want.values, fp)
    want = JS.vxm_masked_dense(jmask, jv, JA, *jops, fill)
    _close(TS.vxm_masked_dense(mask, v, A, *tops, fill).values, want.values, fp)
    want = JS.vxm_masked(jmask, jsv, JA, *jops, fill, out_capacity=N)
    got = TS.vxm_masked(mask, sv, A, *tops, fill, out_capacity=N)
    assert int(got.nnz) == int(want.nnz)
    _close(got.indices, want.indices, False)
    _close(got.values, want.values, fp)


def test_dispatch_stats_on_cpu_take_the_torch_path():
    a, JA = _matrix("FLOAT", 0)
    A = from_spla_tpu(JA, "cpu")
    v = from_spla_tpu(_vector("FLOAT", 0), "cpu")
    before = dict(TS.DISPATCH_STATS)
    TS.mxv_masked(v, A, v, OP.MULT_FLOAT, OP.PLUS_FLOAT, OP.ALWAYS_FLOAT, 0.0)
    TS.vxm_masked_dense(v, v, A, OP.MULT_FLOAT, OP.PLUS_FLOAT, OP.ALWAYS_FLOAT, 0.0)
    assert TS.DISPATCH_STATS["mxv_torch"] == before["mxv_torch"] + 1
    assert TS.DISPATCH_STATS["vxm_torch"] == before["vxm_torch"] + 1
    assert TS.DISPATCH_STATS["mxv_kernel"] == before["mxv_kernel"]


def test_best_spmv_fn_and_structural_match():
    a, JA = _matrix("FLOAT", 0, seed=3)
    A = from_spla_tpu(JA, "cpu")
    x = np.random.default_rng(4).random(N, dtype=np.float32)
    want = JS.best_spmv_fn(JA, JOP.MULT_FLOAT, JOP.PLUS_FLOAT, 0.0)(JA, jnp.asarray(x))
    got = TS.best_spmv_fn(A, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0)(A, torch.from_numpy(x))
    _close(got, want, True)
    act, sel = x > 0.6, x < 0.8
    want = JS.masked_spmv_structural(JA, jnp.asarray(act), jnp.asarray(sel))
    _close(TS.masked_spmv_structural(A, torch.from_numpy(act), torch.from_numpy(sel)), want, False)


def _fused_format(a, cw=1024):
    from spla_tpu.pallas.cellpack_native import _native_lib
    from spla_tpu.pallas.spmv import build_fused_cell_spmv_arrays

    if _native_lib() is None:
        pytest.skip("no native toolchain for spla_tpu's packer")
    coo = a.tocoo()
    return build_fused_cell_spmv_arrays(a.shape[0], a.shape[1], coo.row.astype(np.int32),
                                        coo.col.astype(np.int32), coo.data.astype(np.float32),
                                        cw=cw)


def test_kernel1_plain_matches_fused_cell_spmv_apply():
    """Kernel 1's plain version against the TPU kernel it replaces, run in
    Pallas interpret mode on a packed fused format (MULT/PLUS; the min-plus
    semiring meets the TPU kernel in the SSSP loop test)."""
    from spla_tpu.pallas.spmv import fused_cell_spmv_apply

    a, JA = _matrix("FLOAT", 0, seed=5)
    fmt = _fused_format(a)
    x = np.random.default_rng(6).random(N, dtype=np.float32)
    want = fused_cell_spmv_apply(fmt, jnp.asarray(x), op_mul=lambda av, xv: av * xv,
                                 op_add=jnp.add, identity=0.0)
    got, has = K1.spmv_pull(from_spla_tpu(JA, "cpu"), torch.from_numpy(x), OP.MULT_FLOAT,
                            OP.PLUS_FLOAT, 0.0, want_has=True)
    _close(got, want, True)
    assert not bool(has[7])  # the empty row stores nothing


def test_forced_pallas_dispatch_matches(monkeypatch):
    """spla_tpu's public mxv_masked through its Pallas dispatch (interpret
    mode on the CPU, as tests/test_spmv.py forces it) against the port."""
    from spla_tpu.pallas.cellpack_native import _native_lib

    if _native_lib() is None:
        pytest.skip("no native toolchain for spla_tpu's packer")
    monkeypatch.setenv("SPLA_FORCE_PALLAS_DISPATCH", "1")
    a, JA = _matrix("FLOAT", 0, seed=8)
    jv = JDenseVec(jnp.asarray(np.random.default_rng(9).random(N, dtype=np.float32)), jnp.float32(0))
    jmask = JDenseVec(jnp.asarray((np.arange(N) % 3 != 0).astype(np.float32)), jnp.float32(0))
    before = JS.DISPATCH_STATS["mxv_pallas"]
    want = JS.mxv_masked(jmask, JA, jv, JOP.MULT_FLOAT, JOP.PLUS_FLOAT, JOP.NQZERO_FLOAT, 0.0)
    assert JS.DISPATCH_STATS["mxv_pallas"] == before + 1
    got = TS.mxv_masked(from_spla_tpu(jmask, "cpu"), from_spla_tpu(JA, "cpu"),
                        from_spla_tpu(jv, "cpu"), OP.MULT_FLOAT, OP.PLUS_FLOAT, OP.NQZERO_FLOAT, 0.0)
    _close(got.values, want.values, True)


# The older-layout TPU SpMV kernels (spla_tpu/pallas/spmv.py): the MXU
# one-hot PLUS kernel, the monoid sweep and the S-table scatter.  Kernel 1
# computes their semantics; (format constructor, apply, extra kwargs, mul, add, init).
OLDER_KERNELS = {
    "cell_spmv_apply-MULT/PLUS": ("build_cell_spmv", "cell_spmv_apply", {"scatter_mode": "f32"},
                                  "MULT", "PLUS", 0.0),
    "monoid_cell_spmv_apply-PLUS/MIN": ("build_monoid_cell_spmv_arrays", "monoid_cell_spmv_apply", {},
                                        "PLUS", "MIN", np.inf),
    "monoid_cell_spmv_apply-MULT/MAX": ("build_monoid_cell_spmv_arrays", "monoid_cell_spmv_apply", {},
                                        "MULT", "MAX", -np.inf),
    "s_cell_spmv_apply-PLUS/MIN": ("build_s_cell_spmv_arrays", "s_cell_spmv_apply", {},
                                   "PLUS", "MIN", np.inf),
}
_JAX_OPS = {"MULT": lambda av, xv: av * xv, "PLUS": lambda av, xv: av + xv,
            "MIN": jnp.minimum, "MAX": jnp.maximum}


@pytest.mark.parametrize("case", list(OLDER_KERNELS))
def test_kernel1_plain_matches_the_older_tpu_kernels(case):
    """Kernel 1's plain version against cell_spmv_apply (PLUS, f32 scatter:
    within rtol=1e-5, atol=1e-5), monoid_cell_spmv_apply and
    s_cell_spmv_apply (MIN and MAX: bitwise), run in interpret mode on
    formats packed as tests/test_pallas.py packs them; row 7 is empty and
    gets the identity."""
    import spla_tpu.pallas.spmv as SP
    from spla_tpu.pallas.cellpack_native import _native_lib

    make, apply, kwargs, mul, add, init = OLDER_KERNELS[case]
    a, JA = _matrix("FLOAT", init, seed=10)
    x = np.random.default_rng(11).random(N, dtype=np.float32) * 3
    if make == "build_cell_spmv":
        want = SP.cell_spmv_apply(SP.build_cell_spmv(JA, cw=1024), jnp.asarray(x), **kwargs)
    else:
        if _native_lib() is None:
            pytest.skip("no native toolchain for spla_tpu's packer")
        coo = a.tocoo()
        fmt = getattr(SP, make)(N, N, coo.row.astype(np.int32), coo.col.astype(np.int32), coo.data,
                                 cw=1024)
        want = getattr(SP, apply)(fmt, jnp.asarray(x), op_mul=_JAX_OPS[mul], op_add=_JAX_OPS[add],
                                  identity=init)
    got, has = K1.spmv_pull(from_spla_tpu(JA, "cpu"), torch.from_numpy(x), OP.lookup(mul, OP.FLOAT),
                            OP.lookup(add, OP.FLOAT), init, want_has=True)
    _close(got, want, add == "PLUS")
    assert not bool(has[7]) and float(got[7]) == init
