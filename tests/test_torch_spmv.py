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


# The first nine hold the templated instances' semirings and a few of the
# generic family's; the rest are more of the generic family's (on the card;
# here each takes kernel 1's plain version): every built-in mul, u32, and the
# bitwise, logical and MULT adds of i32 and u32.
SEMIRINGS = [
    ("MULT", "PLUS", "FLOAT", 0),
    ("PLUS", "MIN", "FLOAT", np.inf),
    ("MIN", "MAX", "FLOAT", -np.inf),
    ("SECOND", "MIN", "FLOAT", np.inf),  # vxm swaps the operands
    ("MINUS", "PLUS", "FLOAT", 0),  # not commutative: vxm's product order, swapped at run time on the card
    ("MULT", "PLUS", "INT", 0),
    ("FIRST", "MAX", "INT", np.iinfo(np.int32).min),
    ("BAND", "BOR", "INT", 0),  # the reference BFS semiring: a bitwise add (segmented-scan fold here)
    ("MULT", "PLUS", "UINT", 0),
    ("MINUS", "MIN", "FLOAT", np.inf),
    ("DIV", "MAX", "FLOAT", -np.inf),
    ("MINUS_POW2", "PLUS", "FLOAT", 0),
    ("LAND", "MAX", "FLOAT", 0),
    ("DIV", "PLUS", "INT", 0),  # zero divisors in x: XLA's x / 0
    ("BONE", "BXOR", "INT", 0),
    ("MINUS_POW2", "LOR", "INT", 0),
    ("MIN", "MAX", "UINT", 0),
    ("LAND", "LOR", "UINT", 0),
    ("DIV", "MULT", "UINT", 1),
    ("BXOR", "BAND", "UINT", np.uint32(np.iinfo(np.uint32).max)),
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


# (mul, add, type): spla_tpu's Pallas dispatch runs each (its int-native path
# for the integers), and kernel 1's generic family on the card
FORCED_GENERIC = [("BAND", "BOR", "INT"), ("MULT", "PLUS", "UINT"), ("MINUS", "MIN", "FLOAT")]


@pytest.mark.parametrize("mul,add,tname", FORCED_GENERIC)
def test_forced_pallas_dispatch_matches_generic_semirings(monkeypatch, mul, add, tname):
    """spla_tpu's mxv_masked on semirings that the port serves with kernel 1's
    generic family: its DISPATCH_STATS show the Pallas path (interpret mode,
    forced as tests/test_spmv.py forces it), and the port's result equals
    it (MINUS/MIN bitwise: a MIN fold of exact differences)."""
    from spla_tpu.pallas.cellpack_native import _native_lib

    if _native_lib() is None:
        pytest.skip("no native toolchain for spla_tpu's packer")
    monkeypatch.setenv("SPLA_FORCE_PALLAS_DISPATCH", "1")
    init = np.inf if add == "MIN" else 0
    a, JA = _matrix(tname, init, seed=12, n=256)
    jv = _vector(tname, init, seed=13, n=256)
    jmask = JDenseVec(jnp.asarray((np.arange(256) % 3 != 0).astype(np.float32)), jnp.float32(0))
    jt, tt = getattr(JOP, tname), getattr(OP, tname)
    before = JS.DISPATCH_STATS["mxv_pallas"]
    want = JS.mxv_masked(jmask, JA, jv, JOP.lookup(mul, jt), JOP.lookup(add, jt), JOP.NQZERO_FLOAT, init)
    assert JS.DISPATCH_STATS["mxv_pallas"] == before + 1
    assert K1.pull_codes(OP.lookup(mul, tt), OP.lookup(add, tt), tt.dtype) is not None
    got = TS.mxv_masked(from_spla_tpu(jmask, "cpu"), from_spla_tpu(JA, "cpu"), from_spla_tpu(jv, "cpu"),
                        OP.lookup(mul, tt), OP.lookup(add, tt), OP.NQZERO_FLOAT, init)
    _close(got.values, want.values, False)


def _jax_gates():
    """For each (mul, add, type) of the op tables: whether spla_tpu's Pallas
    path takes it in mxv_masked, mxmT_masked (and its tc reduce, PLUS only)
    and mxm, read from the JAX package's own gates."""
    from spla_tpu.ops.spgemm import _MXMT_IDENT, _MXMT_INT_MULS
    from spla_tpu.pallas.spmv import _SCATTER_MONOIDS

    for tname in ("FLOAT", "INT", "UINT"):
        jt = getattr(JOP, tname)
        binary = [o for o in JOP.BUILTIN_OPS.values() if isinstance(o, JOP.OpBinary) and o.type is jt]
        for jm in binary:
            for ja in binary:
                if tname == "FLOAT":
                    mxv = ja.scatter in _SCATTER_MONOIDS  # pallas_spmv_fn: any mul
                else:
                    mxv = ja.identity is not None and ja.associative  # the int-native path
                mxmt = ja.scatter in _MXMT_IDENT and (tname == "FLOAT" or jm.name in _MXMT_INT_MULS)
                mxm = tname == "FLOAT" and ja.scatter in _SCATTER_MONOIDS  # the f32-only ESC path
                yield tname, jm.name, ja.name, mxv, mxmt, mxm


def test_kernel_gates_are_the_jax_pallas_gates():
    """pull_codes, masked_codes, reduce_codes and mxm_codes hold kernel codes
    exactly where spla_tpu sends the request to Pallas; the one exception is
    kernel 9's i32 instances (the six templated muls with PLUS, MIN or MAX),
    which the port had before its JAX counterpart's gate was matched."""
    from spla_tpu_torch.kernels import mxmt as K45, spgemm as K9

    templated = {"PLUS", "MULT", "FIRST", "SECOND", "MIN", "MAX"}
    for tname, mul, add, mxv, mxmt, mxm in _jax_gates():
        tt = getattr(OP, tname)
        om, oa, dtype = OP.lookup(mul, tt), OP.lookup(add, tt), tt.dtype
        case = f"{mul}/{add} {tname}"
        assert (K1.pull_codes(om, oa, dtype) is not None) == mxv, case
        assert (K1.pull_codes(om, oa, dtype, swap=True) is not None) == mxv, case
        assert (K45.masked_codes(om, oa, dtype) is not None) == mxmt, case
        # struct_only: any mul (spla_tpu skips its int mul gate)
        assert (K45.masked_codes(om, oa, dtype, struct_only=True) is not None) == (oa.scatter in ("add", "min", "max"))
        if add == "PLUS":
            assert (K45.reduce_codes(om, dtype) is not None) == mxmt, case
        i32_exception = tname == "INT" and mul in templated and add in ("PLUS", "MIN", "MAX")
        assert (K9.mxm_codes(om, oa, dtype) is not None) == (mxm or i32_exception), case
    user = OP.OpBinary.make("USER", OP.FLOAT, lambda a, b: a * b)
    assert K1.pull_codes(user, OP.PLUS_FLOAT, torch.float32) is None
    assert K9.mxm_codes(user, OP.PLUS_FLOAT, torch.float32) is None


def test_mxv_masked_int_div_matches_spla_tpu():
    """INT DIV in the SpMV: zero divisors and INT_MIN / -1 give XLA's answers
    (spla_tpu's lax.div), not a crash."""
    n = 64
    rng = np.random.default_rng(14)
    a = sp.random(n, n, density=0.2, random_state=15, dtype=np.float32).tocsr()
    a.data = rng.choice(np.array([np.iinfo(np.int32).min, -7, 9, 2**31 - 1], np.int64), a.nnz).astype(np.float64)
    a = a.astype(np.int64).astype(np.int32)
    JA = JF.csr_from_scipy(a, fill=np.int32(0))
    x = rng.choice(np.array([0, -1, 1, 3], np.int32), n)
    jv = JDenseVec(jnp.asarray(x), jnp.int32(5))
    jmask = JDenseVec(jnp.ones(n, jnp.float32), jnp.float32(0))
    for add in ("PLUS", "BXOR", "MAX"):
        want = JS.mxv_masked(jmask, JA, jv, JOP.DIV_INT, JOP.lookup(add, JOP.INT), JOP.NQZERO_FLOAT, 0)
        got = TS.mxv_masked(from_spla_tpu(jmask, "cpu"), from_spla_tpu(JA, "cpu"), from_spla_tpu(jv, "cpu"),
                            OP.DIV_INT, OP.lookup(add, OP.INT), OP.NQZERO_FLOAT, 0)
        _close(got.values, want.values, False)


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


def _packbits_oracle(valid):
    """numpy's little-endian packbits over words of 32 bits, as int32."""
    n = valid.size
    padded = np.concatenate([valid, np.zeros(-n % 32, dtype=bool)])
    return np.packbits(padded, bitorder="little").view("<u4").astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("kind", ["none", "all", "random"])
@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1000, (1 << 16) + 5])
def test_pack_valid_bits_plain_matches_packbits(n, kind):
    """Kernel 1's bitmap of x_valid (bit j & 31 of word j >> 5, 0 past n)
    against numpy's packbits; pack_valid_bits takes the plain version on CPU
    tensors and writes its out in place."""
    valid = {"none": np.zeros(n, dtype=bool), "all": np.ones(n, dtype=bool),
             "random": np.random.default_rng(n).random(n) < 0.5}[kind]
    want = _packbits_oracle(valid)
    got = K1.pack_valid_bits_plain(torch.from_numpy(valid))
    assert got.dtype == torch.int32 and got.shape == ((n + 31) // 32,)
    np.testing.assert_array_equal(got.numpy(), want)
    out = torch.full(((n + 31) // 32,), -7, dtype=torch.int32)
    assert K1.pack_valid_bits(torch.from_numpy(valid), out=out) is out
    np.testing.assert_array_equal(out.numpy(), want)
