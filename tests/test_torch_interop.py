"""spla_tpu_torch: the package's guards, its containers, ops, formats and
segment folds against spla_tpu on the same numpy inputs, and interop."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import spla_tpu.formats as JF
import spla_tpu.op as JOP
from spla_tpu.containers import DenseVec as JDenseVec
from spla_tpu.utils.primitives import prefix_sum as j_prefix_sum, sort_by_key as j_sort_by_key
from spla_tpu.utils.segments import segment_fold as j_segment_fold

import spla_tpu_torch as S
from spla_tpu_torch import formats as F, op as OP
from spla_tpu_torch.interop import from_spla_tpu, to_numpy
from spla_tpu_torch.kernels import level_update as K3, spmv as K1, traversal as K2
from spla_tpu_torch.kernels.build import BuildError, load_library
from spla_tpu_torch.utils.primitives import prefix_sum, sort_by_key
from spla_tpu_torch.utils.segments import segment_fold

REPO = Path(__file__).resolve().parents[1]


def _run(code, **env):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120, env={**os.environ, **env})


# ---------------------------------------------------------------- guards


def test_import_leaves_jax_and_spla_tpu_out():
    r = _run("import sys, spla_tpu_torch, spla_tpu_torch.algorithms, spla_tpu_torch.ops\n"
             "import spla_tpu_torch.facade, spla_tpu_torch.schedule, spla_tpu_torch.profiling\n"
             "import spla_tpu_torch.__main__, spla_tpu_torch.examples.pi, spla_tpu_torch.examples.convert\n"
             "import spla_tpu_torch.interop, spla_tpu_torch.library, spla_tpu_torch.op\n"
             "spla_tpu_torch.Matrix, spla_tpu_torch.Scalar, spla_tpu_torch.MtxLoader, spla_tpu_torch.Timer\n"
             "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
             " or m == 'spla_tpu' or m.startswith('spla_tpu.')]\n"
             "assert not bad, bad\n")
    assert r.returncode == 0, r.stderr


def test_kernel_modules_import_without_triton_or_nvcc(tmp_path):
    # no nvcc on PATH, CUDA_HOME pointing nowhere: importing builds nothing
    r = _run("import sys\n"
             "import spla_tpu_torch.kernels.build, spla_tpu_torch.kernels.spmv\n"
             "import spla_tpu_torch.kernels.traversal, spla_tpu_torch.kernels.level_update\n"
             "assert 'triton' not in sys.modules\n",
             PATH=os.path.dirname(sys.executable), CUDA_HOME=str(tmp_path))
    assert r.returncode == 0, r.stderr


def test_chip_smoke_fails_without_a_card():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                       text=True, timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(BuildError):
        load_library()


def test_kernel_codes_match_the_cuda_enum():
    src = (REPO / "spla_tpu_torch/kernels/csrc/semiring.cuh").read_text()
    codes = dict(re.findall(r"KC_(\w+) = (\d+)", src))
    assert {k: int(v) for k, v in codes.items()} == {c.name: c.value for c in OP.KernelCode}
    dts = dict(re.findall(r"DT_(\w+) = (\d+)", src))
    assert {int(dts["F32"]): torch.float32, int(dts["I32"]): torch.int32, int(dts["U32"]): torch.uint32} == \
        {v: k for k, v in K1.DTYPE_CODES.items()}


def _meta_csr():
    a = sp.random(8, 8, density=0.3, random_state=0, dtype=np.float32)
    return F.csr_from_scipy(a, device="meta")


@pytest.mark.parametrize("op_mul,op_add", [
    (OP.OpBinary.make("USER", OP.FLOAT, lambda a, b: a - b), OP.PLUS_FLOAT),  # a user mul: no kernel
    (OP.MULT_FLOAT, OP.LOR_FLOAT),     # add the kernels do not cover in f32
])
def test_cuda_wrappers_raise_on_uncovered_requests(op_mul, op_add):
    A = _meta_csr()
    x = torch.empty(8, device="meta")
    with pytest.raises(NotImplementedError):
        K1.spmv_pull(A, x, op_mul, op_add, 0.0)
    with pytest.raises(NotImplementedError):
        K2.spmv_push(A, torch.empty(2, dtype=torch.int32, device="meta"), x, op_mul, op_add, 0.0)


def test_cuda_wrappers_raise_off_the_card():
    # a covered request on a non-CPU, non-CUDA tensor raises; no fallback
    A = _meta_csr()
    x = torch.empty(8, device="meta")
    with pytest.raises(ValueError):
        K1.spmv_pull(A, x, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0)
    with pytest.raises(NotImplementedError):  # PLUS is not an idempotent push monoid
        K2.spmv_push(A, torch.empty(2, dtype=torch.int32, device="meta"), x, OP.PLUS_FLOAT,
                     OP.PLUS_FLOAT, 0.0)
    with pytest.raises(ValueError):
        K3.sssp_level_update(x, x, torch.empty(8, dtype=torch.bool, device="meta"),
                             torch.empty(8, dtype=torch.int32, device="meta"),
                             torch.empty(1, dtype=torch.int32, device="meta"))


# ---------------------------------------------------------------- types and ops


def test_types_match():
    from spla_tpu import types as JT

    for t in S.types.TYPES:
        jt = getattr(JT, t.name)
        assert (t.code, t.np_dtype) == (jt.code, jt.np_dtype)
        assert S.type_from_dtype(t.dtype) is t and S.type_from_dtype(t.np_dtype) is t


_INPUTS = {
    "INT": (np.array([-7, -1, 1, 3, 5, 100], np.int32), np.array([2, 3, -4, 1, 7, -9], np.int32)),
    "UINT": (np.array([1, 2, 3, 5, 7, 4000000000], np.uint32),
             np.array([2, 3, 4, 1, 7, 9], np.uint32)),
    "FLOAT": (np.array([-2.5, -1.0, 0.5, 1.5, 3.0, 0.25], np.float32),
              np.array([0.5, 2.0, -3.0, 1.5, -0.75, 4.0], np.float32)),
}


@pytest.mark.parametrize("key", sorted(JOP.BUILTIN_OPS))
def test_builtin_op_matches_spla_tpu(key):
    """Every built-in op, on the same inputs (floats within 1e-6: libm
    and XLA differ in the last bit of transcendental functions)."""
    jop, top = JOP.BUILTIN_OPS[key], OP.BUILTIN_OPS[key]
    assert type(jop).__name__ == type(top).__name__
    a, b = _INPUTS[jop.type.name]
    if isinstance(jop, JOP.OpBinary):
        args = (a, b)
        assert top.associative == jop.associative and top.commutative == jop.commutative
        assert top.scatter == jop.scatter
        assert (top.identity is None) == (jop.identity is None)
        if jop.identity is not None:
            assert np.asarray(top.identity) == np.asarray(jop.identity)
    else:
        args = (a,)
    want = np.asarray(jop(*(jnp.asarray(x) for x in args)))
    got = to_numpy(top(*(torch.from_numpy(x.copy()) for x in args)))
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)
    else:
        np.testing.assert_array_equal(got, want)


_I32, _U32 = np.iinfo(np.int32), np.iinfo(np.uint32)
_EDGES = {
    "INT": np.array([0, 1, -1, _I32.min, _I32.max], np.int32),
    "UINT": np.array([0, 1, _U32.max], np.uint32),
    # normal-range values only: XLA on the CPU flushes f32 subnormals
    # (test_pin_port_keeps_f32_subnormals), and no pair here makes one
    "FLOAT": np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 0.5, -2.5, 3.0, 100.0],
                      np.float32),
}
_TRANSCENDENTAL = {"SIN", "COS", "TAN", "ASIN", "ACOS", "ATAN", "EXP", "LOG"}


def _ulp_line(x):
    """f32 values as int64 points on a line where neighbouring floats are 1 apart."""
    i = x.view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


@pytest.mark.parametrize("key", sorted(JOP.BUILTIN_OPS))
def test_builtin_op_edges_match_spla_tpu(key):
    """Every built-in op on its type's edges (every pair of them for a
    binary op): 0, +-1, INT_MIN and INT_MAX; 0, 1 and UINT_MAX; 0, -0.0,
    +-inf, NaN and normal floats.  Bitwise (NaN where NaN, any payload),
    but within 2 ulp for the transcendental ops."""
    jop, top = JOP.BUILTIN_OPS[key], OP.BUILTIN_OPS[key]
    e = _EDGES[jop.type.name]
    args = (np.repeat(e, e.size), np.tile(e, e.size)) if isinstance(jop, JOP.OpBinary) else (e,)
    want = np.asarray(jop(*(jnp.asarray(x) for x in args)))
    got = to_numpy(top(*(torch.from_numpy(x.copy()) for x in args)))
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype != np.float32:
        np.testing.assert_array_equal(got, want)
        return
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    if jop.name in _TRANSCENDENTAL:
        assert np.abs(_ulp_line(got[~nan]) - _ulp_line(want[~nan])).max(initial=0) <= 2
    else:
        np.testing.assert_array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))


def test_pin_port_keeps_f32_subnormals():
    """A deliberate difference: XLA on the CPU flushes f32 subnormals to
    zero, in inputs and outputs (the TPU has none); torch keeps IEEE
    subnormals, and the kernels are built without -ftz."""
    x, y = np.array([1e-38], np.float32), np.array([1.5], np.float32)

    def both(name, *args):
        j = np.asarray(JOP.lookup(name, JOP.FLOAT)(*(jnp.asarray(a) for a in args)))
        t = to_numpy(OP.lookup(name, OP.FLOAT)(*(torch.from_numpy(a) for a in args)))
        return j, t

    j, t = both("MULT", x, y)
    assert j[0] == 0 and t[0] == x[0] * y[0] and t[0] > 0
    j, t = both("SQRT", x)
    assert j[0] == 0 and t[0] == np.sqrt(x[0]) and t[0] > 0
    j = np.asarray(JOP.GTZERO_FLOAT(jnp.asarray(x)))
    t = to_numpy(OP.GTZERO_FLOAT(torch.from_numpy(x)))
    assert not j[0] and t[0]


@pytest.mark.parametrize("tname", ["INT", "UINT"])
def test_int_div_is_xla_division(tname):
    """INT and UINT DIV bitwise equal to spla_tpu's lax.div: x / 0 all ones,
    INT_MIN / -1 INT_MIN, toward zero otherwise (C++ would trap or be
    undefined on the first two)."""
    dt = np.int32 if tname == "INT" else np.uint32
    lo, hi = np.iinfo(dt).min, np.iinfo(dt).max
    a = np.array([7, 7, 0, lo, lo, hi, hi, 9, 5, 1], dt)
    b = np.array([0, 2, 0, 0, 1, 0, 3, 9, 7, 1], dt)
    if tname == "INT":
        a = np.concatenate([a, np.array([lo, -7, -7, 7, lo], dt)])
        b = np.concatenate([b, np.array([-1, 2, -2, -2, 2], dt)])
    want = np.asarray(JOP.lookup("DIV", getattr(JOP, tname))(jnp.asarray(a), jnp.asarray(b)))
    top = OP.lookup("DIV", getattr(OP, tname))
    np.testing.assert_array_equal(to_numpy(top(torch.from_numpy(a), torch.from_numpy(b))), want)
    for i in range(a.size):  # scalars broadcast against tensors too
        np.testing.assert_array_equal(to_numpy(top(torch.from_numpy(a[i:i + 1]), int(b[i]))), want[i:i + 1])


def test_kernel_codes_only_on_covered_ops():
    """Every built-in binary op carries its KernelCode (the kernels' gates
    choose the requests); a user op carries none."""
    for key, o in OP.BUILTIN_OPS.items():
        if not isinstance(o, OP.OpBinary):
            continue
        assert o.kernel_code == OP.KernelCode[o.name], key
    assert OP.OpBinary.make("USER", OP.INT, lambda a, b: a | b).kernel_code is None


# ---------------------------------------------------------------- interop and formats


def _jax_graph(seed=0, n=60, fill=0.0):
    a = sp.random(n, n, density=0.1, random_state=seed, dtype=np.float32)
    return a, JF.csr_from_scipy(a, fill=np.float32(fill), capacity=a.nnz + 5)


@pytest.mark.parametrize("kind", ["csr", "coo", "dense", "sparse", "scalar"])
def test_from_spla_tpu_round_trip(kind):
    from spla_tpu.containers import Scalar as JScalar

    a, A = _jax_graph()
    obj = {
        "csr": A,
        "coo": JF.csr_to_coo(A),
        "dense": JDenseVec(jnp.arange(60, dtype=jnp.float32), jnp.float32(3)),
        "sparse": JF.dense_to_sparse_vec(JDenseVec(jnp.arange(60, dtype=jnp.int32) % 4,
                                                    jnp.int32(0)), capacity=50),
        "scalar": JScalar.of(7, jnp.int32),
    }[kind]
    port = from_spla_tpu(obj, "cpu")
    assert type(port).__name__ == type(obj).__name__
    got = to_numpy(port)
    for name, val in got.items():
        want = getattr(obj, name)
        if name in ("shape", "n"):
            assert val == want
        else:
            np.testing.assert_array_equal(val, np.asarray(want))
            assert val.dtype == np.asarray(want).dtype


def test_csr_from_numpy_and_vectors():
    from spla_tpu_torch.interop import csr_from_numpy, dense_from_numpy, sparse_vec_from_numpy

    a, A = _jax_graph(1)
    P = csr_from_numpy(A.shape, A.indptr, A.cols, A.values, A.row_ids, A.nnz, A.fill, "cpu")
    ref = from_spla_tpu(A, "cpu")
    for f in ("indptr", "cols", "values", "row_ids", "nnz", "fill"):
        assert torch.equal(getattr(P, f), getattr(ref, f))
    d = dense_from_numpy(np.arange(5, dtype=np.float32), 0, "cpu")
    assert d.fill.dtype == torch.float32 and d.n == 5
    s = sparse_vec_from_numpy(9, [1, 4, 9], [2, 3, 0], 2, 0, "cpu")
    assert int(s.nnz) == 2 and s.capacity == 3


def test_csr_from_entries_duplicate_reduce():
    rng = np.random.default_rng(2)
    rows, cols = rng.integers(0, 20, 200), rng.integers(0, 20, 200)
    vals = rng.integers(-5, 5, 200).astype(np.int32)
    for reduce in (None, "plus"):
        jfn = None if reduce is None else (lambda x, y: x + y)
        J = JF.csr_from_entries((20, 20), rows, cols, vals, dtype=np.int32, reduce_fn=jfn)
        T = F.csr_from_entries((20, 20), rows, cols, vals, dtype=np.int32, reduce_fn=jfn,
                               device="cpu")
        for f in ("indptr", "cols", "values", "row_ids", "nnz", "fill"):
            np.testing.assert_array_equal(to_numpy(getattr(T, f)), np.asarray(getattr(J, f)))


def test_csr_transpose_and_cache():
    a, A = _jax_graph(3)
    T = F.csr_transpose_host(from_spla_tpu(A, "cpu"))
    JT = JF.csr_transpose_host(A)
    assert int(T.nnz) == int(JT.nnz)
    np.testing.assert_array_equal(to_numpy(T.indptr), np.asarray(JT.indptr))
    for f in ("cols", "values", "row_ids"):
        np.testing.assert_array_equal(to_numpy(getattr(T, f))[: int(JT.nnz)],
                                      np.asarray(getattr(JT, f))[: int(JT.nnz)])
    P = F.csr_from_scipy(a, device="cpu")
    assert F.transpose_of(P) is F.transpose_of(P)
    np.testing.assert_array_equal(to_numpy(F.transpose_of(P).indptr), np.asarray(JT.indptr))


def test_vector_conversions_match():
    vals = np.array([0, 3, 0, 0, 5, 1, 0, 2], np.int32)
    jd = JDenseVec(jnp.asarray(vals), jnp.int32(0))
    td = S.DenseVec(torch.from_numpy(vals), torch.tensor(0, dtype=torch.int32))
    for cap in (None, 2):
        js, ts = JF.dense_to_sparse_vec(jd, capacity=cap), F.dense_to_sparse_vec(td, capacity=cap)
        for f in ("indices", "values", "nnz"):
            np.testing.assert_array_equal(to_numpy(getattr(ts, f)), np.asarray(getattr(js, f)))
        np.testing.assert_array_equal(to_numpy(F.sparse_to_dense_vec(ts).values),
                                      np.asarray(JF.sparse_to_dense_vec(js).values))


# ---------------------------------------------------------------- segment folds


@pytest.mark.parametrize("name,tname,sorted_ids", [
    ("PLUS", "FLOAT", True), ("MIN", "FLOAT", True), ("MAX", "INT", True), ("MULT", "INT", True),
    ("PLUS", "UINT", True), ("MIN", "UINT", False),
    ("LOR", "INT", True), ("BOR", "INT", False), ("BAND", "UINT", True), ("BXOR", "INT", True),
])
def test_segment_fold_matches_spla_tpu(name, tname, sorted_ids):
    """Scatter path (PLUS/MULT/MIN/MAX) and segmented-scan path (the rest).
    Float PLUS within 1e-5 (summation order); everything else bitwise."""
    rng = np.random.default_rng(4)
    k, m = 300, 40
    seg = rng.integers(0, m + 1, k)
    if sorted_ids:
        seg = np.sort(seg)
    seg = seg.astype(np.int32)
    valid = rng.random(k) < 0.8
    dt = {"FLOAT": np.float32, "INT": np.int32, "UINT": np.uint32}[tname]
    vals = (rng.random(k) * 9).astype(dt) if tname == "FLOAT" else rng.integers(0, 9, k).astype(dt)
    jop, top = JOP.lookup(name, getattr(JOP, tname)), OP.lookup(name, getattr(OP, tname))
    init = jop.identity if jop.identity is not None else dt(0)
    fold = jax.jit(j_segment_fold, static_argnums=(3, 4, 5), static_argnames=("sorted_ids",))
    jout, jhas = fold(jnp.asarray(vals), jnp.asarray(seg), jnp.asarray(valid), m, jop, init,
                      sorted_ids=sorted_ids)
    tout, thas = segment_fold(torch.from_numpy(vals), torch.from_numpy(seg),
                              torch.from_numpy(valid), m, top, init, sorted_ids=sorted_ids)
    np.testing.assert_array_equal(to_numpy(thas), np.asarray(jhas))
    if tname == "FLOAT" and name == "PLUS":
        np.testing.assert_allclose(to_numpy(tout), np.asarray(jout), rtol=1e-5)
    else:
        np.testing.assert_array_equal(to_numpy(tout), np.asarray(jout))


def test_prefix_sum_and_sort_by_key_match():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 100, 50).astype(np.int32)
    np.testing.assert_array_equal(to_numpy(prefix_sum(torch.from_numpy(x))),
                                  np.asarray(j_prefix_sum(jnp.asarray(x))))
    keys = rng.integers(0, 10, 50).astype(np.int32)
    got = sort_by_key(torch.from_numpy(keys), torch.from_numpy(x))
    want = j_sort_by_key(jnp.asarray(keys), jnp.asarray(x))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
