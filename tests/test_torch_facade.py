"""spla_tpu_torch.facade against spla_tpu.facade on the same seeded inputs.

Each test runs one body through both packages (``both``): the JAX facade
on its XLA path on the CPU, as tests/test_facade.py runs it, and the port
on CPU tensors, under ``set_force_no_acceleration(True)`` (the reference
API's way to ask for the CPU) or with ``device="cpu"``.  Results are
compared with ``same``: bitwise for integer, MIN/MAX and structural
results, within rtol 1e-5 for f32 PLUS (and MULT) folds (``close``).  The
tests cover every facade method of tests/test_facade.py, the pyspla
README's BFS and bench_suite.py's facade chain at n = 2^10, the interop
constructors, and the three reference facade faults the port does not
copy (``test_pin_*``).
"""

import ctypes

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import spla_tpu
import spla_tpu.facade as JF
import spla_tpu.types as JT

import spla_tpu_torch
import spla_tpu_torch.facade as TF
import spla_tpu_torch.types as TT
from spla_tpu_torch import interop, library as L
from spla_tpu_torch import ops as TO
from spla_tpu_torch.tools.graphs import random_graph

PKGS = ((JF, JT), (TF, TT))


@pytest.fixture(autouse=True)
def on_the_cpu():
    """The port's facade objects made with no device= live on the CPU."""
    lib = L.get_library()
    lib.set_force_no_acceleration(True)
    yield
    lib.set_force_no_acceleration(False)


def both(body):
    """``body(facade, types)`` run through spla_tpu and the port."""
    return [body(f, t) for f, t in PKGS]


def same(got, want, close=False):
    """Equal nested results: arrays and numbers bitwise (dtype included), or
    within rtol 1e-5 of each other with ``close``."""
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w, close)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            same(got[k], want[k], close)
    elif isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype, w.shape, w.dtype)
        if close:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w)
    elif close and isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-5, abs=1e-6)
    else:
        assert got == want and type(got) is type(want), (got, want)


def check(body, close=False):
    j, t = both(body)
    same(t, j, close)
    return t


def check_folds(body, close):
    """``body`` returns ``(exact, folds)``: the first part is compared
    bitwise, the second (f32 PLUS / MULT folds) within rtol 1e-5 when
    ``close``."""
    j, t = both(body)
    same(t[0], j[0])
    same(t[1], j[1], close)
    return t


def rand_lists(seed, n, k, dtype, lo=-5, hi=5, m=None):
    """Seeded (rows, cols, vals) of k entries in an m x n matrix (rows only
    when m is None), duplicates included."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, k)
    vals = (rng.uniform(lo, hi, k) if dtype == "f" else rng.integers(lo, hi + 1, k))
    vals = vals.astype(np.float32 if dtype == "f" else np.int32)
    if m is None:
        return idx, vals
    return rng.integers(0, m, k), idx, vals


def mat(f, t, seed, shape=(40, 30), k=150, dtype="i", lo=-5, hi=5):
    r, c, v = rand_lists(seed, shape[1], k, dtype, lo, hi, m=shape[0])
    return f.Matrix.from_lists(r, c, v, shape, t.FLOAT if dtype == "f" else t.INT)


def vec(f, t, seed, n=30, k=12, dtype="i", lo=-5, hi=5, fill=0):
    i, v = rand_lists(seed, n, k, dtype, lo, hi)
    return f.Vector.from_lists(i, v, n, t.FLOAT if dtype == "f" else t.INT, fill_value=fill)


def state(x):
    """What a facade object holds: its entries, fill and dense form."""
    return (*x.read(), x.fill_value.get(), x.to_numpy())


# ---------------------------------------------------------------- Scalar, Array, MemView


def test_scalar():
    def body(f, t):
        s = f.Scalar.make_int(5)
        g = f.Scalar(t.FLOAT, 1.5)
        return (s.as_int(), s.as_float(), (s + 2).as_int(), (s - 7).as_int(), (s * 3).get(),
                (g / 2).as_float(), f.Scalar.make_float(1.5).as_float(), f.Scalar.from_value(True).get(),
                f.Scalar.from_value(2.5).get(), f.Scalar.make_uint(3).as_uint(), s == 5, str(g), s.n_vals)

    check(body)


def test_array():
    def body(f, t):
        a = f.Array.from_list([1, 2, 3], t.INT)
        out = [a.n_values, a.get(1), a.shape]
        a.set(0, 9)
        a.resize(5)
        out += [a.to_list(), a.empty, repr(a), a.n_vals]
        b = f.Array(t.FLOAT)
        b.build(f.MemView(np.arange(4, dtype=np.float32)))
        out += [b.to_numpy(), b.read().to_numpy(), f.Array.rand(t.INT, 6, seed=3, dist=(1, 9)).to_list(),
                f.Array.rand(t.FLOAT, 4, seed=3).to_numpy()]
        a.clear()
        return out + [a.empty]

    check(body)


def test_memview_roundtrip():
    def body(f, t):
        a = np.arange(8, dtype=np.int32)
        v = f.MemView.make(a)
        raw = bytes(v.read())
        v.write(0, raw[4:8] + raw[0:4] + raw[8:])
        ro = np.arange(4, dtype=np.int32)
        ro.setflags(write=False)
        return v.size, a, np.asarray(v), v.is_mutable, f.MemView.make(ro).is_mutable, bytes(v.read(4, 8))

    check(body)


def test_memview_rejects_noncontiguous_write():
    for f, _ in PKGS:
        mv = f.MemView(np.arange(10)[::2])
        assert mv.to_numpy().tolist() == [0, 2, 4, 6, 8]
        with pytest.raises(ValueError):
            mv.write(0, b"\x01")


# ---------------------------------------------------------------- Vector


def test_vector_set_get_build():
    def body(f, t):
        v = f.Vector(5, t.INT)
        v.set_format(f.FormatVector.ACC_DENSE)
        v.set(1, 10)
        v.set(3, 30)
        out = [v.get(1), v.get(3), v.get(0), *v.read(), list(v), v.shape, v.n_rows, v.dtype.name]
        w = f.Vector(4, t.FLOAT)
        w.build(f.MemView(np.array([0, 2])), f.MemView(np.array([1.5, 2.5], np.float32)))
        return out + [w.get(2), *state(w)]

    check(body)


@pytest.mark.parametrize("reduce_op", ["PLUS", "MULT", "MIN", "MAX", None])
def test_vector_duplicates_reduce(reduce_op):
    def body(f, t):
        v = f.Vector(12, t.INT)
        if reduce_op:
            v.set_reduce(getattr(t.INT, reduce_op))
        i, x = rand_lists(4, 12, 40, "i", 1, 9)
        for a, b in zip(i, x):
            v.set(int(a), int(b))
        return state(v)

    check(body)


def test_vector_get_set_reduce_variants():
    def body(f, t):
        v = f.Vector.from_lists([3, 1, 3], [10, 5, 7], (6,), t.INT)
        return v.get(3), v.get(1), v.to_lists()

    check(body)


@pytest.mark.parametrize("dtype", ["i", "f"])
def test_vector_eadd_emult_map_reduce(dtype):
    def body(f, t):
        T = t.FLOAT if dtype == "f" else t.INT
        u, v = vec(f, t, 1, dtype=dtype), vec(f, t, 2, dtype=dtype, fill=1)
        out = [state(u.eadd(T.PLUS, v)), state(u.eadd(T.MIN, v)), state(u.emult(T.MULT, v)),
               state(u.emult(T.MAX, v)), state(u.map(T.AINV)), state(u.map(T.ABS)), u.count_mf(), v.count_mf()]
        folds = []
        for op in ("PLUS", "MIN", "MAX", "MULT"):
            got = [u.reduce(getattr(T, op)).get(), v.reduce(getattr(T, op), init=f.Scalar(T, 3)).get()]
            (folds if op in ("PLUS", "MULT") else out).extend(got)
        return out, folds

    check_folds(body, close=dtype == "f")


def test_vector_assign_masked():
    def body(f, t):
        v = f.Vector.dense(30, t.INT, 2)
        mask = vec(f, t, 5)
        v.assign(mask, f.Scalar.make_int(7), t.INT.SECOND, t.INT.NQZERO)
        w = vec(f, t, 6)
        w.assign(mask, 4, t.INT.PLUS, t.INT.GTZERO)
        return state(v), state(w)

    check(body)


def test_vector_fill_value_semantics():
    def body(f, t):
        v = f.Vector.from_lists([1], [2.5], (4,), t.FLOAT, fill_value=-1.0)
        out = [v.get(0), v.get(1), *state(v)]
        v.set_fill_value(3.0)
        out += [*state(v)]
        v.fill_with(f.Scalar.make_float(0.5))
        return out + [*state(v)]

    check(body)


def test_vector_get_single_element():
    def body(f, t):
        v = f.Vector.from_lists([1, 3], [10, 30], (5,), t.INT)
        w = v.eadd(t.INT.PLUS, v)
        stale = w._host_stale
        return v.get(1), v.get(3), v.get(0), stale, w.get(3), w._host_stale

    assert check(body)[3:] == (True, 60, True)


def test_vector_fill_noize_and_dense():
    def body(f, t):
        a, b = f.Vector.dense(20, t.INT, 3), f.Vector(20, t.FLOAT)
        a.fill_noize(seed=9)
        b.fill_noize(seed=9)
        return state(a), state(b), state(f.Vector.dense(7, t.FLOAT, 1.5))

    check(body)


# ---------------------------------------------------------------- Matrix


def test_matrix_basics():
    def body(f, t):
        M = f.Matrix((3, 3), t.INT)
        M.set_format(f.FormatMatrix.ACC_CSR)
        M.set(0, 1, 5)
        M.set_int(2, 0, 7)
        return (M.get(0, 1), M.get(1, 1), M.get(2, 0), state(M), M.shape, M.n_rows, M.n_cols, list(M),
                M.to_lists(), M.dtype.name)

    check(body)


@pytest.mark.parametrize("reduce_op", ["PLUS", "MIN", None])
def test_matrix_get_set_reduce_variants(reduce_op):
    def body(f, t):
        M = f.Matrix((6, 5), t.INT)
        if reduce_op:
            M.set_reduce(getattr(t.INT, reduce_op))
        r, c, v = rand_lists(8, 5, 40, "i", 1, 9, m=6)
        for a, b, x in zip(r, c, v):
            M.set(int(a), int(b), int(x))
        return state(M)

    check(body)


SEMIRINGS = [("i", "MULT", "PLUS", "NQZERO"), ("i", "PLUS", "MIN", "ALWAYS"), ("i", "LAND", "LOR", "EQZERO"),
             ("i", "MULT", "MAX", "GTZERO"), ("f", "MULT", "PLUS", "ALWAYS"), ("f", "PLUS", "MIN", "NQZERO")]


@pytest.mark.parametrize("dtype,mul,add,sel", SEMIRINGS)
def test_matrix_mxv_and_vxm(dtype, mul, add, sel):
    def body(f, t):
        T = t.FLOAT if dtype == "f" else t.INT
        A = mat(f, t, 10, (30, 30), 200, dtype)
        v, mask = vec(f, t, 11, dtype=dtype), vec(f, t, 12, k=20)
        if dtype == "f":
            mask = f.Vector.from_lists(*mask.read(), 30, T)
        ops = getattr(T, mul), getattr(T, add), getattr(T, sel)
        return (state(A.mxv(mask, v, *ops)), state(v.vxm(mask, A, *ops)),
                state(v.vxm(mask, A, *ops, init=f.Scalar(T, 2))))

    check(body, close=(dtype, add) == ("f", "PLUS"))


@pytest.mark.parametrize("dtype,mul,add", [("f", "MULT", "PLUS"), ("i", "MULT", "PLUS"), ("i", "PLUS", "MIN")])
def test_matrix_mxm(dtype, mul, add):
    def body(f, t):
        T = t.FLOAT if dtype == "f" else t.INT
        A, B = mat(f, t, 13, (20, 25), 80, dtype), mat(f, t, 14, (25, 15), 80, dtype)
        return state(A.mxm(B, getattr(T, mul), getattr(T, add)))

    check(body, close=dtype == "f")


@pytest.mark.parametrize("dtype", ["i", "f"])
def test_matrix_mxmT_masked(dtype):
    def body(f, t):
        T = t.FLOAT if dtype == "f" else t.INT
        A, B = mat(f, t, 15, (20, 25), 100, dtype), mat(f, t, 16, (18, 25), 100, dtype)
        mask = mat(f, t, 17, (20, 18), 150)
        if dtype == "f":
            mask = f.Matrix.from_lists(*mask.read(), (20, 18), T)
        return (state(A.mxmT(mask, B, T.MULT, T.MIN, T.ALWAYS)),
                state(A.mxmT(mask, B, T.MULT, T.PLUS, T.GTZERO)))

    check_folds(body, close=dtype == "f")


def test_matrix_kron_kronpow():
    def body(f, t):
        I2 = f.Matrix.diag((2, 2), t.INT, 1)
        A = mat(f, t, 18, (3, 4), 6)
        return (state(I2.kron(I2, t.INT.MULT)), state(I2.kronpow(3)), state(A.kronpow(2)),
                state(A.kronpow(1)), state(A.kronpow(0)), state(A.kron(I2, t.INT.PLUS)))

    check(body)


@pytest.mark.parametrize("dtype", ["i", "f"])
def test_matrix_reduce_transpose_extract(dtype):
    def body(f, t):
        T = t.FLOAT if dtype == "f" else t.INT
        A = mat(f, t, 19, (20, 30), 120, dtype)
        out = [A.reduce(T.MAX, init=f.Scalar(T, 0)).get(), state(A.reduce_by_column(T.MIN, init=f.Scalar(T, 1))),
               state(A.transpose()), state(A.transpose(op_apply=T.AINV))]
        for i in (0, 7, 19):
            out += [state(A.extract_row(i)), state(A.extract_column(i))]
        return out, [A.reduce(T.PLUS).get(), state(A.reduce_by_row(T.PLUS))]

    check_folds(body, close=dtype == "f")


def test_matrix_eadd_emult():
    def body(f, t):
        A, B = mat(f, t, 20, k=100), mat(f, t, 21, k=100)
        return (state(A.eadd(t.INT.PLUS, B)), state(A.emult(t.INT.MULT, B)), state(A.eadd(t.INT.MIN, B)),
                state(A.emult(t.INT.MAX, B)))

    check(body)


def test_matrix_get_no_densify():
    def body(f, t):
        A = f.Matrix.from_lists([0, 5, 9], [3, 5, 0], [1.5, 2.5, 3.5], shape=(10, 10), dtype=t.FLOAT)
        out = [A.get(0, 3), A.get(5, 5), A.get(9, 0), A.get(4, 4)]
        A.set_fill_value(-1.0)
        return out + [A.get(4, 4), *state(A)]

    check(body)


def test_pretty_print():
    def body(f, t):
        A = mat(f, t, 22, (4, 5), 6)
        B = mat(f, t, 23, (3, 3), 4, "f")
        v = vec(f, t, 24, n=6, k=3, dtype="f")
        return A.to_string(width=3), str(A), B.to_string(cell_sep="|", precision=3), str(v), v.to_string(width=6)

    check(body)


def test_rand_constructors():
    """The same seed gives the same entries in both packages."""
    def body(f, t):
        return (state(f.Matrix.rand((10, 12), t.FLOAT, density=0.3, seed=1)),
                state(f.Matrix.rand((10, 12), t.INT, density=0.2, seed=2, dist=(1, 5))),
                state(f.Vector.rand(10, t.INT, density=0.5, seed=1, dist=(1, 5))),
                state(f.Vector.rand(16, t.FLOAT, density=0.4, seed=3)),
                state(f.Matrix.dense((3, 4), t.INT, 2)))

    check(body)


def test_facade_device_resident_lazy_sync():
    def body(f, t):
        A = f.Matrix.from_lists([0, 1, 2], [1, 2, 0], [1, 2, 3], shape=(3, 3), dtype=t.INT)
        B = A.mxm(A, t.INT.MULT, t.INT.PLUS)
        flags = [B._host_stale, B._csr_cache is not None]
        C = B.mxm(A, t.INT.MULT, t.INT.PLUS)
        flags.append(B._host_stale)  # chaining off a stale result leaves it stale
        out = [C.to_numpy(), *B.read()]
        flags.append(B._host_stale)
        B.set(0, 0, 7)
        return flags, out, B.get(0, 0), state(B)

    flags = check(body)[0]
    assert flags == [True, True, True, False]


def test_op_result_survives_clear_and_rebuild():
    def body(f, t):
        v = f.Vector.from_lists([0, 1], [1.0, 2.0], 4, t.FLOAT)
        m = f.Matrix.from_lists([0, 1], [1, 0], [1.0, 1.0], (4, 4), t.FLOAT)
        r = v.vxm(f.Vector(4, t.FLOAT), m, t.FLOAT.MULT, t.FLOAT.PLUS, t.FLOAT.ALWAYS)
        r.clear()
        r.set(0, 5.0)
        B = m.mxm(m, t.FLOAT.MULT, t.FLOAT.PLUS)
        B.clear()
        B.set(0, 0, 2.0)
        return r.to_list(), B.get(0, 0), state(B)

    check(body)


def test_object_base_and_format_enums():
    for f, t in PKGS:
        for obj in (f.Matrix((2, 2), t.INT), f.Vector((2,), t.INT), f.Scalar(1, t.INT), f.Array(t.INT),
                    f.MemView.make(np.zeros(2, np.int32))):
            assert isinstance(obj, f.Object) and obj.hnd is None
        assert f.Matrix((2, 2), t.INT, label="lbl").label == "lbl"
    for name in ("FormatMatrix", "FormatVector"):
        assert ([(e.name, e.value) for e in getattr(TF, name)] ==
                [(e.name, e.value) for e in getattr(JF, name)])


def test_top_level_surface_has_every_spla_tpu_name():
    """Every name of spla_tpu.__all__ resolves on spla_tpu_torch, to the
    port's own object of that name."""
    missing = [n for n in spla_tpu.__all__ if not hasattr(spla_tpu_torch, n)]
    assert not missing
    assert set(spla_tpu.__all__) <= set(dir(spla_tpu_torch))
    for n in ("Matrix", "Vector", "Array", "MemView", "Object", "FormatMatrix", "FormatVector"):
        assert getattr(spla_tpu_torch, n) is getattr(TF, n)
    assert spla_tpu_torch.MtxLoader is spla_tpu_torch.io.MtxLoader
    assert spla_tpu_torch.OpUnary is spla_tpu_torch.op.OpUnary
    assert spla_tpu_torch.VERSIONS == [spla_tpu_torch.__version__]
    assert spla_tpu_torch.containers.Scalar is not TF.Scalar


# ---------------------------------------------------------------- the slice as a whole


def test_reference_readme_bfs_example():
    """The pyspla README's BFS (reference README.md:59-99) on both packages."""
    def body(f, t):
        def bfs(s, A):
            v = f.Vector(A.n_rows, t.INT)
            front = f.Vector.from_lists([s], [1], A.n_rows, t.INT)
            front_size, depth, count = 1, f.Scalar(t.INT, 0), 0
            while front_size > 0:
                depth += 1
                count += front_size
                v.assign(front, depth, op_assign=t.INT.SECOND, op_select=t.INT.NQZERO)
                front = front.vxm(v, A, op_mult=t.INT.LAND, op_add=t.INT.LOR, op_select=t.INT.EQZERO)
                front_size = front.reduce(op_reduce=t.INT.PLUS).get()
            return v.to_lists(), count, depth.get()

        A = f.Matrix.from_lists([0, 1, 2, 2, 3], [1, 2, 0, 3, 2], [1, 1, 1, 1, 1], shape=(4, 4), dtype=t.INT)
        g = random_graph(300, 4, seed=2).tocoo()
        G = f.Matrix.from_lists(g.row, g.col, np.ones(g.nnz, np.int32), (300, 300), t.INT)
        return bfs(0, A), bfs(5, G)

    out = check(body)
    assert out[0] == (([0, 1, 2, 3], [1, 2, 3, 4]), 4, 4)


def chain_inputs(n, seed=7):
    """bench_suite.py:355-372's facade chain inputs at n: the graph scaled by
    0.85 / in-degree, and the start vector's entries."""
    a = random_graph(n, 8, seed=seed)
    deg = np.asarray(a.sum(axis=0)).ravel()
    s = (a @ sp.diags(0.85 / np.maximum(deg, 1))).tocsr().astype(np.float32).tocoo()
    start = np.arange(0, n, max(n // 1024, 1))
    return s, start


def test_facade_chain():
    """bench_suite.py's facade chain at n = 2^10: ten vxm, then reduce, on
    both packages and against scipy's float64 chain (rtol 1e-5)."""
    s, start = chain_inputs(1 << 10)
    n = s.shape[0]

    def body(f, t):
        M = f.Matrix((n, n), t.FLOAT)
        M.build(f.MemView(s.row), f.MemView(s.col), f.MemView(s.data))
        r = f.Vector.from_lists(start, np.ones(start.size, np.float32), n, t.FLOAT)
        mask = f.Vector(n, t.FLOAT)
        for _ in range(10):
            r = r.vxm(mask, M, t.FLOAT.MULT, t.FLOAT.PLUS, t.FLOAT.ALWAYS)
        return r.to_numpy(), r.reduce(t.FLOAT.PLUS).get()

    got = check(body, close=True)
    x = np.zeros(n)
    x[start] = 1.0
    s64 = s.tocsr().astype(np.float64)
    for _ in range(10):
        x = s64.T @ x
    np.testing.assert_allclose(got[0], x, rtol=1e-5, atol=1e-7)
    assert got[1] == pytest.approx(x.sum(), rel=1e-5)


def test_device_transpose_equals_the_host_transpose():
    """Matrix._device_t (ops.m_transpose on the device) stores the entries
    of formats.csr_transpose_host, for a host-built matrix and an adopted
    result."""
    A = mat(TF, TT, 25, (30, 40), 200, "f")
    B = A.mxm(mat(TF, TT, 26, (40, 30), 200, "f"), TT.FLOAT.MULT, TT.FLOAT.PLUS)
    assert B._host_stale
    for M in (A, B):
        got, want = M._device_t(), TO.m_transpose(M._device(), TT.FLOAT.IDENTITY)
        host = spla_tpu_torch.formats.csr_transpose_host(M._device())
        nnz = int(host.nnz)
        assert got.shape == host.shape and int(got.nnz) == nnz
        assert torch.equal(got.indptr, host.indptr)
        for field in ("cols", "values", "row_ids"):
            assert torch.equal(getattr(got, field)[:nnz], getattr(host, field)[:nnz])
            assert torch.equal(getattr(got, field), getattr(want, field))
    assert B._host_stale  # the transpose read nothing back


# ---------------------------------------------------------------- interop


@pytest.mark.parametrize("dtype,fill", [("i", 3), ("f", -1.5), ("f", 0.0)])
def test_interop_round_trips(dtype, fill):
    """A spla_tpu facade object's read() and fill_value make a port object in
    the same state."""
    JTy = JT.FLOAT if dtype == "f" else JT.INT
    A = mat(JF, JT, 27, (12, 9), 40, dtype)
    A.set_fill_value(fill)
    B = A.mxm(mat(JF, JT, 28, (9, 7), 30, dtype), JTy.MULT, JTy.MIN)
    v = vec(JF, JT, 29, dtype=dtype, fill=fill)
    for J in (A, B):
        T = interop.matrix_from_numpy(J.shape, J.dtype.np_dtype, *J.read(), J.fill_value.get(), "cpu")
        same(state(T), state(J))
        assert T.device == torch.device("cpu")
    T = interop.vector_from_numpy(v.n_rows, getattr(TT, JTy.name), *v.read(), v.fill_value.get(), "cpu")
    same(state(T), state(v))
    back = interop.vector_from_numpy(T.n_rows, TT.INT if dtype == "i" else TT.FLOAT, *T.read(),
                                     T.fill_value.get(), "cpu")
    same(state(back), state(v))


# ---------------------------------------------------------------- the device rule


def test_no_card_and_no_opt_out_raises(monkeypatch):
    L.get_library().set_force_no_acceleration(False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.Matrix((4, 4), TT.FLOAT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.Vector.from_lists([0], [1], 4, TT.INT)
    # asking for the CPU by name needs no opt-out
    assert TF.Vector(4, TT.INT, device="cpu").device == torch.device("cpu")
    L.get_library().set_force_no_acceleration(True)
    assert TF.Matrix((4, 4), TT.FLOAT).device == torch.device("cpu")


def test_operands_on_different_devices_raise():
    u = TF.Vector.from_lists([0], [1], 4, TT.INT)
    v = TF.Vector.from_lists([1], [2], 4, TT.INT, device="meta")
    with pytest.raises(ValueError, match="different devices"):
        u.eadd(TT.INT.PLUS, v)
    with pytest.raises(ValueError, match="different devices"):
        u.map(TT.INT.AINV, out=TF.Vector(4, TT.INT, device="meta"))
    A = TF.Matrix.diag((4, 4), TT.INT)
    assert A.mxv(u, u, TT.INT.MULT, TT.INT.PLUS, TT.INT.ALWAYS).device == torch.device("cpu")


# ---------------------------------------------------------------- reference faults not copied


def test_pin_top_level_scalar_is_the_facade_scalar():
    """pyspla's top-level Scalar is the user-facing one; spla_tpu's is its
    container (spla_tpu/__init__.py:15, ADVICE.md:3)."""
    assert spla_tpu_torch.Scalar is TF.Scalar
    assert spla_tpu_torch.Scalar(TT.INT, 3).get() == 3
    assert spla_tpu.Scalar is spla_tpu.containers.Scalar  # how spla_tpu differs
    assert spla_tpu.Scalar is not JF.Scalar


def test_pin_scalar_and_memview_take_a_label():
    """pyspla's Scalar and MemView take label= (ADVICE.md:4); spla_tpu's do not."""
    assert TF.Scalar(2, TT.INT, label="s").label == "s"
    assert TF.MemView(np.zeros(2), label="m").label == "m"
    with pytest.raises(TypeError):
        JF.Scalar(2, JT.INT, label="s")
    with pytest.raises(TypeError):
        JF.MemView(np.zeros(2), label="m")


def test_pin_memview_buffer_is_a_c_void_p():
    """pyspla's MemView.buffer is a ctypes.c_void_p (ADVICE.md:5); spla_tpu's
    is an int."""
    a = np.arange(4, dtype=np.int32)
    buf = TF.MemView.make(a).buffer
    assert isinstance(buf, ctypes.c_void_p) and buf.value == a.ctypes.data
    assert ctypes.cast(buf, ctypes.POINTER(ctypes.c_int32))[2] == 2
    assert JF.MemView.make(a).buffer == a.ctypes.data and isinstance(JF.MemView.make(a).buffer, int)
