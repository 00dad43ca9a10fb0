"""spla_tpu_torch's public surface against spla_tpu's, on the CPU.

The sweep takes each module's ``__all__`` in spla_tpu and asks the port's
counterpart module for every name in it (and holds the names the port
exports that spla_tpu defines outside its ``__all__``, such as
``formats.WeakIdCache``, the same way).  A class is held against the
port's class of the same name in the counterpart of the module that
defines it (so ``spla_tpu.Scalar``, the container, is held against
``spla_tpu_torch.containers.Scalar``; the port's top-level ``Scalar`` is
the facade's, a reference fault fixed and pinned in
tests/test_torch_facade.py): every public member, fields included, must
exist there.  Every parameter name of a function or method must be in the
port's signature, which may add to it (a keyword-only ``device``, mostly).
What the port leaves out on purpose is in ``BY_DESIGN`` and nowhere else.

The other tests hold the members that pyspla's code reads (the ``Type``
helpers, ``Scalar.of``, ``SparseVec.empty``, ``Descriptor``'s fields,
``identity_array``, ``WeakIdCache.contains``) to spla_tpu's answers.
"""

import ctypes
import dataclasses
import gc
import importlib
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch


import spla_tpu.algorithms as JALG
import spla_tpu.containers as JC
import spla_tpu.descriptor as JD
import spla_tpu.formats as JF
import spla_tpu.op as JOP
import spla_tpu.types as JT

from spla_tpu_torch import algorithms as alg, containers as C, descriptor as D
from spla_tpu_torch import formats as F, op as OP, types as T
from spla_tpu_torch.interop import from_spla_tpu, to_numpy

REPO = Path(__file__).resolve().parents[1]

MODULES = [
    "", "op", "ops", "parallel", "types", "containers", "descriptor", "formats", "io",
    "algorithms", "facade", "schedule", "library", "profiling", "timer", "reorder",
    "utils.primitives", "utils.search", "utils.segments",
    "ops.spmv", "ops.spgemm", "ops.vector", "ops.matrix", "ops.bsr",
    "parallel.mesh", "parallel.dist_cell", "parallel.dist_matrix", "parallel.dist_ops",
    "parallel.dist_spgemm",
]

_CELL = "serves the TPU cell format; ROADMAP.md \"Not ported, by design\""
_SHARD_MAP = ("a shard_map argument: the port's rank holds its block whole; "
              "ROADMAP.md \"Not ported, by design\"")
# a gap's key: "module.name", "module.Class.member" or "module.function(param)",
# the module being the one that defines the object (spla_tpu. cut off)
BY_DESIGN = {
    "reorder.spmv_relabel": _CELL,
    **{f"parallel.dist_cell.ShardedCellSpmv.{m}": _CELL
       for m in ("n_tiles", "n_row_blocks", "fused", "rb_of_tile", "wb_of_batch", "layout")},
    **{f"parallel.dist_matrix.ShardedCsr.local_block({p})": _SHARD_MAP
       for p in ("s_indptr", "s_cols", "s_values", "s_row_ids", "s_nnz")},
}


def _members(cls) -> set:
    names = {n for n in dir(cls) if not n.startswith("_")}
    names |= {n for n in getattr(cls, "__slots__", ()) if not n.startswith("_")}
    if dataclasses.is_dataclass(cls):
        names |= {f.name for f in dataclasses.fields(cls)}
    return names


def _key(obj) -> str:
    """``obj``'s defining module (spla_tpu. cut off) and qualified name."""
    return f"{obj.__module__.removeprefix('spla_tpu.')}.{obj.__qualname__}"


def _counterpart(obj):
    """The port's object of ``obj``'s name in the counterpart of its defining module."""
    return getattr(importlib.import_module(obj.__module__.replace("spla_tpu", "spla_tpu_torch", 1)),
                   obj.__name__)


def _param_gaps(key, ref_fn, port_fn) -> set:
    names = set(inspect.signature(ref_fn).parameters) - set(inspect.signature(port_fn).parameters)
    return {f"{key}({p})" for p in names}


def _gaps(modname: str) -> set:
    ref = importlib.import_module("spla_tpu" + (modname and "." + modname))
    port = importlib.import_module("spla_tpu_torch" + (modname and "." + modname))
    gaps = set()
    # and the names the port exports that spla_tpu has but leaves out of __all__
    shared = [n for n in port.__all__ if n not in ref.__all__
              and getattr(getattr(ref, n, None), "__module__", "").startswith("spla_tpu")]
    for name in [*ref.__all__, *shared]:
        if not hasattr(port, name):
            gaps.add(f"{modname}.{name}".lstrip("."))
            continue
        obj = getattr(ref, name)
        if inspect.isclass(obj):
            twin, key = _counterpart(obj), _key(obj)
            have = _members(twin)
            for m in sorted(_members(obj)):
                if m not in have:
                    gaps.add(f"{key}.{m}")
                elif inspect.isroutine(getattr(obj, m, None)):
                    gaps |= _param_gaps(f"{key}.{m}", getattr(obj, m), getattr(twin, m))
            if not dataclasses.is_dataclass(obj):  # a dataclass's parameters are its fields
                gaps |= _param_gaps(key, obj, twin)
        elif inspect.isfunction(obj):
            gaps |= _param_gaps(_key(obj), obj, getattr(port, name))
    return gaps


@pytest.mark.parametrize("modname", MODULES, ids=[m or "top" for m in MODULES])
def test_port_covers_the_public_surface(modname):
    assert sorted(_gaps(modname) - set(BY_DESIGN)) == []


def test_by_design_entries_are_real_gaps_named_in_the_roadmap():
    """No stale entry: each is a gap the sweep finds, and ROADMAP.md's
    "Not ported, by design" names each of its objects."""
    found = set().union(*(_gaps(m) for m in MODULES))
    assert set(BY_DESIGN) <= found
    road = (REPO / "ROADMAP.md").read_text()
    section = road[road.index("**Not ported, by design**"):]
    section = section[:section.index("\n### ")]
    for key in BY_DESIGN:
        leaf = re.split(r"[.(]", key.rstrip(")"))[-1]
        assert leaf in section, key


# ---------------------------------------------------------------- the pyspla helpers


def test_reference_accessor_surface():
    """tests/test_op.py's accessor test, asked of both packages."""
    assert OP.PLUS_INT.name == "PLUS" and OP.PLUS_INT.dtype_res is T.INT
    assert OP.PLUS_INT.dtype_arg0 is T.INT and OP.PLUS_INT.dtype_arg1 is T.INT
    assert OP.ABS_FLOAT.dtype_arg0 is T.FLOAT
    values = (0, 1, 7, -3, 1.5, -0.25, True, False, np.int64(7), np.float64(2.75),
              ctypes.c_int(9), ctypes.c_float(0.5), ctypes.c_bool(True))
    for t in T.TYPES:
        jt = getattr(JT, t.name)
        assert t.get_code() == jt.get_code() == t.code
        assert (t.is_float(), t.is_integral()) == (jt.is_float(), jt.is_integral())
        for v in values:
            if t is T.UINT and np.asarray(getattr(v, "value", v)) < 0:
                continue  # numpy refuses negative python ints for uint32
            got, want = t.cast_value(v), jt.cast_value(v)
            assert type(got) is type(want) and got == want, (t, v)
            for width, precision in ((2, 2), (4, 3), (7, 1)):
                assert t.format_value(got, width, precision) == jt.format_value(want, width, precision)
    assert T.BOOL.cast_value(1) is True
    assert T.FLOAT.format_value(1.5, width=4, precision=3) == " 1.5"
    assert T.BOOL.format_value(True) == " t" and T.INT.format_value(42, width=4) == "  42"


@pytest.mark.parametrize("v,dtype", [(1.5, None), (3, None), (True, None), (7, np.uint32),
                                     (np.float64(2.0), None), (-4, np.int32), (2.5, np.float32)])
def test_scalar_of_matches_spla_tpu(v, dtype):
    got, want = C.Scalar.of(v, dtype, device="cpu"), JC.Scalar.of(v, dtype)
    assert got.type.name == want.type.name
    assert got.dtype == got.type.dtype and got.value.device.type == "cpu"
    a, b = got.item(), want.item()
    assert type(a) is type(b) and a == b


def test_containers_from_a_fill_match_spla_tpu():
    """SparseVec.empty and DenseVec.full: the same fields, and with no dtype
    the same 32-bit type spla_tpu's jnp.asarray picks."""
    for fill, dtype in ((0.5, None), (0, None), (np.float32(np.inf), None), (3, np.uint32)):
        got, want = C.SparseVec.empty(6, 4, fill, dtype, device="cpu"), JC.SparseVec.empty(6, 4, fill, dtype)
        assert got.n == want.n and got.capacity == want.capacity
        for f in ("indices", "values", "nnz", "fill"):
            g, w = to_numpy(getattr(got, f)), np.asarray(getattr(want, f))
            assert g.dtype == w.dtype and g.shape == w.shape, f
            np.testing.assert_array_equal(g, w)
        assert not to_numpy(got.valid_mask()).any()
        got, want = C.DenseVec.full(3, fill, dtype, device="cpu"), JC.DenseVec.full(3, fill, dtype)
        assert to_numpy(got.values).dtype == np.asarray(want.values).dtype
        np.testing.assert_array_equal(to_numpy(got.values), np.asarray(want.values))


def test_descriptor_fields_and_builders_match_spla_tpu():
    assert dataclasses.asdict(D.Descriptor()) == dataclasses.asdict(JD.Descriptor())
    kw = dict(push_pull=True, early_exit=True, front_factor=0.3)
    got = D.Descriptor.make(**kw).with_(struct_only=True, push_pull=False)
    want = JD.Descriptor.make(**kw).with_(struct_only=True, push_pull=False)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got == D.Descriptor(early_exit=True, front_factor=0.3, struct_only=True)
    with pytest.raises(dataclasses.FrozenInstanceError):
        got.push_only = True


@pytest.mark.parametrize("key", sorted(k for k, o in JOP.BUILTIN_OPS.items()
                                       if isinstance(o, JOP.OpBinary)))
def test_identity_array_matches_spla_tpu(key):
    jop, top = JOP.BUILTIN_OPS[key], OP.BUILTIN_OPS[key]
    if jop.identity is None:
        with pytest.raises(AssertionError):
            jop.identity_array()
        with pytest.raises(ValueError):
            top.identity_array(device="cpu")
        return
    got, want = to_numpy(top.identity_array(device="cpu")), np.asarray(jop.identity_array())
    assert got.shape == want.shape == () and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_host_coo_matches_spla_tpu():
    a = sp.random(9, 7, density=0.3, random_state=3, dtype=np.float32).tocsr()
    JA = JF.csr_from_scipy(a, capacity=a.nnz + 5)
    A = from_spla_tpu(JA, "cpu")
    for kw in ({}, {"nnz": 4}, {"pattern": True}, {"nnz": 3, "pattern": True}):
        for g, w in zip(F.host_coo(A, **kw), JF.host_coo(JA, **kw)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("cache_cls", [F.WeakIdCache, JF.WeakIdCache], ids=["port", "spla_tpu"])
def test_weak_id_cache_contains(cache_cls):
    cache, key, other = cache_cls(), torch.zeros(3), torch.zeros(3)
    assert not cache.contains(key)
    cache.put(key, "v", extra=(2,))
    assert cache.contains(key, (2,)) and not cache.contains(key) and not cache.contains(other, (2,))
    cache.put(key, None)  # a stored None is held, where get() cannot tell it from a miss
    assert cache.contains(key) and cache.get(key) is None
    del key
    gc.collect()
    assert not cache._data


# ---------------------------------------------------------------- the advisory descriptor fields


def _graph(seed=5, n=400, deg=4):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n - 3, deg * n), rng.integers(0, n - 3, deg * n)
    keep = r != c
    a = sp.coo_matrix((rng.uniform(0.1, 2.0, int(keep.sum())).astype(np.float32),
                       (r[keep], c[keep])), shape=(n, n)).tocsr()
    a.sum_duplicates()
    return a


@pytest.mark.parametrize("route", ["resident", "level_loop"])
@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_advisory_descriptor_fields_change_nothing(kind, route, monkeypatch):
    """push_pull, early_exit and struct_only give the default's depths and
    distances bitwise, on both routes, and spla_tpu's under the same field."""
    if route == "level_loop":
        monkeypatch.setattr(alg, "RESIDENT_BYTES", 0)
    a = _graph()
    JA = JF.csr_from_scipy(a.astype(np.int32)) if kind == "bfs" else \
        JF.csr_from_scipy(a, fill=np.float32(np.inf))
    A = from_spla_tpu(JA, "cpu")
    jrun, run = (JALG.bfs, alg.bfs) if kind == "bfs" else (JALG.sssp, alg.sssp)
    default = to_numpy(run(A, 2).values)
    np.testing.assert_array_equal(default, np.asarray(jrun(JA, 2).values))
    for field in ("push_pull", "early_exit", "struct_only"):
        for k in alg.STATS:
            alg.STATS[k] = 0
        got = to_numpy(run(A, 2, D.Descriptor(**{field: True})).values)
        assert alg.STATS[route] == 1, field
        np.testing.assert_array_equal(got, default)
        np.testing.assert_array_equal(got, np.asarray(jrun(JA, 2, JD.Descriptor(**{field: True})).values))
