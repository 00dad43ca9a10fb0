"""spla_tpu_torch's vector ops, their helpers and builders against spla_tpu
on the same numpy inputs (carried across by ``interop.from_spla_tpu``).

Tolerances: f32 PLUS folds (``v_reduce``) within rtol=1e-5, atol=1e-5, the
fold order differs; every other result (indices, nnz, capacity, values of
int, uint, MIN/MAX/FIRST/SECOND and element-wise f32 ops) bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spla_tpu.formats as JF
import spla_tpu.op as JOP
import spla_tpu.ops as JOPS
from spla_tpu.containers import DenseVec as JDenseVec
from spla_tpu.utils import primitives as JP
from spla_tpu.utils.segments import combine_segments as j_combine_segments

import spla_tpu_torch.ops as OPS
from spla_tpu_torch import formats as F, op as OP
from spla_tpu_torch.containers import DenseVec
from spla_tpu_torch.interop import from_spla_tpu, to_numpy
from spla_tpu_torch.utils import primitives as P
from spla_tpu_torch.utils.segments import combine_segments

N = 40
NP_DTYPES = {"FLOAT": np.float32, "INT": np.int32, "UINT": np.uint32}
INF = np.float32(np.inf)


def same(got, want, float_plus=False):
    """Every field of a port container (or tensor, or tuple of them) equal to
    spla_tpu's: bitwise, or within the f32 PLUS tolerance."""
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same(g, w, float_plus)
        return
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__
        for f in dataclasses.fields(want):
            same(getattr(got, f.name), getattr(want, f.name), float_plus and f.name == "value")
        return
    if isinstance(want, (int, tuple)):
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


def vec(rng, kind, tname, fill, n=N, nnz=12, cap=None):
    """A spla_tpu vector and the port's copy: ``sparse`` (nnz random
    indices, capacity ``cap`` or nnz + 3), ``empty`` (sparse, none stored)
    or ``dense`` (a third of the slots at the fill)."""
    dt = NP_DTYPES[tname]
    if kind == "dense":
        vals = _values(rng, tname, n)
        vals[rng.random(n) < 1 / 3] = fill
        j = JDenseVec(jnp.asarray(vals), jnp.asarray(fill, dt))
    else:
        k = 0 if kind == "empty" else nnz
        idx = rng.choice(n, k, replace=False)
        j = JF.sparse_vec_from_entries(n, idx, _values(rng, tname, k), fill=fill, dtype=dt,
                                       capacity=cap if cap is not None else k + 3)
    return j, from_spla_tpu(j, "cpu")


# (op, type, u's fill, v's fill): zero and non-zero fills, +inf with MIN
EWISE = [("PLUS", "FLOAT", 1.5, -2.0), ("MIN", "FLOAT", INF, INF),
         ("MAX", "UINT", 0, 7), ("MINUS", "INT", 3, 0), ("FIRST", "FLOAT", 0, 0),
         ("DIV", "INT", 3, 0), ("DIV", "UINT", 0, 2)]  # DIV: stored zeros divide (XLA's x / 0)
KINDS = [("sparse", "sparse"), ("sparse", "dense"), ("dense", "sparse"), ("dense", "dense"),
         ("empty", "sparse")]


@pytest.mark.parametrize("kinds", KINDS, ids=lambda k: "-".join(k))
@pytest.mark.parametrize("case", EWISE, ids=lambda c: f"{c[0]}_{c[1]}_{c[2]}_{c[3]}")
def test_v_eadd_and_v_emult_match_spla_tpu(case, kinds):
    name, tname, fu, fv = case
    rng = np.random.default_rng([EWISE.index(case), KINDS.index(kinds)])
    (ju, u), (jv, v) = vec(rng, kinds[0], tname, fu), vec(rng, kinds[1], tname, fv)
    jop, op = ops_of(name, tname)
    same(OPS.v_eadd(u, v, op), JOPS.v_eadd(ju, jv, jop))
    same(OPS.v_emult(u, v, op), JOPS.v_emult(ju, jv, jop))


@pytest.mark.parametrize("kind", ["sparse", "dense"])
@pytest.mark.parametrize("name,tname", [("AINV", "INT"), ("ABS", "FLOAT"), ("BNOT", "UINT")])
def test_v_map_matches_spla_tpu(name, tname, kind):
    rng = np.random.default_rng(3)
    jv, v = vec(rng, kind, tname, 0)
    jop, op = ops_of(name, tname)
    same(OPS.v_map(v, op), JOPS.v_map(jv, jop))


# (op, type, init, fill): the scatter folds and, for BOR and LOR, the scan fold
REDUCE = [("PLUS", "FLOAT", 0.5, 1.0), ("MIN", "FLOAT", INF, INF), ("MAX", "INT", -100, 2),
          ("PLUS", "UINT", 3, 0), ("BOR", "INT", 0, 0), ("LOR", "FLOAT", 0.0, 0.0)]


@pytest.mark.parametrize("kind", ["sparse", "dense", "dense stored_only", "empty"])
@pytest.mark.parametrize("case", REDUCE, ids=lambda c: f"{c[0]}_{c[1]}")
def test_v_reduce_matches_spla_tpu(case, kind):
    name, tname, init, fill = case
    rng = np.random.default_rng(5)
    jv, v = vec(rng, kind.split()[0], tname, fill)
    jop, op = ops_of(name, tname)
    stored_only = kind.endswith("stored_only")
    same(OPS.v_reduce(init, v, op, stored_only), JOPS.v_reduce(init, jv, jop, stored_only),
         float_plus=case[:2] == ("PLUS", "FLOAT"))


@pytest.mark.parametrize("kind", ["sparse", "dense", "empty"])
def test_v_count_mf_matches_spla_tpu(kind):
    jv, v = vec(np.random.default_rng(6), kind, "INT", 2)
    got, want = OPS.v_count_mf(v), JOPS.v_count_mf(jv)
    assert got.dtype == torch.uint32
    same(got, want)


@pytest.mark.parametrize("mask_kind", ["sparse", "dense"])
@pytest.mark.parametrize("assign,select,tname,value", [("SECOND", "GTZERO", "FLOAT", 7.5),
                                                       ("PLUS", "NQZERO", "INT", 4),
                                                       ("MIN", "EQZERO", "UINT", 1)])
def test_v_assign_masked_matches_spla_tpu(assign, select, tname, value, mask_kind):
    rng = np.random.default_rng(7)
    jr, r = vec(rng, "dense", tname, 0)
    jm, m = vec(rng, mask_kind, tname, 0)
    (ja, a), (js, s) = ops_of(assign, tname), ops_of(select, tname)
    same(OPS.v_assign_masked(r, m, value, a, s), JOPS.v_assign_masked(jr, jm, value, ja, js))


@pytest.mark.parametrize("v_kind", ["sparse", "dense", "empty"])
@pytest.mark.parametrize("name,tname,fill", [("MIN", "FLOAT", INF), ("PLUS", "INT", 0),
                                             ("MAX", "UINT", 0)])
def test_v_eadd_fdb_matches_spla_tpu(name, tname, fill, v_kind):
    rng = np.random.default_rng(8)
    jr, r = vec(rng, "dense", tname, fill)
    jv, v = vec(rng, v_kind, tname, fill)
    jop, op = ops_of(name, tname)
    same(OPS.v_eadd_fdb(r, v, op), JOPS.v_eadd_fdb(jr, jv, jop))


def test_ops_export_every_spla_tpu_op_and_exec_name():
    missing = set(JOPS.__all__) - set(OPS.__all__)
    assert not missing, missing
    execs = [n for n in OPS.__all__ if n.startswith("exec_")]
    assert len(execs) == 20
    for name in execs:
        assert getattr(OPS, name) is getattr(OPS, name[len("exec_"):])


# ---------------------------------------------------------------- helpers and builders


@pytest.mark.parametrize("name,tname,init", [("PLUS", "INT", None), ("MIN", "FLOAT", None),
                                             ("BOR", "UINT", 0), ("MAX", "INT", 4)])
def test_reduce_by_key_matches_spla_tpu(name, tname, init):
    rng = np.random.default_rng(9)
    keys = np.sort(rng.integers(0, 6, 30)).astype(np.int32)
    vals = _values(rng, tname, 30)
    jop, op = ops_of(name, tname)
    want = JP.reduce_by_key(jnp.asarray(keys), jnp.asarray(vals), jop, 7, init)
    same(P.reduce_by_key(torch.from_numpy(keys), torch.from_numpy(vals), op, 7, init), want)


def test_reduce_by_key_without_identity_or_init_raises():
    keys, vals = torch.zeros(3, dtype=torch.int32), torch.ones(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="no identity"):
        P.reduce_by_key(keys, vals, OP.LAND_INT, 1)
    same(P.reduce_by_key(keys, vals, OP.LAND_INT, 1, init=1),
         JP.reduce_by_key(jnp.zeros(3, jnp.int32), jnp.ones(3, jnp.int32), JOP.LAND_INT, 1, init=1))


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.bool_])
def test_scans_match_spla_tpu(dtype):
    x = np.random.default_rng(10).integers(0, 5, 17).astype(dtype)
    same(P.inclusive_scan(torch.from_numpy(x)), JP.inclusive_scan(jnp.asarray(x)))
    if dtype is not np.bool_:
        same(P.exclusive_scan(torch.from_numpy(x)), JP.exclusive_scan(jnp.asarray(x)))
    assert P.exclusive_scan is P.prefix_sum


def test_combine_segments_matches_spla_tpu():
    rng = np.random.default_rng(11)
    vals, has = rng.integers(-5, 5, 9).astype(np.int32), rng.random(9) < 0.5
    same(combine_segments(torch.from_numpy(vals), torch.from_numpy(has), 3, OP.MINUS_INT),
         j_combine_segments(jnp.asarray(vals), jnp.asarray(has), 3, JOP.MINUS_INT))


@pytest.mark.parametrize("sizes", [(5, 7, 2), (1 << 40, 1 << 30, 3)], ids=["fused", "one sort a key"])
def test_lex_order_is_a_stable_lexicographic_sort(sizes):
    """Both branches: one fused int64 key, and (the product of the key
    ranges over 2**63) a stable sort a key from the last to the first."""
    rng = np.random.default_rng(12)
    keys = [rng.integers(0, min(s, 4), 200) * (s // min(s, 4)) for s in sizes]
    got = P.lex_order([torch.from_numpy(k) for k in keys], sizes).numpy()
    np.testing.assert_array_equal(got, np.lexsort(keys[::-1]))


def test_vector_builders_match_spla_tpu():
    idx, vals = [5, 1, 5, 9], [1.0, 2.0, 3.0, 4.0]
    for kw in ({}, {"reduce_fn": np.add, "capacity": 6}):
        same(F.sparse_vec_from_entries(12, idx, vals, fill=-1.0, dtype=np.float32, device="cpu", **kw),
             JF.sparse_vec_from_entries(12, idx, vals, fill=-1.0, dtype=np.float32, **kw))
    same(F.dense_vec_from_entries(12, idx, vals, fill=0, dtype=np.int32, reduce_fn=np.maximum, device="cpu"),
         JF.dense_vec_from_entries(12, idx, vals, fill=0, dtype=np.int32, reduce_fn=np.maximum))
    same(DenseVec.full(5, 2.5, np.float32, device="cpu"), JDenseVec.full(5, 2.5, np.float32))
    with pytest.raises(ValueError):
        F.sparse_vec_from_entries(12, idx, vals, capacity=2, device="cpu")
    sv = F.sparse_vec_from_entries(12, idx, vals, dtype=np.float32, device="cpu")
    assert sv.dtype == torch.float32 and DenseVec.full(3, 1, np.uint32, device="cpu").dtype == torch.uint32
