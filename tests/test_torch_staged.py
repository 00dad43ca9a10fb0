"""Kernel 7's plain version (the staged-stream pull SpMV), ``formats.split_rows``,
the ``MANUAL_DMA`` dispatch, kernel 8's plain versions and the two tools, on
the CPU, against spla_tpu's manual-DMA kernel (Pallas interpret mode), its
pipelined kernel, numpy definitions and kernel 1's plain version.

Tolerances: f32 PLUS within rtol=1e-5, atol=1e-5 (the summation order
differs); MIN, MAX, structural results and XOR checksums bitwise.
"""

import json
from dataclasses import replace

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import spla_tpu.formats as JF
import spla_tpu.op as JOP

from spla_tpu_torch import formats as F, op as OP
from spla_tpu_torch.interop import csr_from_numpy, from_spla_tpu, to_numpy
from spla_tpu_torch.kernels import PROBE_PHASES, probe as K8, spmv as K1, staged as K7
from spla_tpu_torch.tools import ab_spmv, probe_spmv, tie_times
from spla_tpu_torch.tools.graphs import build_graph

SEMIRINGS = [("MULT", "PLUS", 0.0), ("PLUS", "MIN", np.inf), ("MIN", "MAX", -np.inf)]


def _close(got, want, float_plus):
    got, want = to_numpy(got), np.asarray(want)
    assert got.shape == want.shape
    if float_plus:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, equal_nan=True)
    else:
        np.testing.assert_array_equal(got, want)


def _mult(u, v):
    return u * v


def _plus(u, v):
    return u + v


_JAX_MUL = {"MULT": _mult, "PLUS": _plus}
_JAX_ADD = {"PLUS": jnp.add, "MIN": jnp.minimum, "MAX": jnp.maximum}


def _coo(m, n, nnz, seed, hub_rows=0):
    """The JAX manual-DMA test's inputs (tests/test_pallas.py:1028-1036):
    uniform rows and columns, values in [0.5, 1.5), plus ``hub_rows``
    entries in row 5; duplicates kept as separate entries."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, m, nnz - hub_rows), np.full(hub_rows, 5)]).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    vals = rng.random(nnz, dtype=np.float32) + 0.5
    return rows, cols, vals, rng


def _both(m, n, rows, cols, vals):
    """The same matrix as spla_tpu's fused format (cw 16384) and as the
    port's CSR, carried over from spla_tpu's CsrMatrix by ``interop``."""
    from spla_tpu.pallas.cellpack_native import _native_lib
    from spla_tpu.pallas.spmv import build_fused_cell_spmv_arrays

    if _native_lib() is None:
        pytest.skip("no native toolchain for spla_tpu's packer")
    fmt = build_fused_cell_spmv_arrays(m, n, rows, cols, vals, cw=16384)
    order = np.argsort(rows, kind="stable")
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=m), out=indptr[1:])
    a = sp.csr_matrix((vals[order], cols[order], indptr), shape=(m, n))  # duplicates kept
    return fmt, from_spla_tpu(JF.csr_from_scipy(a), "cpu")


# kernel 7's generic family's muls (every f32 mul of spla_tpu's manual kernel beyond the six
# templated ones), each with one of the three adds
GENERIC_SEMIRINGS = [("MINUS", "PLUS", 0.0), ("DIV", "MIN", np.inf), ("MINUS_POW2", "MAX", -np.inf),
                     ("BONE", "PLUS", 0.0), ("LOR", "MAX", -np.inf), ("LAND", "MIN", np.inf)]


@pytest.mark.parametrize("mul,add,init", SEMIRINGS[:2] + GENERIC_SEMIRINGS)
def test_staged_plain_matches_manual_dma_kernel(mul, add, init):
    """spmv_pull_staged_plain against fused_cell_spmv_apply_manual (interpret
    mode) at the JAX test's size: PLUS within tolerance, MIN and MAX
    bitwise; rows with no entries hold the identity in both.  The first two
    semirings are templated instances of kernel 7, the others its generic
    family's (spla_tpu's own ops as the JAX mul)."""
    from spla_tpu.pallas.spmv import fused_cell_spmv_apply_manual

    m, n = 16384, 40000
    rows, cols, vals, rng = _coo(m, n, 60000, 23)
    x = rng.random(n, dtype=np.float32)
    fmt, A = _both(m, n, rows, cols, vals)
    jmul = _JAX_MUL[mul] if mul in _JAX_MUL else JOP.lookup(mul, JOP.FLOAT)
    want = fused_cell_spmv_apply_manual(fmt, jnp.asarray(x), jmul, _JAX_ADD[add], init)
    got, _ = K7.spmv_pull_staged_plain(A, torch.from_numpy(x), OP.lookup(mul, OP.FLOAT),
                                       OP.lookup(add, OP.FLOAT), init)
    _close(got, want, add == "PLUS")


def test_staged_codes_take_every_f32_request_of_kernel_1(monkeypatch):
    """Under MANUAL_DMA kernel 7 takes every f32 request kernel 1's gate
    admits (the 12 muls of f32 x PLUS, MIN, MAX, both operand orders), and
    no i32 or u32 one: spla_tpu's manual kernel is f32 only."""
    monkeypatch.setattr(K7, "MANUAL_DMA", True)
    muls = ("PLUS", "MULT", "FIRST", "SECOND", "MIN", "MAX", "MINUS", "DIV", "MINUS_POW2", "BONE", "LOR", "LAND")
    taken = {(mul, add, swap) for mul in muls for add in ("PLUS", "MIN", "MAX") for swap in (False, True)
             if K7.staged_codes(OP.lookup(mul, OP.FLOAT), OP.lookup(add, OP.FLOAT), torch.float32, swap)
             == K1.pull_codes(OP.lookup(mul, OP.FLOAT), OP.lookup(add, OP.FLOAT), torch.float32, swap)}
    assert len(taken) == 72
    generic = {mul for mul, add, _ in taken if not K1.templated(*K1.pull_codes(
        OP.lookup(mul, OP.FLOAT), OP.lookup(add, OP.FLOAT), torch.float32))}
    assert generic == set(muls[6:])
    for T in (OP.INT, OP.UINT):
        assert K7.staged_codes(OP.lookup("MULT", T), OP.lookup("PLUS", T), T.dtype) is None
    monkeypatch.setattr(K7, "MANUAL_DMA", False)
    assert K7.staged_codes(OP.MULT_FLOAT, OP.PLUS_FLOAT, torch.float32) is None


def test_pin_manual_dma_fewer_batches_than_slots(monkeypatch):
    """A format of one tile batch (32 tiles at FUSED_K = 32): the reference's
    manual kernel primes two slots and raises; the port returns
    fused_cell_spmv_apply's result, through kernel 7's wrapper and through
    kernel 1's under MANUAL_DMA."""
    from spla_tpu.pallas.spmv import FUSED_K, fused_cell_spmv_apply, fused_cell_spmv_apply_manual

    m, n = 2048, 4096
    rows, cols, vals, rng = _coo(m, n, 8000, 23)
    x = rng.random(n, dtype=np.float32)
    fmt, A = _both(m, n, rows, cols, vals)
    assert fmt.n_tiles == FUSED_K == 32
    with pytest.raises(ValueError, match="Out of bound"):
        fused_cell_spmv_apply_manual(fmt, jnp.asarray(x), _mult, jnp.add, 0.0)
    # without ow_of_batch, which only the resident kernels read (spmv.py:1242-1244),
    # the format has the jit signature of the split test's parts: one interpret compile
    want = fused_cell_spmv_apply(replace(fmt, ow_of_batch=None), jnp.asarray(x), op_mul=_mult,
                                 op_add=jnp.add, identity=0.0)
    xt = torch.from_numpy(x)
    for slots in K7.SLOT_COUNTS:
        got, _ = K7.spmv_pull_staged(A, xt, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0, slots=slots)
        _close(got, want, True)
    monkeypatch.setattr(K7, "MANUAL_DMA", True)
    _close(K1.spmv_pull(A, xt, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0)[0], want, True)


def _hub_matrix(seed=3):
    """n = 600: rows of 0-40 entries, row 17 of 300 and row 400 of 90."""
    rng = np.random.default_rng(seed)
    n = 600
    rows = np.concatenate([rng.integers(0, n, 6000), np.full(300, 17), np.full(90, 400)])
    cols = rng.integers(0, n, rows.size)
    vals = rng.uniform(-2, 2, rows.size).astype(np.float32)
    rows = rows.astype(np.int32)
    order = np.argsort(rows, kind="stable")
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return csr_from_numpy((n, n), indptr, cols[order], vals[order], rows[order], rows.size,
                          np.float32(0), "cpu")


@pytest.mark.parametrize("slots", [2, 3, 4])
@pytest.mark.parametrize("stage", [8, 32, 1024])
def test_staged_plain_at_small_stages(slots, stage):
    """The plain version with stages of 8 and 32 entries (rows 17 and 400
    span many stages and chunks) and of 1024, every
    covered semiring with masks and swapped operands, against kernel 1's
    plain version; the structural variant too."""
    A = _hub_matrix()
    n = A.shape[0]
    units = K7.staged_plan(A, stage).units.long()
    sizes = units[:, 3] - units[:, 2]
    one_row = units[:, 1] - units[:, 0] == 1
    assert bool((sizes[~one_row] < stage).all())  # a unit of several rows is one stage
    if stage < 1024:
        assert bool((sizes[one_row] > stage).any())  # rows spanning several stages
    if stage == 1024:
        assert bool((~one_row).any())
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(-3, 3, n).astype(np.float32))
    x[2], x[9] = float("nan"), float("inf")
    x_valid = torch.from_numpy(rng.random(n) < 0.8)
    row_sel = torch.from_numpy(rng.random(n) < 0.7)
    for mul in ("PLUS", "MULT", "FIRST", "SECOND", "MIN", "MAX"):
        for add in ("PLUS", "MIN", "MAX"):
            om, oa = OP.lookup(mul, OP.FLOAT), OP.lookup(add, OP.FLOAT)
            for xv, rs, swap in ((None, None, False), (x_valid, row_sel, True)):
                got, has = K7.spmv_pull_staged_plain(A, x, om, oa, oa.identity, xv, rs, swap,
                                                     slots, stage)
                want, want_has = K1.spmv_pull_plain(A, x, om, oa, oa.identity, xv, rs, swap)
                assert torch.equal(has, want_has)
                _close(got, want, add == "PLUS")
    got = K7.spmv_pull_staged_structural_plain(A, x_valid, row_sel, slots, stage)
    assert torch.equal(got, K1.spmv_pull_structural_plain(A, x_valid, row_sel))


def test_slots_resolve_as_the_reference_and_raise_outside_the_instances():
    assert K7.resolve_slots(0) == K7.resolve_slots(1) == 2  # max(slots, 2), spmv.py:2154
    assert K7.resolve_slots(None) == max(K7.MANUAL_DMA_SLOTS, 2)
    A = _hub_matrix()
    x = torch.ones(A.shape[0])
    with pytest.raises(ValueError, match=r"\(2, 3, 4\)"):
        K7.spmv_pull_staged(A, x, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0, slots=5)
    with pytest.raises(ValueError, match="stage"):
        K7.staged_plan(A, 4096)


def test_split_rows_parts_equal_the_whole_and_split_fused_format():
    """split_rows parts, each into its slice of one output, equal the whole
    SpMV, and split_fused_format's two tile ranges summed (interpret mode)."""
    from spla_tpu.pallas.spmv import fused_cell_spmv_apply, split_fused_format

    m, n = 2048, 4096
    rows, cols, vals, rng = _coo(m, n, 8000, 31, hub_rows=20)
    x = rng.random(n, dtype=np.float32)
    fmt, A = _both(m, n, rows, cols, vals)
    fparts = split_fused_format(fmt, 2)
    assert len(fparts) == 2
    want = sum(np.asarray(fused_cell_spmv_apply(f, jnp.asarray(x), op_mul=_mult, op_add=jnp.add,
                                                identity=0.0)) for f in fparts)
    xt = torch.from_numpy(x)
    whole, _ = K1.spmv_pull_plain(A, xt, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0)
    for parts in (1, 2, 3, 4):
        pieces = F.split_rows(A, parts)
        assert len(pieces) == parts and sum(p.shape[0] for p in pieces) == m
        assert all(p.cols.data_ptr() == A.cols[int(A.indptr[r])].data_ptr() for p, r in
                   zip(pieces, np.cumsum([0] + [p.shape[0] for p in pieces])[:-1]))
        out = torch.empty(m)
        r0 = 0
        for p in pieces:
            K1.spmv_pull(p, xt, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0, out=out[r0:r0 + p.shape[0]])
            r0 += p.shape[0]
        torch.testing.assert_close(out, whole, rtol=0, atol=0)
        _close(out, want, True)


def test_manual_dma_dispatch_on_cpu_takes_the_staged_plain_path(monkeypatch):
    """Under MANUAL_DMA, kernel 1's wrappers send f32 requests (and the
    structural variant) to kernel 7's plain version on CPU tensors, and
    keep i32 requests; pr and sssp reach it through their pull levels."""
    from spla_tpu_torch import algorithms as alg
    from spla_tpu_torch.descriptor import Descriptor

    calls = []
    plain, structural = K7.spmv_pull_staged_plain, K7.spmv_pull_staged_structural_plain
    monkeypatch.setattr(K7, "spmv_pull_staged_plain", lambda *a, **k: calls.append("f32") or plain(*a, **k))
    monkeypatch.setattr(K7, "spmv_pull_staged_structural_plain",
                        lambda *a, **k: calls.append("structural") or structural(*a, **k))
    A = _hub_matrix()
    n = A.shape[0]
    x = torch.rand(n, generator=torch.Generator().manual_seed(5))
    want = K1.spmv_pull(A, x, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0)[0]
    assert calls == []
    monkeypatch.setattr(K7, "MANUAL_DMA", True)
    _close(K1.spmv_pull(A, x, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0)[0], want, True)
    assert calls == ["f32"]
    Ai = F.csr_from_scipy(sp.csr_matrix((np.ones(10, np.int32), (np.arange(10), np.arange(10)))),
                          device="cpu")
    K1.spmv_pull(Ai, torch.ones(10, dtype=torch.int32), OP.MULT_INT, OP.PLUS_INT, 0)
    K1.spmv_pull_structural(A, x > 0.5)
    assert calls == ["f32", "structural"]
    a = sp.random(300, 300, density=0.03, random_state=6, format="csr", dtype=np.float32)
    a = (a + a.T).tocsr()
    outdeg = np.maximum(np.asarray(a.sum(axis=0)).ravel(), 1e-3)
    G = F.csr_from_scipy(a, device="cpu")
    P = F.csr_from_scipy(a.multiply(0.85 / outdeg).tocsr().astype(np.float32), device="cpu")
    monkeypatch.setattr(alg, "RESIDENT_BYTES", 0)
    del calls[:]
    staged = alg.sssp(G, 0, Descriptor(pull_only=True)).values, alg.pr(P).values
    assert set(calls) == {"f32"} and len(calls) > 2
    monkeypatch.setattr(K7, "MANUAL_DMA", False)
    _close(staged[0], alg.sssp(G, 0, Descriptor(pull_only=True)).values, False)
    _close(staged[1], alg.pr(P).values, True)


def _numpy_units(lens, stage):
    """Kernel 7's units by definition, row by row: a row of more than
    stage // 4 entries is long and a unit of its own, cut into chunks of
    CHUNK_STAGES stages; another row joins the previous row's unit unless
    either is long, its first entry lies in another bucket of stage -
    stage // 4 entries, or the unit already holds BLOCK_ROWS rows since the
    last such start.  Returns (units (r0, r1, e0, e1), unit_hub, hub_units)."""
    lens = np.asarray(lens, np.int64)
    longest = max(stage // 4, 1)
    starts = np.concatenate([[0], np.cumsum(lens)])
    blocks, base = [], 0
    for r in range(lens.size):
        cut = (r == 0 or lens[r] > longest or lens[r - 1] > longest
               or starts[r] // (stage - longest) != starts[r - 1] // (stage - longest))
        if cut:
            base = r
        if cut or (r - base) % K7.BLOCK_ROWS == 0:
            blocks.append([r, r + 1])
        else:
            blocks[-1][1] = r + 1
    units, unit_hub, hub_units = [], [], []
    chunk = K7.CHUNK_STAGES * stage
    for r0, r1 in blocks:
        e0, e1 = int(starts[r0]), int(starts[r1])
        count = -(-(e1 - e0) // chunk) if lens[r0] > longest else 1
        hub = -1
        if count > 1:
            hub = len(hub_units)
            hub_units.append((len(units), count))
        for c in range(count):
            units.append((r0, r1, e0 + c * chunk, min(e0 + (c + 1) * chunk, e1) if count > 1 else e1))
            unit_hub.append(hub)
    return units, unit_hub, hub_units


def _lens_csr(lens, extra_capacity=0, seed=0):
    """A CPU CsrMatrix with the given row lengths and random columns."""
    lens = np.asarray(lens, np.int64)
    m = lens.size
    n = max(m, 1)
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m, dtype=np.int32), lens)
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    pad = extra_capacity
    return csr_from_numpy((m, n), indptr,
                          np.concatenate([rng.integers(0, n, rows.size, dtype=np.int32), np.zeros(pad, np.int32)]),
                          np.concatenate([rng.random(rows.size, dtype=np.float32), np.zeros(pad, np.float32)]),
                          np.concatenate([rows, np.full(pad, m, np.int32)]), rows.size, np.float32(0), "cpu")


PLAN_LENGTHS = {
    "empty matrix": [],
    "all rows empty": [0] * 600,
    "long rows at both ends": [5000] + [16] * 300 + [3000],
    "chunk edges": [2 * 4096, 4, 2 * 4096 + 1, 4096, 257, 256, 9, 8],
    "bucket edges": [7] * 128 + [8] * 112 + [1] * 7 + [0] * 300 + [2] * 200,
    "uniform deg 16": [16] * 700,
}


@pytest.mark.parametrize("stage", [32, 1024])
@pytest.mark.parametrize("extra_capacity", [0, 13])
@pytest.mark.parametrize("name", list(PLAN_LENGTHS))
def test_staged_plan_matches_numpy(name, extra_capacity, stage):
    """staged_plan's units, hubs and chunk edges (capacity beyond nnz or
    not) against the definition; units of several rows are one stage of at
    most BLOCK_ROWS rows; the plan is cached per indptr tensor and stage."""
    lens = PLAN_LENGTHS[name]
    A = _lens_csr(lens, extra_capacity)
    plan = K7.staged_plan(A, stage)
    units, unit_hub, hub_units = _numpy_units(lens, stage)
    assert plan.units.dtype == plan.unit_hub.dtype == plan.hub_units.dtype == torch.int32
    assert [tuple(u) for u in plan.units.tolist()] == units
    assert plan.unit_hub.tolist() == unit_hub
    assert [tuple(h) for h in plan.hub_units.tolist()] == hub_units
    assert (plan.nunits, plan.nhub, plan.stage) == (len(units), len(hub_units), stage)
    assert (plan.done is None) == (not hub_units)
    several = [(r0, r1, e0, e1) for r0, r1, e0, e1 in units if r1 - r0 > 1]
    assert all(e1 - e0 < stage and r1 - r0 <= K7.BLOCK_ROWS for r0, r1, e0, e1 in several)
    assert K7.staged_plan(A, stage) is plan and K7.staged_plan(A, 2 * stage if stage < 1024 else 16) is not plan


def test_staged_plan_of_a_row_split_part():
    """A split_rows part has its own indptr and so its own plan: its long
    rows are the whole matrix's in its range, rebased, and the parts'
    plain results give the whole."""
    lens = [16] * 40 + [6000] + [16] * 40 + [900, 2]
    A = _lens_csr(lens)
    parts = F.split_rows(A, 2)
    got, r0 = [], 0
    x = torch.from_numpy(np.random.default_rng(3).random(A.shape[1], dtype=np.float32))
    out = torch.empty(A.shape[0])
    for part in parts:
        plan = K7.staged_plan(part)
        assert plan is not K7.staged_plan(A)
        u = plan.units
        long = u[(u[:, 1] - u[:, 0] == 1) & (u[:, 3] - u[:, 2] > K7.long_row_len(K7.MAX_STAGE))]
        got += sorted({int(r) + r0 for r in long[:, 0].tolist()})
        K7.spmv_pull_staged(part, x, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0, out=out[r0:r0 + part.shape[0]])
        r0 += part.shape[0]
    assert got == [40, 81]
    assert K7.staged_plan(A).nhub == 1
    _close(out, K1.spmv_pull_plain(A, x, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0)[0], True)


@pytest.mark.parametrize("mul,add,fill", [("PLUS", "MIN", np.inf), ("MULT", "PLUS", 0.0)])
def test_staged_on_long_rows_matches_spla_tpu(mul, add, fill):
    """Kernel 7's CPU path (its plain version), with mxv_masked's fused row
    mask and init, on a graph with long rows of one and of several chunks
    (at each end and inside) and empty rows, against spla_tpu's XLA
    mxv_masked."""
    import spla_tpu.op as JOP
    import spla_tpu.ops.spmv as JS
    from spla_tpu.containers import DenseVec as JDenseVec

    n = 9000
    rng = np.random.default_rng(4)
    long_rows = {0: 4096 + 300, 4000: 600, n - 1: 2 * 4096 + 5}
    rows = np.concatenate([rng.integers(0, n, 3 * n), *(np.full(k, r) for r, k in long_rows.items())])
    # distinct columns in the long rows, so that no duplicate folds them shorter
    cols = np.concatenate([rng.integers(0, n, 3 * n), *(rng.permutation(n)[:k] for k in long_rows.values())])
    vals = rng.uniform(0.1, 2.0, rows.size).astype(np.float32)
    JA = JF.csr_from_entries((n, n), rows, cols, vals, fill=fill, dtype=np.float32, capacity=rows.size + 9)
    A = from_spla_tpu(JA, "cpu")
    plan = K7.staged_plan(A)
    assert plan.nhub == 2 and sorted(set(plan.units[plan.unit_hub >= 0, 0].tolist())) == [0, n - 1]
    x = rng.uniform(-2, 2, n).astype(np.float32)
    x[rng.random(n) < 0.3] = fill
    mvals = (rng.random(n) < 0.7).astype(np.float32)
    jv, jmask = JDenseVec(jnp.asarray(x), jnp.float32(fill)), JDenseVec(jnp.asarray(mvals), jnp.float32(0))
    want = JS.mxv_masked(jmask, JA, jv, JOP.lookup(mul, JOP.FLOAT), JOP.lookup(add, JOP.FLOAT),
                         JOP.NQZERO_FLOAT, fill)
    got, _ = K7.spmv_pull_staged(A, torch.from_numpy(x), OP.lookup(mul, OP.FLOAT), OP.lookup(add, OP.FLOAT),
                                 fill, row_sel=torch.from_numpy(mvals != 0))
    _close(got, np.asarray(want.values), add == "PLUS")


def _numpy_probe(phase, indptr, cols, vals, x, stage):
    """Kernel 8's outputs, defined with numpy loops."""
    m, n = indptr.size - 1, x.size
    mul, two = np.float32(1.0001), np.float32(2.0)

    def chain(s, count):
        for _ in range(count * K8.CHAIN):
            s = np.float32(np.float32(s * mul) + two)
        return s

    def xor(words):
        out = 0
        for w in words:
            out ^= int(w) & 0xFFFFFFFF
        return np.int32(out - (1 << 32) if out >= 1 << 31 else out)

    rowsum = np.array([vals[indptr[r]:indptr[r + 1]].astype(np.float64).sum() for r in range(m)])
    if phase in ("flat_stream", "flat_gather"):
        nnz, tile = indptr[m], K8.FLAT_TILE
        tiles = [slice(t, min(t + tile, nnz)) for t in range(0, cols.size, tile)]
        if phase == "flat_stream":
            return (np.array([vals[s].astype(np.float64).sum() for s in tiles]),
                    np.array([xor(cols[s]) for s in tiles], np.int32))
        return np.array([(vals[s].astype(np.float64) * x[cols[s]]).sum() for s in tiles]), None
    if phase == "stream":
        return rowsum, np.array([xor(cols[indptr[r]:indptr[r + 1]]) for r in range(m)], np.int32)
    if phase in ("gather", "fullfix", "warp_row"):
        prod = np.array([(vals[indptr[r]:indptr[r + 1]].astype(np.float64)
                          * x[cols[indptr[r]:indptr[r + 1]]]).sum() for r in range(m)])
        if phase == "warp_row":
            return prod, None
        return np.array([prod[r:r + 8].sum() for r in range(0, m, 8)]), None
    if phase == "alu":
        return np.array([sum(float(chain(np.float32(lane), len(range(lane, indptr[r + 1] - indptr[r], 32))))
                             for lane in range(32)) for r in range(m)]), None
    if phase == "xgather":
        return np.array([sum(float(x[(k * 2654435761 % 2**32) % n]) for k in range(indptr[r], indptr[r + 1]))
                         for r in range(m)]), None
    units, _, _ = _numpy_units(np.diff(indptr), stage)
    if phase == "ring_fold":
        out = np.zeros(m)
        row_of = np.repeat(np.arange(m), np.diff(indptr))
        for _, _, e0, e1 in units:
            for s0 in range(e0, e1, stage):
                for k in range(s0, min(s0 + stage, e1)):
                    src = s0 % 4 + k - s0
                    out[row_of[k]] += float(vals[src]) * float(x[cols[src]])
        return out, None
    # the ring phases, per unit: its stages of `stage` entries
    out_f, out_i = [], []
    for _, _, e0, e1 in units:
        stages = [(s, min(s + stage, e1)) for s in range(e0, e1, stage)] or [(e0, e0)]
        counts = [sum(len(range(t, s1 - s0, 256)) for s0, s1 in stages) for t in range(256)]
        out_f.append(sum(float(chain(np.float32(t), counts[t])) for t in range(256)))
        words = cols[e0:e1] if phase != "ring_copy" else np.concatenate([cols[e0:e1], vals[e0:e1].view(np.int32)])
        out_i.append(xor(words))
    return (None if phase == "ring_copy" else np.array(out_f),
            None if phase == "ring_alu" else np.array(out_i, np.int32))


@pytest.mark.parametrize("phase", PROBE_PHASES)
def test_probe_plain_matches_numpy_definition(phase):
    _, rows, cols, vals = build_graph(240, 6, seed=7)
    extra = np.random.default_rng(8)
    # one row far longer than a stage of 32
    rows = np.concatenate([rows, np.full(150, 17, np.int32)])
    order = np.argsort(rows, kind="stable")
    rows = rows[order]
    cols = np.concatenate([cols, extra.integers(0, 240, 150, dtype=np.int32)])[order]
    vals = np.concatenate([vals, extra.random(150, dtype=np.float32)])[order]
    indptr = np.zeros(241, np.int64)
    np.cumsum(np.bincount(rows, minlength=240), out=indptr[1:])
    A = csr_from_numpy((240, 240), indptr, cols, vals, rows, rows.size, np.float32(0), "cpu")
    x = extra.random(240, dtype=np.float32)
    stage = 32
    got = K8.spmv_probe(phase, A, torch.from_numpy(x), slots=3, stage=stage)
    want = _numpy_probe(phase, indptr, cols, vals, x, stage)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is None:
            continue
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("argv", [["--manual", "3"], ["--variant", "split2"], ["--graph", "powerlaw"]])
def test_ab_spmv_runs_on_the_cpu(argv, capsys):
    ab_spmv.main(["--device", "cpu", "--n", "4096", "--iters", "3", "--check", *argv])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"] == "cpu" and line["ms"] > 0 and set(line["checked"]) == {"variant", "op_layer"}
    assert line["manual"] == (3 if "--manual" in argv else 0)


def test_probe_spmv_runs_on_the_cpu(capsys):
    probe_spmv.main(["--device", "cpu", "--n", "4096", "--iters", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line["ns_per_entry"]) == set(probe_spmv.PROBES) and line["library"] == ["torch_sum"]
    assert all(v > 0 for v in line["ns_per_entry"].values())


def test_tools_refuse_a_cuda_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ab_spmv.run(n=64, deg=2, iters=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_spmv.run(n=64, deg=2, iters=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tie_times.main([])
