"""Card tests of spla_tpu_torch's kernels: each kernel against its plain
PyTorch version on the same CUDA tensors, at small shapes.

They need an NVIDIA GPU and skip without one.  This file imports no jax, so
on a machine without jax run it with ``--noconftest`` (tests/conftest.py
imports jax):

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q
"""

from dataclasses import replace

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from spla_tpu_torch import DenseVec, Descriptor, algorithms as alg, facade as FC, formats as F, kernels, op
from spla_tpu_torch.kernels import frontier as KF, level_update as K3, mxmt as K45, resident as K6
from spla_tpu_torch.kernels import probe as K8, spgemm as K9, spmv as K1, staged as K7, traversal as K2
from spla_tpu_torch.kernels.build import BuildError
from spla_tpu_torch.interop import csr_from_numpy
from spla_tpu_torch.library import get_library
from spla_tpu_torch.profiling import profiler
from spla_tpu_torch.types import FLOAT, INT, UINT
from spla_tpu_torch import ops as TO
from spla_tpu_torch.ops import spgemm as TG, spmv as TS
from spla_tpu_torch.utils.primitives import lex_order
from spla_tpu_torch.tools.graphs import (barbell_graph, indptr_of, kron_csr, path_graph, random_graph, road_grid,
                                         skewed_graph, spgemm_bins, uniform_csr)

pytestmark = pytest.mark.cuda

MULS = ("PLUS", "MULT", "FIRST", "SECOND", "MIN", "MAX")
# the generic families' cases: every built-in mul of the type, and kernel 1's adds
GENERIC_MULS = {"f32": (*MULS, "MINUS", "DIV", "MINUS_POW2", "BONE", "LOR", "LAND")}
GENERIC_MULS["i32"] = GENERIC_MULS["u32"] = (*GENERIC_MULS["f32"], "BOR", "BAND", "BXOR")
GENERIC_ADDS = {"f32": ("PLUS", "MIN", "MAX")}
GENERIC_ADDS["i32"] = GENERIC_ADDS["u32"] = ("PLUS", "MULT", "MIN", "MAX", "LOR", "BOR", "BAND", "BXOR")
TYPES = {"f32": FLOAT, "i32": INT, "u32": UINT}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _graph(n=3000, seed=0, hub=5000):
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, n, 8 * n), np.full(hub, 17)])
    cols = rng.integers(0, n, rows.size)
    a = sp.csr_matrix((rng.random(rows.size).astype(np.float32), (rows, cols)), shape=(n, n))
    a.sum_duplicates()
    return a


def _assert_same(got, ref):
    """Bit for bit (a zero's sign counts), NaN equal to NaN whatever its payload."""
    got, ref = got.cpu(), ref.cpu()
    assert got.dtype == ref.dtype and got.shape == ref.shape, (got.dtype, ref.dtype, got.shape, ref.shape)
    if got.is_floating_point():
        nan = torch.isnan(got)
        assert torch.equal(nan, torch.isnan(ref)), "NaN positions differ"
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[got.element_size()]
        got, ref = got.masked_fill(nan, 0).view(ints), ref.masked_fill(nan, 0).view(ints)
    elif got.dtype == torch.uint32:
        got, ref = got.view(torch.int32), ref.view(torch.int32)
    bad = got != ref
    assert not bool(bad.any()), f"{int(bad.sum())} of {bad.numel()} differ, first at {torch.nonzero(bad)[0].tolist()}"


def _pull_graph(name, n=3001):
    """Kernel 1's test graphs as numpy CSR ``(indptr, rows, cols, vals)``,
    rows sorted, duplicate (row, col) pairs kept.  ``deg<d>``: uniform rows
    of mean ``d``, one graph per team size (n = 3001 is no multiple of the
    rows a warp walks, and mean 1 leaves a third of the rows empty);
    ``rounds``: mean 3 with row 17 of 200 entries, walked by its team of 2
    in 25 rounds; ``hub``: row 17 of 5000 entries (two chunks) and row 900
    of 300 (one); ``hub_ends``: rows 0 and n - 1 of 9000 entries (three
    chunks each)."""
    rng = np.random.default_rng(21)
    if name.startswith("deg"):
        rows = rng.integers(0, n, int(name[3:]) * n)
    else:
        hubs = {"rounds": {17: 200}, "hub": {17: 5000, 900: 300}, "hub_ends": {0: 9000, n - 1: 9000}}[name]
        rows = np.concatenate([rng.integers(0, n, 3 * n), *(np.full(k, r) for r, k in hubs.items())])
    rows = np.sort(rows).astype(np.int32)
    cols = rng.integers(0, n, rows.size, dtype=np.int32)
    vals = rng.random(rows.size, dtype=np.float32)
    return indptr_of(rows, n), rows, cols, vals


# graph: (G, hub rows, hub chunks)
PULL_GRAPHS = {"deg1": (2, 0, 0), "deg6": (4, 0, 0), "deg16": (8, 0, 0), "deg24": (16, 0, 0),
               "deg64": (32, 0, 0), "rounds": (2, 0, 0), "hub": (2, 2, 3), "hub_ends": (2, 2, 6)}


def _pull_matrix(graph, dtype, dev, extra=0):
    """The graph as an f32 or i32 CsrMatrix with ``extra`` capacity beyond nnz."""
    indptr, rows, cols, vals = _pull_graph(graph)
    n, nnz = indptr.size - 1, rows.size
    if dtype == "i32":
        vals = (vals * 1000).astype(np.int32)
    pad = np.zeros(extra, np.int32)
    return csr_from_numpy((n, n), indptr, np.concatenate([cols, pad]),
                          np.concatenate([vals, pad.astype(vals.dtype)]),
                          np.concatenate([rows, pad + n]), nnz, vals.dtype.type(0), dev)


@pytest.mark.parametrize("graph", list(PULL_GRAPHS))
@pytest.mark.parametrize("dtype", ["f32", "i32"])
@pytest.mark.parametrize("add", ["PLUS", "MIN", "MAX"])
def test_spmv_pull_matches_plain(dev, graph, dtype, add):
    """Every mul with this add, both operand orders, with and without masks,
    and the structural variant, against the plain version; the plan picks
    the graph's team size, hub rows and chunks; two graphs have capacity
    beyond nnz."""
    A = _pull_matrix(graph, dtype, dev, extra=11 if graph in ("hub", "deg6") else 0)
    n = A.shape[0]
    rng = np.random.default_rng(1)
    T = op.FLOAT if dtype == "f32" else op.INT
    if dtype == "f32":
        x = torch.from_numpy(rng.random(n, dtype=np.float32)).to(dev)
        x[3] = float("nan")
        x[5] = float("inf")
    else:
        x = torch.from_numpy(rng.integers(-100, 100, n, dtype=np.int32)).to(dev)
    plan = K1.pull_plan(A)
    assert (plan.team, plan.nhub, plan.nchunks) == PULL_GRAPHS[graph]
    x_valid = torch.from_numpy(rng.random(n) < 0.8).to(dev)
    row_sel = torch.from_numpy(rng.random(n) < 0.6).to(dev)
    oa = getattr(T, add)
    for mul in MULS:
        om = getattr(T, mul)
        for xv, rs, swap in ((None, None, False), (x_valid, row_sel, False), (x_valid, row_sel, True)):
            got, has = K1.spmv_pull(A, x, om, oa, oa.identity, xv, rs, want_has=True, swap=swap)
            ref, ref_has = K1.spmv_pull_plain(A, x, om, oa, oa.identity, xv, rs, swap=swap)
            assert torch.equal(has, ref_has)
            if dtype == "f32" and add == "PLUS":
                # summation order differs: f32 tolerance
                torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5, equal_nan=True)
            else:
                _assert_same(got, ref)
    for xv, rs in ((x_valid, None), (x_valid, row_sel), (x > 0.99 if dtype == "f32" else x > 97, row_sel)):
        _assert_same(K1.spmv_pull_structural(A, xv, rs), K1.spmv_pull_structural_plain(A, xv, rs))


def _bits(t):
    """A CPU copy to compare bitwise: uint32 as the int32 of its bits."""
    t = t.cpu()
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def _same_values(got, ref, float_plus):
    """Bitwise (NaN equal to NaN), or within rtol=1e-5, atol=1e-5 for f32 PLUS folds."""
    if float_plus:
        torch.testing.assert_close(got.cpu(), ref.cpu(), rtol=1e-5, atol=1e-5, equal_nan=True)
    else:
        _assert_same(_bits(got), _bits(ref))


def _typed(vals, dtype, rng):
    """f32 values as they are; i32 in [-1000, 1000) with INT_MIN, -1 and 0 among
    them; u32 small or within 1000 of 2^32 (MULT and PLUS wrap)."""
    if dtype == "f32":
        return vals
    if dtype == "i32":
        out = rng.integers(-1000, 1000, vals.size).astype(np.int32)
        out[rng.random(vals.size) < 0.05] = np.iinfo(np.int32).min
        out[rng.random(vals.size) < 0.05] = -1
        return out
    out = rng.integers(0, 8, vals.size).astype(np.int64)
    big = rng.random(vals.size) < 0.5
    out[big] = (1 << 32) - rng.integers(1, 1000, int(big.sum()))
    return out.astype(np.uint32)


def _typed_pull_matrix(graph, dtype, dev):
    indptr, rows, cols, vals = _pull_graph(graph)
    n = indptr.size - 1
    vals = _typed(vals, dtype, np.random.default_rng(3))
    return csr_from_numpy((n, n), indptr, cols, vals, rows, rows.size, vals.dtype.type(0), dev)


def _typed_x(n, dtype, dev, rng):
    if dtype == "f32":
        x = rng.uniform(-2, 2, n).astype(np.float32)
        x[3], x[5], x[9] = np.nan, np.inf, 0.0
    else:
        x = _typed(np.zeros(n, np.float32), dtype, rng)
        x[rng.random(n) < 0.1] = 0  # zero divisors
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("graph", ["deg1", "deg16", "deg64", "hub", "hub_ends"])
@pytest.mark.parametrize("dtype", ["f32", "i32", "u32"])
def test_spmv_pull_generic_matches_plain(dev, graph, dtype):
    """Kernel 1's generic family against its plain version: every (mul, add)
    that kernel 1's gate admits in the dtype, each with one of the three
    mask and operand-order settings in turn (the swap reaches MINUS, DIV
    and MINUS_POW2 on some), the templated requests sent to the family by
    ``generic=True``; f32 PLUS within the tolerance, the rest bitwise."""
    A = _typed_pull_matrix(graph, dtype, dev)
    n = A.shape[0]
    rng = np.random.default_rng(2)
    T = TYPES[dtype]
    x = _typed_x(n, dtype, dev, rng)
    x_valid = torch.from_numpy(rng.random(n) < 0.8).to(dev)
    row_sel = torch.from_numpy(rng.random(n) < 0.6).to(dev)
    settings = ((None, None, False), (x_valid, row_sel, False), (x_valid, row_sel, True))
    k = 0
    for add in GENERIC_ADDS[dtype]:
        oa = getattr(T, add)
        for mul in GENERIC_MULS[dtype]:
            om = getattr(T, mul)
            xv, rs, swap = settings[k % 3]
            k += 1
            kernels.reset_launches()
            got, has = K1.spmv_pull(A, x, om, oa, oa.identity, xv, rs, want_has=True, swap=swap, generic=True)
            assert kernels.LAUNCHES["spmv_pull_generic"] == 1 and kernels.LAUNCHES["spmv_pull"] == 0
            ref, ref_has = K1.spmv_pull_plain(A, x, om, oa, oa.identity, xv, rs, swap=swap)
            assert torch.equal(has, ref_has), (mul, add)
            _same_values(got, ref, dtype == "f32" and add == "PLUS")
            if not K1.templated(*K1.pull_codes(om, oa, T.dtype)):  # no generic=: the family all the same
                again, _ = K1.spmv_pull(A, x, om, oa, oa.identity, xv, rs, swap=swap)
                assert kernels.LAUNCHES["spmv_pull_generic"] == 2
                _same_values(again, got, False)


def _card_mask(kind, n, dev, seed):
    return {"empty": lambda: torch.zeros(n, dtype=torch.bool, device=dev),
            "full": lambda: torch.ones(n, dtype=torch.bool, device=dev),
            "random": lambda: torch.from_numpy(np.random.default_rng(seed).random(n) < 0.3).to(dev)}[kind]()


@pytest.mark.parametrize("kind", ["empty", "full", "random"])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 3001, (1 << 16) + 5, (1 << 20) + 3])
def test_pack_valid_bits_matches_plain(dev, n, kind):
    """The pack of an x-validity mask into kernel 1's bitmap, one launch,
    against its plain version, bitwise (no bit set past n)."""
    valid = _card_mask(kind, n, dev, n)
    kernels.reset_launches()
    got = K1.pack_valid_bits(valid)
    assert kernels.LAUNCHES["valid_bits"] == 1
    _assert_same(got, K1.pack_valid_bits_plain(valid.cpu()))


# (mul, add, dtype, generic) of the masked pulls: the templated (PLUS, MIN) and (MULT, PLUS) f32, the
# generic family in f32 (MINUS/MIN has no templated instance; MULT/PLUS sent there), i32 and u32 BAND/BOR;
# None the structural variant
MASKED_PULLS = {"PLUS/MIN f32": ("PLUS", "MIN", "f32", False), "MULT/PLUS f32": ("MULT", "PLUS", "f32", False),
                "MINUS/MIN f32": ("MINUS", "MIN", "f32", False), "MULT/PLUS f32 generic": ("MULT", "PLUS", "f32", True),
                "BAND/BOR i32": ("BAND", "BOR", "i32", False), "BAND/BOR u32": ("BAND", "BOR", "u32", False),
                "structural": None}


@pytest.mark.parametrize("mask", ["empty", "full", "random"])
@pytest.mark.parametrize("graph", ["deg16", "hub"])
@pytest.mark.parametrize("case", list(MASKED_PULLS))
def test_masked_pull_reads_the_bitmap(dev, case, graph, mask):
    """Kernel 1 with x_valid (packed into the plan's bitmap first: one pack
    a call) against its plain version, which reads the bytes: n = 3001 (no
    multiple of 32), with hub rows or without, every row selected or some;
    bitwise but for the f32 PLUS fold; a masked call allocates nothing once
    the plan is built."""
    A = _typed_pull_matrix(graph, "f32" if MASKED_PULLS[case] is None else MASKED_PULLS[case][2], dev)
    n = A.shape[0]
    assert n % 32 and (K1.pull_plan(A).nhub > 0) == (graph == "hub")
    rng = np.random.default_rng(4)
    x_valid = _card_mask(mask, n, dev, 5)
    row_sel = torch.from_numpy(rng.random(n) < 0.6).to(dev)
    for rs in (None, row_sel):
        kernels.reset_launches()
        if MASKED_PULLS[case] is None:
            got, ref = K1.spmv_pull_structural(A, x_valid, rs), K1.spmv_pull_structural_plain(A, x_valid, rs)
            assert kernels.LAUNCHES["valid_bits"] == kernels.LAUNCHES["spmv_pull"] == 1
            _assert_same(got, ref)
            continue
        mul, add, dtype, generic = MASKED_PULLS[case]
        T = TYPES[dtype]
        om, oa = getattr(T, mul), getattr(T, add)
        x = _typed_x(n, dtype, dev, rng)
        out = torch.empty(n, dtype=x.dtype, device=dev)
        mem = torch.cuda.memory_allocated()
        K1.spmv_pull(A, x, om, oa, oa.identity, x_valid, rs, out=out, generic=generic)
        assert torch.cuda.memory_allocated() == mem
        assert kernels.LAUNCHES["valid_bits"] == 1
        family = generic or not K1.templated(*K1.pull_codes(om, oa, T.dtype))
        assert kernels.LAUNCHES["spmv_pull_generic" if family else "spmv_pull"] == 1
        got, has = K1.spmv_pull(A, x, om, oa, oa.identity, x_valid, rs, want_has=True, generic=generic)
        ref, ref_has = K1.spmv_pull_plain(A, x, om, oa, oa.identity, x_valid, rs)
        assert torch.equal(has, ref_has)
        _same_values(got, ref, dtype == "f32" and add == "PLUS")
        _same_values(out, got, False)


def test_masked_pull_on_an_indptr_of_two_widths(dev):
    """Two matrices on one indptr tensor (as parallel's local blocks of two
    widths are) share one plan, whose words fit the first width: a masked
    pull on either width packs x_valid into words of its length."""
    A = _pull_matrix("hub", "f32", dev)
    n = A.shape[0]
    wide = replace(A, shape=(n, 2 * n))
    rng = np.random.default_rng(6)
    for M in (A, wide, A):
        x = torch.from_numpy(rng.random(M.shape[1], dtype=np.float32)).to(dev)
        x_valid = torch.from_numpy(rng.random(M.shape[1]) < 0.5).to(dev)
        got, _ = K1.spmv_pull(M, x, op.PLUS_FLOAT, op.MIN_FLOAT, float("inf"), x_valid)
        _assert_same(got, K1.spmv_pull_plain(M, x, op.PLUS_FLOAT, op.MIN_FLOAT, float("inf"), x_valid)[0])
        _assert_same(K1.spmv_pull_structural(M, x_valid), K1.spmv_pull_structural_plain(M, x_valid))
    assert K1.pull_plan(wide) is K1.pull_plan(A) and K1.pull_plan(A).valid_bits.numel() == (n + 31) // 32


def test_spmv_pull_split_parts_have_their_own_plans(dev):
    """formats.split_rows parts share cols but not indptr: each part's plan
    lists its own hub rows (rebased), and the parts' outputs, written into
    slices of one tensor, give the whole SpMV."""
    A = _pull_matrix("hub_ends", "f32", dev)
    n = A.shape[0]
    x = torch.from_numpy(np.random.default_rng(2).random(n, dtype=np.float32)).to(dev)
    whole, _ = K1.spmv_pull(A, x, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
    parts = F.split_rows(A, 4)
    assert [part.shape[0] for part in parts] == [1, 1513, 1487]  # hub row 0 alone, then a part of none
    out = torch.empty(n, dtype=torch.float32, device=dev)
    r0, hubs = 0, []
    for part in parts:
        plan = K1.pull_plan(part)
        assert plan is not K1.pull_plan(A) and plan is K1.pull_plan(part)
        hubs += (plan.hub_rows.long() + r0).tolist()
        r1 = r0 + part.shape[0]
        K1.spmv_pull(part, x, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0, out=out[r0:r1])
        r0 = r1
    assert hubs == [0, n - 1] == K1.pull_plan(A).hub_rows.tolist()
    torch.testing.assert_close(out, whole, rtol=1e-5, atol=1e-5)


def _segment_matrix(dtype, dev, n=3001):
    """Hub rows of each kind the segmented plan cuts, columns sorted in each
    row: rows 17 and 2000 of 9000 and 5000 entries (CTA chunks, cut at the
    segments' edges too), rows 5, 900 and 901 of 300, 4000 and 600 (a warp a
    piece), row 901's columns all below n / 8 (pieces with no entry), the
    other rows mean 3."""
    rng = np.random.default_rng(23)
    hubs = {17: 9000, 2000: 5000, 5: 300, 900: 4000, 901: 600}
    rows = np.concatenate([rng.integers(0, n, 3 * n), *(np.full(k, r) for r, k in hubs.items())]).astype(np.int32)
    cols = rng.integers(0, n, rows.size, dtype=np.int32)
    cols[rows == 901] %= n // 8
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    vals = _typed(rng.random(rows.size, dtype=np.float32), dtype, rng)
    return csr_from_numpy((n, n), indptr_of(rows, n), cols, vals, rows, rows.size, vals.dtype.type(0), dev)


# (mul, add, dtype, generic) of the segmented pulls
SEGMENTED_PULLS = {"MULT/PLUS f32": ("MULT", "PLUS", "f32", False), "PLUS/MIN f32": ("PLUS", "MIN", "f32", False),
                   "MULT/PLUS i32": ("MULT", "PLUS", "i32", False), "MINUS/MAX i32": ("MINUS", "MAX", "i32", False),
                   "BAND/BOR u32": ("BAND", "BOR", "u32", False), "MULT/PLUS f32 generic": ("MULT", "PLUS", "f32", True)}


@pytest.mark.parametrize("segments", [3, 4, 7])
@pytest.mark.parametrize("case", list(SEGMENTED_PULLS))
def test_segmented_pull_matches_plain(dev, monkeypatch, case, segments):
    """Kernel 1 on a plan cut into S >= 3 segments (an L2 budget of 4n / S
    bytes), with and without masks: against its plain version (bitwise but
    for the f32 PLUS fold, within its tolerance) and against the one-segment
    plan's launch (bitwise but for that fold); ``has`` the same; a repeated
    call bitwise equal; one launch a call, S segments counted."""
    mul, add, dtype, generic = SEGMENTED_PULLS[case]
    A = _segment_matrix(dtype, dev)
    n = A.shape[1]
    budget = -(-n * K1.X_BYTES // segments)
    plan = K1.pull_plan(A, budget)
    assert (plan.segments, plan.nhub, plan.short_rows.numel()) == (segments, 5, 3)
    assert plan.chunk_first.numel() - 1 == 2 and plan.nchunks >= 2 * segments
    rng = np.random.default_rng(8)
    T = TYPES[dtype]
    om, oa = getattr(T, mul), getattr(T, add)
    x = _typed_x(n, dtype, dev, rng)
    x_valid = torch.from_numpy(rng.random(n) < 0.7).to(dev)
    row_sel = torch.from_numpy(rng.random(n) < 0.6).to(dev)
    row_sel[[17, 901]] = True
    float_plus = dtype == "f32" and add == "PLUS"
    family = "spmv_pull_generic" if generic or not K1.templated(*K1.pull_codes(om, oa, T.dtype)) else "spmv_pull"
    for xv, rs in ((None, None), (x_valid, row_sel)):
        monkeypatch.setattr(K1, "l2_budget", lambda device: 1 << 40)
        one, one_has = K1.spmv_pull(A, x, om, oa, oa.identity, xv, rs, want_has=True, generic=generic)
        monkeypatch.setattr(K1, "l2_budget", lambda device: budget)
        kernels.reset_launches()
        got, has = K1.spmv_pull(A, x, om, oa, oa.identity, xv, rs, want_has=True, generic=generic)
        assert kernels.LAUNCHES[family] == 1 and kernels.LAUNCHES["pull_segments"] == segments
        again, again_has = K1.spmv_pull(A, x, om, oa, oa.identity, xv, rs, want_has=True, generic=generic)
        _assert_same(again, got)
        ref, ref_has = K1.spmv_pull_plain(A, x, om, oa, oa.identity, xv, rs)
        assert torch.equal(has, ref_has) and torch.equal(has, one_has) and torch.equal(again_has, has)
        _same_values(got, ref, float_plus)
        _same_values(got, one, float_plus)


def test_spmv_push_matches_plain(dev):
    a = _graph(seed=2)
    n = a.shape[0]
    rng = np.random.default_rng(3)
    A = F.csr_from_scipy(a, device=dev)
    Ai = F.csr_from_scipy((a * 1000).astype(np.int32), device=dev)
    x = torch.from_numpy(rng.uniform(-5, 5, n).astype(np.float32)).to(dev)
    x[[0, 1]] = torch.tensor([float("inf"), float("-inf")], device=dev)
    xi = torch.from_numpy(rng.integers(-100, 100, n, dtype=np.int32)).to(dev)
    for k in (1, 40, n // 2):
        front = torch.from_numpy(rng.choice(n, k, replace=False).astype(np.int32)).to(dev)
        front[0] = 17  # the heavy row
        _assert_same(K2.spmv_push_structural(A, front), K2.spmv_push_structural_plain(A, front))
        for M, xx, T in ((A, x, op.FLOAT), (Ai, xi, op.INT)):
            for mul in MULS:
                for add in ("MIN", "MAX"):
                    om, oa = getattr(T, mul), getattr(T, add)
                    _assert_same(K2.spmv_push(M, front, xx, om, oa, oa.identity),
                                 K2.spmv_push_plain(M, front, xx, om, oa, oa.identity))


def test_level_updates_match_plain(dev):
    rng = np.random.default_rng(4)
    n = 5000
    hits = torch.from_numpy(rng.random(n) < 0.2).to(dev)
    v0 = torch.from_numpy(np.where(rng.random(n) < 0.5, 0, 3).astype(np.int32)).to(dev)
    f0 = (v0 == 0) & torch.from_numpy(rng.random(n) < 0.1).to(dev)
    res = []
    for fn in (K3.bfs_level_update, K3.bfs_level_update_plain):
        v, f = v0.clone(), f0.clone()
        lst = torch.empty(n, dtype=torch.int32, device=dev)
        cnt = torch.zeros(1, dtype=torch.int32, device=dev)
        fn(hits, v, f, 4, lst, cnt)
        res.append((v, f, torch.sort(lst[: int(cnt)]).values))
    for a, b in zip(*res):
        _assert_same(a, b)
    h = torch.from_numpy(np.where(rng.random(n) < 0.5, np.inf, rng.random(n)).astype(np.float32)).to(dev)
    s0 = torch.from_numpy(rng.random(n).astype(np.float32) * 2).to(dev)
    res = []
    for fn in (K3.sssp_level_update, K3.sssp_level_update_plain):
        v, ch = s0.clone(), torch.zeros(n, dtype=torch.bool, device=dev)
        lst = torch.empty(n, dtype=torch.int32, device=dev)
        cnt = torch.zeros(1, dtype=torch.int32, device=dev)
        fn(h, v, ch, lst, cnt)
        res.append((v, ch, torch.sort(lst[: int(cnt)]).values))
    for a, b in zip(*res):
        _assert_same(a, b)


def test_algorithms_match_cpu(dev, monkeypatch):
    """The level loop (the resident route gated off) on the card against the
    CPU, in every mode."""
    monkeypatch.setattr(alg, "RESIDENT_BYTES", 0)
    a = _graph(n=2000, seed=5, hub=300)
    a = (a + a.T).tocsr()
    a.data = np.random.default_rng(6).uniform(0.1, 2.0, a.nnz).astype(np.float32)
    kernels.reset_launches()
    for d in (None, Descriptor(push_only=True), Descriptor(pull_only=True)):
        for fn in (alg.bfs, alg.sssp):
            got = fn(F.csr_from_scipy(a, device=dev), 0, d).values
            ref = fn(F.csr_from_scipy(a, device="cpu"), 0, d).values
            _assert_same(got, ref)
    outdeg = np.asarray(a.sum(axis=0)).ravel()
    ap = a.multiply(0.85 / outdeg).tocsr().astype(np.float32)
    got = alg.pr(F.csr_from_scipy(ap, device=dev)).values
    ref = alg.pr(F.csr_from_scipy(ap, device="cpu")).values
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-6)
    assert all(kernels.LAUNCHES[k] > 0
               for k in ("spmv_pull", "level_update", "bfs_push_level", "sssp_push_level"))


def _level_graph(name):
    """The push levels' test graphs, weighted in [0.1, 2): ``random`` (n =
    3000, degree 16, symmetric), ``road`` (the side-40 Morton grid) and
    ``skewed`` (``skewed_graph(2**12)``, directed, with rows of up to 1,024
    entries)."""
    a = {"random": lambda: random_graph(3000, 16, seed=3), "road": lambda: road_grid(40),
         "skewed": lambda: skewed_graph(1 << 12)}[name]().astype(np.float32)
    a.data = np.random.default_rng(9).uniform(0.1, 2.0, a.nnz).astype(np.float32)
    return a


def _same_state(S, R, what):
    """Card state S against the plain state R after a level: v and the mask
    bitwise, the next list as a set with the plain size word, and the card's
    degree offsets those of its own list order."""
    _assert_same(S.v, R.v)
    _assert_same(S.mask, R.mask)
    KF.read_count(S), KF.read_count(R)
    assert (S.k, S.edges) == (R.k, R.edges), what
    cur = S.level % 2
    lst = S.lists[cur, :S.k]
    _assert_same(torch.sort(lst).values, torch.sort(R.lists[cur, :R.k]).values)
    eoff, total = KF.degree_offsets(S.A.indptr, lst)
    _assert_same(S.eoff[cur, :S.k], eoff)
    assert total == S.edges, what


@pytest.mark.parametrize("graph", ["random", "road", "skewed"])
@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_push_levels_match_plain(dev, graph, kind):
    """Level by level, the card's push levels and pull updates against their
    plain versions on a CPU copy: every state after every level, with push
    and pull levels mixed so that each hands over to the other.  From the
    skewed graph's hub the first frontier's row is its longest."""
    a = _level_graph(graph)
    source = int(np.argmax(np.diff(a.indptr))) if graph == "skewed" else 0
    states = []
    for device in (dev, "cpu"):
        A = F.csr_from_scipy(a, fill=np.float32(np.inf), device=device)
        At = alg._default_At(A)
        S = (KF.bfs_state if kind == "bfs" else KF.sssp_state)(A, source)
        states.append((S, At))
    step = alg.bfs_level if kind == "bfs" else alg.sssp_level
    (S, At), (R, Rt) = states
    level = 0
    while S.k > 0:
        push = level % 3 != 2
        step(S, At, push)
        step(R, Rt, push)
        _same_state(S, R, f"{graph} {kind} level {level} push={push}")
        level += 1
    assert level > 3


def test_level_kernels_do_not_synchronize(dev):
    """Once a matrix's degrees are cached, no call of kernel 2 (init a number
    or a CUDA tensor, and structural) or kernel 3 waits for the stream; a
    push level is one launch (BFS) or two (SSSP), and allocates nothing."""
    a = _level_graph("skewed")
    A = F.csr_from_scipy(a, fill=np.float32(np.inf), device=dev)
    n = a.shape[0]
    front = torch.tensor([0, 5, int(np.argmax(np.diff(a.indptr)))], dtype=torch.int32, device=dev)
    x = torch.from_numpy(np.random.default_rng(19).random(n, dtype=np.float32)).to(dev)
    hits = torch.from_numpy(np.random.default_rng(20).random(n) < 0.2).to(dev)
    init_t = torch.tensor(float("inf"), device=dev)
    v, f = torch.zeros(n, dtype=torch.int32, device=dev), hits.roll(1)
    d, ch = torch.full((n,), float("inf"), device=dev), torch.zeros(n, dtype=torch.bool, device=dev)
    lst, cnt = torch.empty(n, dtype=torch.int32, device=dev), torch.zeros(1, dtype=torch.int32, device=dev)
    states = {kind: make(A, 0) for kind, make in (("bfs", KF.bfs_state), ("sssp", KF.sssp_state))}
    K2.push_degrees(A)  # the public push's bound: one host read a matrix
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for init in (float("inf"), init_t):
            K2.spmv_push(A, front, x, op.PLUS_FLOAT, op.MIN_FLOAT, init)
        K2.spmv_push_structural(A, front)
        K3.bfs_level_update(hits, v, f, 2, lst, cnt)
        K3.sssp_level_update(x, d, ch, lst, cnt)
        for kind, level, most in (("bfs", K2.bfs_push_level, 1), ("sssp", K2.sssp_push_level, 2)):
            before, mem = sum(kernels.LAUNCHES.values()), torch.cuda.memory_allocated()
            level(states[kind])
            assert 1 <= sum(kernels.LAUNCHES.values()) - before <= most
            assert torch.cuda.memory_allocated() == mem
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out = set(a.indices[a.indptr[0]:a.indptr[1]].tolist()) - {0}
    assert KF.read_count(states["bfs"]) == len(out)  # the level's list: vertex 0's out-neighbours
    assert set(states["bfs"].lists[1, :len(out)].tolist()) == out


def _spgemm_operands(dev, dtype, nan=False):
    """A (= B) with a hub row 17 of ~2600 distinct columns, and a mask of
    random entries plus entries in the hub's row and column, valued in
    {-1, 1, 2} so that GTZERO deselects some; capacities above nnz."""
    a = _graph(n=3000, seed=7, hub=5000)
    n = a.shape[0]
    rng = np.random.default_rng(8)
    if dtype == "f32":
        if nan:
            a.data[[3, a.indptr[17] + 5]] = np.nan
        A = F.csr_from_scipy(a, capacity=a.nnz + 11, device=dev)
    else:
        A = F.csr_from_scipy((a * 1000).astype(np.int32), capacity=a.nnz + 11, device=dev)
    k = 4000
    rows = np.concatenate([rng.integers(0, n, k), np.full(200, 17), rng.integers(0, n, 200), [17]])
    cols = np.concatenate([rng.integers(0, n, k), rng.integers(0, n, 200), np.full(200, 17), [17]])
    vals = rng.choice([-1, 1, 2], rows.size)
    mask = F.csr_from_entries((n, n), rows, cols, vals,
                              dtype=np.float32 if dtype == "f32" else np.int32,
                              capacity=rows.size + 7, device=dev)
    return mask, A


def _deg_operands(dev, dtype, deg, n=2000):
    """A (= B) of uniform rows of mean ``deg``, and a mask of 2n random
    entries with row 5 empty, valued in {-1, 1, 2}; capacities above nnz."""
    rng = np.random.default_rng(deg)
    rows, cols = rng.integers(0, n, deg * n), rng.integers(0, n, deg * n)
    a = sp.csr_matrix((rng.random(rows.size).astype(np.float32), (rows, cols)), shape=(n, n))
    a.sum_duplicates()
    if dtype == "i32":
        a = (a * 1000).astype(np.int32)
    A = F.csr_from_scipy(a, capacity=a.nnz + 11, device=dev)
    mr, mc = rng.integers(0, n, 2 * n), rng.integers(0, n, 2 * n)
    keep = mr != 5
    mask = F.csr_from_entries((n, n), mr[keep], mc[keep], rng.choice([-1, 1, 2], int(keep.sum())),
                              dtype=np.float32 if dtype == "f32" else np.int32,
                              capacity=int(keep.sum()) + 7, device=dev)
    return mask, A


# "hub" has hub entries of two chunks and rows of A above A_STAGE; the others
# B rows of mean 48 to 192, many batches of a team
MXMT_GRAPHS = ("hub", "deg48", "deg96", "deg192")


def _mxmt_operands(dev, dtype, graph, nan=False):
    mask, A = (_spgemm_operands(dev, dtype, nan) if graph == "hub"
               else _deg_operands(dev, dtype, int(graph[3:])))
    plan = K45.mxmt_plan(mask, A)
    if graph == "hub":
        assert plan.nchunks > plan.nhub > 0
        assert int((A.indptr[1:] - A.indptr[:-1]).max()) > K45.A_STAGE
    return mask, A


def _sel(mask, T):
    return T.GTZERO(mask.values) & mask.valid_mask()


@pytest.mark.parametrize("graph", list(MXMT_GRAPHS))
@pytest.mark.parametrize("dtype", ["f32", "i32"])
@pytest.mark.parametrize("add", ["PLUS", "MIN", "MAX"])
def test_mxmt_masked_matches_plain(dev, graph, dtype, add):
    """Every kernel-5 instance against its plain version, on graphs of B
    rows of mean 48, 96 and 192 and on the hub graph (chunked B rows, A
    rows probed in global memory, NaN values)."""
    mask, A = _mxmt_operands(dev, dtype, graph, nan=True)
    T = op.FLOAT if dtype == "f32" else op.INT
    oa = getattr(T, add)
    sel = _sel(mask, T)
    for mul in MULS:
        om = getattr(T, mul)
        got, has = K45.mxmt_masked(mask, A, A, om, oa, oa.identity, sel)
        ref, ref_has = K45.mxmt_masked_plain(mask, A, A, om, oa, oa.identity, sel)
        assert torch.equal(has, ref_has) and bool(has.any()) and not bool(has.all())
        if dtype == "f32" and add == "PLUS":
            # summation order differs: f32 tolerance
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5, equal_nan=True)
        else:
            _assert_same(got, ref)
    valid = mask.valid_mask()
    for s in (valid, None):
        got = K45.mxmt_masked(mask, A, A, None, oa, oa.identity, s, struct_only=True)
        ref = K45.mxmt_masked_plain(mask, A, A, None, oa, oa.identity, valid, struct_only=True)
        for g, r in zip(got, ref):
            _assert_same(g, r)


@pytest.mark.parametrize("graph", list(MXMT_GRAPHS))
@pytest.mark.parametrize("dtype", ["f32", "i32"])
def test_mxmt_reduce_matches_plain(dev, graph, dtype):
    """Every kernel-4 instance against its plain version on the graphs of
    test_mxmt_masked_matches_plain; the structural one with and without a
    selection."""
    mask, A = _mxmt_operands(dev, dtype, graph)
    T = op.FLOAT if dtype == "f32" else op.INT
    sel = _sel(mask, T)
    for mul in MULS:
        om = getattr(T, mul)
        got = K45.mxmt_reduce(mask, A, A, om, sel)
        ref = K45.mxmt_reduce_plain(mask, A, A, om, sel)
        assert got.dtype == ref.dtype
        if dtype == "f32":
            # float64 sums of the same f32 products, in another order
            torch.testing.assert_close(got, ref, rtol=1e-9, atol=0)
        else:
            _assert_same(got, ref)
    valid = mask.valid_mask()
    ref = K45.mxmt_reduce_plain(mask, A, A, None, valid, struct_only=True)
    _assert_same(K45.mxmt_reduce(mask, A, A, None, valid, struct_only=True), ref)
    _assert_same(K45.mxmt_reduce(mask, A, A, None, struct_only=True), ref)


def _as_u32(M):
    """An i32 matrix's bits as u32 (negative values become values past 2^31)."""
    return replace(M, values=M.values.view(torch.uint32), fill=M.fill.view(torch.uint32))


@pytest.mark.parametrize("graph", ["hub", "deg48"])
@pytest.mark.parametrize("dtype", ["f32", "u32"])
def test_mxmt_generic_matches_plain(dev, graph, dtype):
    """Kernels 5 and 4 (one instance per add and dtype, the mul a kernel
    argument) against their plain versions: every mul kernel 5's gate
    admits in the dtype (f32: all 12; u32: the six) with PLUS, MIN and MAX,
    the structural u32 instances, and kernel 4 on the same muls."""
    mask, A = _mxmt_operands(dev, "f32" if dtype == "f32" else "i32", graph, nan=dtype == "f32")
    if dtype == "u32":
        mask, A = _as_u32(mask), _as_u32(A)
    T = TYPES[dtype]
    sel = T.GTZERO(mask.values) & mask.valid_mask()
    muls = GENERIC_MULS["f32"] if dtype == "f32" else MULS
    for add in ("PLUS", "MIN", "MAX"):
        oa = getattr(T, add)
        for mul in muls:
            om = getattr(T, mul)
            kernels.reset_launches()
            got, has = K45.mxmt_masked(mask, A, A, om, oa, oa.identity, sel)
            assert kernels.LAUNCHES["mxmt_masked"] == 1
            ref, ref_has = K45.mxmt_masked_plain(mask, A, A, om, oa, oa.identity, sel)
            assert torch.equal(has, ref_has) and bool(has.any())
            _same_values(got, ref, dtype == "f32" and add == "PLUS")
        if dtype == "u32":
            got = K45.mxmt_masked(mask, A, A, None, oa, oa.identity, None, struct_only=True)
            ref = K45.mxmt_masked_plain(mask, A, A, None, oa, oa.identity, mask.valid_mask(), struct_only=True)
            for g, r in zip(got, ref):
                _same_values(g, r, False)
    for mul in muls:
        om = getattr(T, mul)
        kernels.reset_launches()
        got = K45.mxmt_reduce(mask, A, A, om, sel)
        assert kernels.LAUNCHES["mxmt_reduce"] == 1
        ref = K45.mxmt_reduce_plain(mask, A, A, om, sel)
        assert got.dtype == ref.dtype == (torch.float64 if dtype == "f32" else torch.int64)
        if dtype == "f32":  # float64 sums of the same f32 products, in another order
            torch.testing.assert_close(got, ref, rtol=1e-9, atol=0, equal_nan=True)
        else:
            _assert_same(got, ref)


def _uint_inputs(device, n=3000):
    """A u32 matrix (values anywhere in 32 bits, a hub row), a dense and a
    sparse u32 vector and an f32 mask vector, from one seed, on ``device``."""
    rng = np.random.default_rng(41)
    a = _graph(n=n, seed=11, hub=300)
    a.data = rng.integers(0, 1 << 32, a.nnz, dtype=np.uint64).astype(np.uint32)
    xv = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    xv[rng.random(n) < 0.3] = 0
    mvals = (rng.random(n) < 0.7).astype(np.float32)
    idx = np.sort(rng.choice(n, 400, replace=False))
    A = F.csr_from_scipy(a, device=device)
    x = DenseVec(torch.from_numpy(xv).to(device), torch.zeros((), dtype=torch.uint32).to(device))
    sv = F.sparse_vec_from_entries(n, idx, xv[idx], dtype=np.uint32, capacity=450, device=device)
    mask = DenseVec(torch.from_numpy(mvals).to(device), torch.zeros((), device=device))
    return A, x, sv, mask


def _uint_calls(A, x, sv, mask):
    U = UINT
    n = A.shape[0]
    return (TS.mxv_masked(mask, A, x, U.BAND, U.BOR, op.NQZERO_FLOAT, 0),
            TS.mxv_masked(mask, A, x, U.MULT, U.PLUS, op.NQZERO_FLOAT, 7),
            TS.vxm_masked(mask, sv, A, U.MINUS, U.MIN, op.NQZERO_FLOAT, U.MIN.identity, out_capacity=n),
            TS.vxm_masked_dense(mask, x, A, U.BAND, U.BOR, op.NQZERO_FLOAT, 0),
            TG.mxmT_masked(A, A, A, U.MULT, U.PLUS, U.GTZERO, 0),
            TG.mxmT_masked(A, A, A, U.MULT, U.MAX, U.GTZERO, 0, struct_only=True),
            TG.mxmT_masked_reduce(A, A, A, U.MULT, U.GTZERO))


def test_uint_path_runs_on_the_card_without_synchronizing(dev):
    """The UINT path through the public ops, on CUDA tensors under
    set_sync_debug_mode("error") (no host read, no copy from the host):
    mxv_masked (BAND/BOR, MULT/PLUS), vxm_masked (sparse v, compacted) and
    vxm_masked_dense, mxmT_masked (MULT/PLUS and structural) and
    mxmT_masked_reduce, against the same calls on the CPU, each launching
    a kernel (no torch path)."""
    card = _uint_inputs(dev)
    K1.pull_plan(card[0]), K45.mxmt_plan(card[0], card[0])  # the plans read the host once, at their first build
    kernels.reset_launches()
    before = dict(TS.DISPATCH_STATS)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = _uint_calls(*card)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(TS.DISPATCH_STATS[k] == before[k] for k in before if k.endswith("_torch"))
    assert kernels.LAUNCHES["spmv_pull_generic"] == 4 and kernels.LAUNCHES["spmv_pull"] == 0
    assert kernels.LAUNCHES["mxmt_masked"] == 2 and kernels.LAUNCHES["mxmt_reduce"] == 1
    _same_result(got, _uint_calls(*_uint_inputs("cpu")), False)


@pytest.mark.parametrize("graph", ["hub", "deg48"])
def test_mxmt_gather_matches_plain(dev, graph):
    """The gather floor of kernels 4 and 5 (kernel 8's module) against its
    plain version, XOR checksums bitwise, with and without values."""
    for dtype in ("f32", "i32"):
        mask, A = _mxmt_operands(dev, dtype, graph)
        for values in (True, False):
            _assert_same(K8.mxmt_gather(mask, A, values), K8.mxmt_gather_plain(mask, A, values))


def test_mxmt_kernels_do_not_synchronize(dev):
    """Once the plan is built, no call of kernel 4 or 5 (value and
    structural, init a Python number or a CUDA tensor, no selection for the
    structural ones), nor of ``mxmT_masked`` around kernel 5, waits for the
    stream."""
    mask, A = _mxmt_operands(dev, "i32", "hub")
    sel = _sel(mask, op.INT)
    init_t = torch.zeros((), dtype=torch.int32, device=dev)
    calls = [(op.MULT_INT, op.PLUS_INT, 0, False), (op.MULT_INT, op.PLUS_INT, init_t, False),
             (None, op.MAX_INT, 0, True)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = []
        for init in (0, init_t):
            got.append(K45.mxmt_masked(mask, A, A, op.MULT_INT, op.PLUS_INT, init, sel))
            got.append(K45.mxmt_masked(mask, A, A, None, op.MAX_INT, init, struct_only=True))
        total = K45.mxmt_reduce(mask, A, A, op.MULT_INT, sel)
        hits = K45.mxmt_reduce(mask, A, A, None, struct_only=True)
        results = [TG.mxmT_masked(mask, A, A, om, oa, op.GTZERO_INT, init, struct_only=s)
                   for om, oa, init, s in calls]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for r, (om, oa, init, s) in zip(results, calls):
        ref = TG.mxmT_masked_plain(mask, A, A, om, oa, op.GTZERO_INT, init, struct_only=s)
        for field in ("indptr", "cols", "values", "row_ids", "nnz", "fill"):
            _assert_same(getattr(r, field), getattr(ref, field))
    ref = [K45.mxmt_masked_plain(mask, A, A, op.MULT_INT, op.PLUS_INT, 0, sel),
           K45.mxmt_masked_plain(mask, A, A, None, op.MAX_INT, 0, struct_only=True)] * 2
    for g, r in zip(got, ref):
        _assert_same(g[0], r[0])
        _assert_same(g[1], r[1])
    _assert_same(total, K45.mxmt_reduce_plain(mask, A, A, op.MULT_INT, sel))
    _assert_same(hits, K45.mxmt_reduce_plain(mask, A, A, None, struct_only=True))


def test_tc_int32_sum_is_exact_on_the_card(dev):
    """tc of int32 values whose products fit int32 but whose sum passes
    2^31: kernel 4 sums in int64, so the card gives the exact total where
    the CPU path wraps (test_torch_spgemm.py
    test_pin_tc_int32_sum_wraps_on_the_cpu)."""
    rng = np.random.default_rng(31)
    n = 200
    r, c = rng.integers(0, n, 600), rng.integers(0, n, 600)
    keep = r != c
    a = sp.coo_matrix((np.ones(2 * int(keep.sum()), np.int32),
                       (np.concatenate([r[keep], c[keep]]), np.concatenate([c[keep], r[keep]]))),
                      shape=(n, n)).tocsr()
    a.sum_duplicates()
    a.data[:] = 40_000
    d = a.toarray().astype(np.int64)
    exact = int(((d @ d.T) * (d > 0)).sum())
    assert exact > 2**31
    kernels.reset_launches()
    assert alg.tc(F.csr_from_scipy(a, device=dev)) == exact
    assert kernels.LAUNCHES["mxmt_reduce"] == 1


def test_mxmt_empty_mask(dev):
    _, A = _spgemm_operands(dev, "i32")
    n = A.shape[0]
    empty = F.csr_from_entries((n, n), [], [], [], dtype="int32", capacity=5, device=dev)
    out, has = K45.mxmt_masked(empty, A, A, op.MULT_INT, op.PLUS_INT, 0, empty.valid_mask())
    _assert_same(out, torch.zeros(5, dtype=torch.int32))
    assert not bool(has.any())
    assert int(K45.mxmt_reduce(empty, A, A, op.MULT_INT, empty.valid_mask())) == 0
    r = TG.mxmT_masked(empty, A, A, op.MULT_INT, op.PLUS_INT, op.GTZERO_INT, 0)
    assert int(r.nnz) == 0 and int(r.indptr[-1]) == 0


def test_tc_and_mxmT_masked_match_cpu(dev):
    rng = np.random.default_rng(9)
    n = 1500
    r, c = rng.integers(0, n, 6000), rng.integers(0, n, 6000)
    keep = r != c
    a = sp.coo_matrix((np.ones(2 * int(keep.sum()), np.int32),
                       (np.concatenate([r[keep], c[keep]]), np.concatenate([c[keep], r[keep]]))),
                      shape=(n, n)).tocsr()
    a.sum_duplicates()
    a.data[:] = 1
    adj = [list(a.indices[a.indptr[i]:a.indptr[i + 1]]) for i in range(n)]
    kernels.reset_launches()
    before = dict(TG.DISPATCH_STATS)
    got = alg.tc(F.csr_from_scipy(a, device=dev))
    assert got == alg.tc_naive(adj) == alg.tc(F.csr_from_scipy(a, device="cpu")) > 0
    signed = a.copy()
    signed.data = rng.choice([-1, 1, 2], a.nnz).astype(np.int32)
    for m in (signed, signed.astype(np.float32)):
        assert alg.tc(F.csr_from_scipy(m, device=dev)) == alg.tc(F.csr_from_scipy(m, device="cpu"))
        Ad, Ac = F.csr_from_scipy(m, device=dev), F.csr_from_scipy(m, device="cpu")
        T = op.FLOAT if m.dtype == np.float32 else op.INT
        got = TG.mxmT_masked(Ad, Ad, Ad, T.MULT, T.PLUS, T.GTZERO, 0)
        ref = TG.mxmT_masked(Ac, Ac, Ac, T.MULT, T.PLUS, T.GTZERO, 0)
        for f in ("indptr", "cols", "values", "row_ids", "nnz"):
            _assert_same(getattr(got, f), getattr(ref, f))
    assert kernels.LAUNCHES["mxmt_reduce"] == 3 and kernels.LAUNCHES["mxmt_masked"] == 2
    assert TG.DISPATCH_STATS["mxmT_torch"] == before["mxmT_torch"] + 5  # the CPU runs


def test_tc_kernel4_on_a_large_urand_graph_reads_its_plan_once(dev):
    """tc on a uniform graph at n = 2^22, degree 32 (~134 M entries): kernel 4's
    ordered walk, times 6, equals the full structural count of its plain
    version; the plan's products are Σ deg² and reach
    ``STATS["tc_products"]``, the ordered walk's elements
    ``STATS["tc_walked"]`` (about a sixth); a second count neither rebuilds
    nor reads the plan nor the check that chose the walk (no host read under
    the sync check); the check leaves nothing allocated."""
    A = uniform_csr(1 << 22, 32, dev)
    deg = (A.indptr[1:] - A.indptr[:-1]).long()
    alg.STATS["tc_products"] = alg.STATS["tc_walked"] = 0
    kernels.reset_launches()
    dispatched = TG.DISPATCH_STATS["mxmT_kernel"]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    walked = K45.ordered_walk(A)
    assert torch.cuda.memory_allocated(dev) == held
    got = alg.tc(A)
    assert kernels.LAUNCHES["mxmt_reduce"] == 1 and TG.DISPATCH_STATS["mxmT_kernel"] == dispatched
    plan = K45.mxmt_plan(A, A)
    assert plan.nhub == 0 and plan.stored == int(A.nnz)
    assert plan.products == int((deg ** 2).sum()) == alg.STATS["tc_products"]
    assert K45.ordered_walk(A) == walked == alg.STATS["tc_walked"] == int(K45._entry_degrees(A, A, ordered=True).sum())
    assert 0.14 < walked / plan.products < 0.19
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = TG.mxmT_masked_reduce(A, A, A, op.MULT_INT, op.GTZERO_INT, struct_only=True)
        ordered = K45.mxmt_reduce(A, A, A, None, struct_only=True, ordered=True)
        products = K45.mxmt_products(A, A)
        verdict = K45.ordered_walk(A) if alg._is_pattern(A) else None
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert K45.mxmt_plan(A, A) is plan and products == plan.products and verdict == walked
    assert int(again) == got == 6 * int(ordered) == int(K45.mxmt_reduce_plain(A, A, A, None, struct_only=True)) > 0
    assert alg.tc(A) == got and alg.STATS["tc_products"] == 2 * plan.products
    assert alg.STATS["tc_walked"] == 2 * walked


@pytest.mark.parametrize("graph", ["urand", "kron"])
def test_mxmt_ordered_walk_matches_plain(dev, graph):
    """Kernel 4's ordered walk and its gather floor against their plain
    versions: a uniform graph at n = 2^22, degree 32, and a Kronecker graph
    at scale 16 whose hubs take the chunk path (some of their entries below
    the diagonal, some above); times 6 it is the full structural count."""
    A = uniform_csr(1 << 22, 32, dev) if graph == "urand" else kron_csr(16, dev)
    plan = K45.mxmt_plan(A, A)
    if graph == "kron":
        assert plan.nchunks > plan.nhub > 0
    kernels.reset_launches()
    got = K45.mxmt_reduce(A, A, A, None, struct_only=True, ordered=True)
    assert kernels.LAUNCHES["mxmt_reduce"] == 1
    ref = K45.mxmt_reduce_plain(A, A, A, None, struct_only=True, ordered=True)
    _assert_same(got, ref)
    assert 6 * int(got) == int(K45.mxmt_reduce(A, A, A, None, struct_only=True)) > 0
    for values in (False, True):
        _assert_same(K8.mxmt_gather(A, A, values, ordered=True), K8.mxmt_gather_plain(A, A, values, ordered=True))
    mask, B = _mxmt_operands(dev, "i32", "hub")  # not symmetric: the walk's rule holds on any operands
    _assert_same(K45.mxmt_reduce(mask, B, B, None, struct_only=True, ordered=True),
                 K45.mxmt_reduce_plain(mask, B, B, None, struct_only=True, ordered=True))
    _assert_same(K8.mxmt_gather(mask, B, True, ordered=True), K8.mxmt_gather_plain(mask, B, True, ordered=True))


def _edited_on_card(dev, edit, n=1500, seed=9):
    """A symmetric 0/1 graph with one fault ``tc``'s ordered walk must not
    take: ``directed`` (one stored direction of an edge dropped),
    ``diagonal`` (one entry (v, v)), ``duplicate`` (an edge stored twice
    each way), ``weighted`` (values 1-3); ``pattern`` has none."""
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, 6 * n), rng.integers(0, n, 6 * n)
    keep = r != c
    a = sp.coo_matrix((np.ones(2 * int(keep.sum()), np.int32),
                       (np.concatenate([r[keep], c[keep]]), np.concatenate([c[keep], r[keep]]))),
                      shape=(n, n)).tocsr()
    a.sum_duplicates()
    a.data[:] = 1
    rows = np.repeat(np.arange(n), np.diff(a.indptr))
    cols = a.indices.astype(np.int64)
    e = int(np.flatnonzero(cols < rows)[rows.size // 3])
    if edit == "directed":
        rows, cols = np.delete(rows, e), np.delete(cols, e)
    elif edit in ("diagonal", "duplicate"):
        v = int(rows[e])
        extra = [(v, v)] if edit == "diagonal" else [(v, int(cols[e])), (int(cols[e]), v)]
        rows = np.concatenate([rows, [x for x, _ in extra]])
        cols = np.concatenate([cols, [y for _, y in extra]])
    vals = rng.integers(1, 4, rows.size).astype(np.int32) if edit == "weighted" else np.ones(rows.size, np.int32)
    order = np.lexsort((cols, rows))
    indptr = np.searchsorted(rows[order], np.arange(n + 1)).astype(np.int32)
    m = sp.csr_matrix((vals[order], cols[order].astype(np.int32), indptr), shape=(n, n))  # duplicates kept
    return F.csr_from_scipy(m, device=dev), F.csr_from_scipy(m, device="cpu")


@pytest.mark.parametrize("edit", ["pattern", "directed", "diagonal", "duplicate", "weighted"])
def test_tc_takes_the_ordered_walk_only_on_a_symmetric_pattern_on_the_card(dev, edit):
    """On the card ``tc`` equals the CPU count on each graph; a symmetric 0/1
    pattern takes kernel 4's ordered walk (``STATS["tc_walked"]`` gains
    ``ordered_walk``'s count, no dispatch through ``mxmT_masked_reduce``),
    and a directed graph, a diagonal entry, a duplicate or values other than
    ones the full walk (it gains the products)."""
    Ad, Ac = _edited_on_card(dev, edit)
    if edit == "duplicate":
        assert bool(((Ac.cols[1:] == Ac.cols[:-1]) & (Ac.row_ids[1:] == Ac.row_ids[:-1])).any())
    want = alg.tc(Ac)
    alg.STATS["tc_products"] = alg.STATS["tc_walked"] = 0
    dispatched = TG.DISPATCH_STATS["mxmT_kernel"]
    kernels.reset_launches()
    assert alg.tc(Ad) == want > 0
    assert kernels.LAUNCHES["mxmt_reduce"] == 1
    products = K45.mxmt_products(Ad, Ad)
    assert alg.STATS["tc_products"] == products
    if edit == "pattern":
        assert TG.DISPATCH_STATS["mxmT_kernel"] == dispatched
        assert alg.STATS["tc_walked"] == K45.ordered_walk(Ad) == K45.ordered_walk(Ac) < products
    else:
        assert TG.DISPATCH_STATS["mxmT_kernel"] == dispatched + 1
        assert alg.STATS["tc_walked"] == products
        assert not alg._is_pattern(Ad) or K45.ordered_walk(Ad) is None


def _bins_operands(dev, dtype, signed=False):
    """graphs.spgemm_bins (small, medium and large rows of A @ B) on the card:
    f32 values in [0.5, 1.5), i32 the f32 ones x 1000 truncated, or with
    ``signed`` i32 values of ±1 whose sums cancel; A's capacity above nnz."""
    a, b = spgemm_bins()
    if dtype == "i32":
        a, b = (a * 1000).astype(np.int32), (b * 1000).astype(np.int32)
        if signed:
            rng = np.random.default_rng(21)
            a.data, b.data = (rng.choice([-1, 1], m.nnz).astype(np.int32) for m in (a, b))
    return F.csr_from_scipy(a, capacity=a.nnz + 13, device=dev), F.csr_from_scipy(b, device=dev)


def _same_csr(got, ref, float_plus=False):
    """Every field, padding too; f32 PLUS values within rtol=1e-5, atol=1e-5."""
    assert got.shape == ref.shape and got.capacity == ref.capacity
    for f in ("indptr", "cols", "row_ids", "nnz", "fill"):
        _assert_same(getattr(got, f), getattr(ref, f))
    if float_plus:
        torch.testing.assert_close(got.values.cpu(), ref.values.cpu(), rtol=1e-5, atol=1e-5)
    else:
        _assert_same(got.values, ref.values)


@pytest.mark.parametrize("dtype", ["f32", "i32"])
@pytest.mark.parametrize("add", ["PLUS", "MIN", "MAX"])
def test_mxm_matches_plain(dev, dtype, add):
    """Kernel 9, every mul with this add and dtype, against its plain version
    on the same CUDA tensors, with rows in each of its three bins."""
    A, B = _bins_operands(dev, dtype)
    plan = K9.mxm_plan(A, B)
    assert plan.nsmall > 0 and plan.nmedium > 0 and plan.nlarge > 0
    T = op.FLOAT if dtype == "f32" else op.INT
    oa = getattr(T, add)
    for mul in MULS:
        om = getattr(T, mul)
        kernels.reset_launches()
        got = K9.mxm(A, B, om, oa, oa.identity)
        assert kernels.LAUNCHES["spgemm_mxm"] == 1
        _same_csr(got, K9.mxm_plain(A, B, om, oa, oa.identity), float_plus=dtype == "f32" and add == "PLUS")


@pytest.mark.parametrize("add", ["PLUS", "MIN", "MAX"])
def test_mxm_generic_matches_plain(dev, add):
    """Kernel 9 (the mul a kernel argument) with every f32 mul and this add
    against its plain version on the same CUDA tensors, with rows in each
    of its three bins; an i32 mul outside the six raises."""
    A, B = _bins_operands(dev, "f32")
    oa = getattr(op.FLOAT, add)
    for mul in GENERIC_MULS["f32"]:
        om = getattr(op.FLOAT, mul)
        kernels.reset_launches()
        got = K9.mxm(A, B, om, oa, oa.identity)
        assert kernels.LAUNCHES["spgemm_mxm"] == 1
        _same_csr(got, K9.mxm_plain(A, B, om, oa, oa.identity), float_plus=add == "PLUS")
    with pytest.raises(NotImplementedError):
        K9.mxm(*_bins_operands(dev, "i32"), op.MINUS_INT, op.PLUS_INT, 0)


def test_generic_entries_refuse_f32_bitwise_muls(dev, monkeypatch):
    """An f32 request with a bitwise mul (which no gate lets through, and
    which the kernels cannot compute in f32) reaches the C entries of
    kernel 1's generic family and of kernels 5, 4 and 9 through a widened
    gate: each refuses it (cudaErrorInvalidValue) and the wrapper raises."""
    bor, plus, f32 = int(op.KernelCode.BOR), int(op.KernelCode.PLUS), K1.DTYPE_CODES[torch.float32]
    A = _typed_pull_matrix("deg16", "f32", dev)
    monkeypatch.setattr(K1, "pull_codes", lambda *a, **k: (bor, plus, f32))
    with pytest.raises(RuntimeError, match="invalid argument"):
        K1.spmv_pull(A, torch.ones(A.shape[1], device=dev), op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
    mask, M = _mxmt_operands(dev, "f32", "deg48")
    monkeypatch.setattr(K45, "masked_codes", lambda *a, **k: (bor, plus, f32))
    monkeypatch.setattr(K45, "reduce_codes", lambda *a, **k: (bor, f32))
    with pytest.raises(RuntimeError, match="invalid argument"):
        K45.mxmt_masked(mask, M, M, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
    with pytest.raises(RuntimeError, match="invalid argument"):
        K45.mxmt_reduce(mask, M, M, op.MULT_FLOAT)
    monkeypatch.setattr(K9, "mxm_codes", lambda *a, **k: (bor, plus, f32))
    with pytest.raises(RuntimeError, match="invalid argument"):
        K9.mxm(*_bins_operands(dev, "f32"), op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)


@pytest.mark.parametrize("cluster", [2, 8, 16])
def test_mxm_large_rows_in_cluster_windows(dev, monkeypatch, cluster):
    """Large rows whose columns are wider than a cluster's window go in
    windows of C x W columns (here W = 64: four windows at n = 2000 with 8
    CTAs, sixteen with 2, two with 16), the row walked once a window, and
    the symbolic phase's bitmap in windows of 512 columns, bitwise against
    the plain version (f32 MIN, i32 PLUS)."""
    monkeypatch.setattr(K9, "LARGE_WORDS", 16)
    monkeypatch.setattr(K9, "LARGE_SHARED_BYTES", K9.LARGE_STATIC_BYTES + 4 * 64 + 64 // 8)
    monkeypatch.setattr(K9, "CLUSTER", cluster)
    A, B = _bins_operands(dev, "f32")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert K9.cluster_shape(B.shape[1], sms, K9.LARGE_SHARED_BYTES) == (cluster, 64, -(-2000 // (64 * cluster)))
    _same_csr(K9.mxm(A, B, op.PLUS_FLOAT, op.MIN_FLOAT, float("inf")),
              K9.mxm_plain(A, B, op.PLUS_FLOAT, op.MIN_FLOAT, float("inf")))
    A, B = _bins_operands(dev, "i32")
    _same_csr(K9.mxm(A, B, op.MULT_INT, op.PLUS_INT, 0), K9.mxm_plain(A, B, op.MULT_INT, op.PLUS_INT, 0))


def _wide_operands(dev, n=1 << 22, m=8, k=1000, per_row=20, seed=23):
    """A: m x k, every entry stored (large rows of k x per_row products); B:
    k x n with per_row random columns a row; f32 values in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    a = sp.csr_matrix(rng.uniform(0.5, 1.5, (m, k)).astype(np.float32))
    rows = np.repeat(np.arange(k), per_row)
    b = sp.csr_matrix((rng.uniform(0.5, 1.5, rows.size).astype(np.float32), (rows, rng.integers(0, n, rows.size))),
                      shape=(k, n))
    b.sum_duplicates()
    return F.csr_from_scipy(a, device=dev), F.csr_from_scipy(b, device=dev)


def test_mxm_numeric_allocates_only_c(dev):
    """Kernel 9 allocates C, the compaction's scratch and its small m-sized
    arrays, and nothing that grows with n: 8 large rows against B of 2^22
    columns (sixteen cluster windows), where one dense accumulator a row
    would take 128 MiB.  Against the plain version too."""
    A, B = _wide_operands(dev)
    plan = K9.mxm_plan(A, B)
    assert plan.nlarge == A.shape[0]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    got = K9.mxm(A, B, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - before
    size = got.capacity
    assert size > 100_000
    # cols, values, rows (12 bytes an entry) and the compaction's copy (8); 1 MiB for the m-sized arrays
    assert peak <= 20 * size + (1 << 20), (peak, size)
    _same_csr(got, K9.mxm_plain(A, B, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0), float_plus=True)


def test_mxm_large_cluster_that_does_not_fit_raises(dev, monkeypatch):
    """A cluster whose CTAs' shared memory the card cannot give (here W of
    2^18 columns, 1 MiB of values a CTA) raises; nothing falls back."""
    A, B = _wide_operands(dev)
    monkeypatch.setattr(K9, "LARGE_SHARED_BYTES", 4 << 20)
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="launch failed"):
        K9.mxm(A, B, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
    assert kernels.LAUNCHES["spgemm_mxm"] == 0


def _medium_operands(dev, dtype, n=1 << 18, nan=False, seed=24):
    """A @ B with medium rows whose columns span n = 2^18 (three radix
    passes): rows 0-3 take 200 to 1,600 of B's first 2,000 rows (4 random
    columns each, 800 to 6,400 products); row 4 takes B's rows 3,000-3,999,
    whose one entry is column 12,345 (1,000 products, one column); the
    other rows are small.  With ``nan`` some of B's f32 values are NaN."""
    rng = np.random.default_rng(seed)
    k = 4000
    b_rows = np.concatenate([np.repeat(np.arange(3000), 4), np.arange(3000, 4000)])
    b_cols = np.concatenate([rng.integers(0, n, 3 * 4000), np.full(1000, 12345)])
    b = sp.csr_matrix((rng.uniform(0.5, 1.5, b_rows.size).astype(np.float32), (b_rows, b_cols)), shape=(k, n))
    b.sum_duplicates()
    heavy = [rng.choice(2000, c, replace=False) for c in (200, 400, 800, 1600)] + [np.arange(3000, 4000)]
    a_rows = np.concatenate([np.repeat(np.arange(5), [len(h) for h in heavy]), rng.integers(5, 300, 900)])
    a_cols = np.concatenate([*heavy, rng.integers(0, k, 900)])
    a = sp.csr_matrix((rng.uniform(0.5, 1.5, a_rows.size).astype(np.float32), (a_rows, a_cols)), shape=(300, k))
    a.sum_duplicates()
    if nan:
        b.data[rng.random(b.nnz) < 0.01] = np.nan
    if dtype == "i32":
        a, b = (a * 1000).astype(np.int32), (b * 1000).astype(np.int32)
    return F.csr_from_scipy(a, device=dev), F.csr_from_scipy(b, device=dev)


def test_mxm_medium_rows_radix_sorted(dev):
    """Medium rows of columns up to 2^18 (three 8-bit radix passes) and one
    whose 1,000 products all hit one column, against the plain version:
    MULT/PLUS f32, PLUS/MIN and PLUS/MAX i32 bitwise."""
    assert K9.radix_passes(1 << 18) == 3
    A, B = _medium_operands(dev, "f32")
    plan = K9.mxm_plan(A, B)
    assert plan.nmedium == 5 and plan.nlarge == 0
    _same_csr(K9.mxm(A, B, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0),
              K9.mxm_plain(A, B, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0), float_plus=True)
    one = K9.mxm(A, B, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
    assert int(one.indptr[5] - one.indptr[4]) == 1 and int(one.cols[int(one.indptr[4])]) == 12345
    A, B = _medium_operands(dev, "i32")
    for oa, init in ((op.MIN_INT, np.iinfo(np.int32).max), (op.MAX_INT, np.iinfo(np.int32).min)):
        _same_csr(K9.mxm(A, B, op.PLUS_INT, oa, init), K9.mxm_plain(A, B, op.PLUS_INT, oa, init))


@pytest.mark.parametrize("add", ["MIN", "MAX"])
def test_mxm_nan_through_remote_cas(dev, add):
    """f32 MIN / MAX fold NaN (torch.minimum / maximum propagate it) through
    the CAS loop: into a cluster neighbour's shared memory in the large
    bin, into the table in the others; bitwise against the plain version,
    NaN equal to NaN, on spgemm_bins and on the medium rows."""
    a, b = spgemm_bins()
    rng = np.random.default_rng(25)
    b.data[rng.random(b.nnz) < 0.01] = np.nan
    A, B = F.csr_from_scipy(a, device=dev), F.csr_from_scipy(b, device=dev)
    oa = getattr(op.FLOAT, add)
    for mul in ("PLUS", "MULT"):
        om = getattr(op.FLOAT, mul)
        got = K9.mxm(A, B, om, oa, oa.identity)
        assert torch.isnan(got.values[:int(got.nnz)]).any()
        _same_csr(got, K9.mxm_plain(A, B, om, oa, oa.identity))
    A, B = _medium_operands(dev, "f32", nan=True)
    _same_csr(K9.mxm(A, B, op.PLUS_FLOAT, oa, oa.identity), K9.mxm_plain(A, B, op.PLUS_FLOAT, oa, oa.identity))


@pytest.mark.parametrize("windows", [False, True])
def test_mxm_nan_init_keeps_only_reached_columns(dev, monkeypatch, windows):
    """With init NaN every folded value is NaN and is kept (NaN != NaN), but
    only at the (i, j) that some product reaches: the large bin, whose
    untouched columns also hold NaN once init is folded in, must keep them
    out (its occupancy bitmap), in one cluster window or, with W = 64 forced,
    in many.  PLUS/MIN and MULT/PLUS f32 on spgemm_bins, bitwise against the
    plain version (NaN equal to NaN), and C's structure against A @ B's."""
    if windows:
        monkeypatch.setattr(K9, "LARGE_SHARED_BYTES", K9.LARGE_STATIC_BYTES + 4 * 64 + 64 // 8)
    a, b = spgemm_bins()
    A, B = _bins_operands(dev, "f32")
    assert K9.mxm_plan(A, B).nlarge > 0
    pattern = ((a != 0).astype(np.int32) @ (b != 0).astype(np.int32)).tocsr()
    pattern.sort_indices()
    for om, oa in ((op.PLUS_FLOAT, op.MIN_FLOAT), (op.MULT_FLOAT, op.PLUS_FLOAT)):
        got = K9.mxm(A, B, om, oa, float("nan"))
        _same_csr(got, K9.mxm_plain(A, B, om, oa, float("nan")))
        k = int(got.nnz)
        assert k == pattern.nnz
        np.testing.assert_array_equal(got.indptr.cpu().numpy(), pattern.indptr)
        np.testing.assert_array_equal(got.cols[:k].cpu().numpy(), pattern.indices)
        assert torch.isnan(got.values[:k]).all()


def test_mxm_drops_init_valued_results(dev):
    """Results equal to init are left out in every bin, on the device, and
    the rows after them move up: ±1 i32 sums that cancel, and PLUS/MIN f32
    with init 2.0 (every min at or above 2 is init), bitwise against the
    plain version."""
    A, B = _bins_operands(dev, "i32", signed=True)
    got = K9.mxm(A, B, op.MULT_INT, op.PLUS_INT, 0)
    ref = K9.mxm_plain(A, B, op.MULT_INT, op.PLUS_INT, 0)
    assert int(ref.nnz) < ref.capacity - 100
    plan = K9.mxm_plan(A, B)
    a, b = spgemm_bins()
    reached = np.diff(((a != 0).astype(np.int32) @ (b != 0).astype(np.int32)).tocsr().indptr)
    kept = np.diff(ref.indptr.cpu().numpy())
    rows = plan.rows.cpu().numpy()
    medium, large = rows[plan.nsmall:plan.nsmall + plan.nmedium], rows[plan.nsmall + plan.nmedium:]
    assert (kept[large] < reached[large]).any()  # a large row left something out
    assert (kept[medium] < reached[medium]).any()  # and a medium row
    _same_csr(got, ref)
    A, B = _bins_operands(dev, "f32")
    got = K9.mxm(A, B, op.PLUS_FLOAT, op.MIN_FLOAT, 2.0)
    ref = K9.mxm_plain(A, B, op.PLUS_FLOAT, op.MIN_FLOAT, 2.0)
    assert 0 < int(ref.nnz) < ref.capacity
    _same_csr(got, ref)


def test_mxm_out_capacity_and_empty_operands(dev):
    """out_capacity below the result keeps its first entries (nnz the
    capacity), above it pads; A with no entries and B with no entries give
    an empty C; a rectangular A x B."""
    A, B = _bins_operands(dev, "i32")
    full = K9.mxm(A, B, op.MULT_INT, op.PLUS_INT, 0)
    for cap in (1000, int(full.nnz) + 50):
        _same_csr(K9.mxm(A, B, op.MULT_INT, op.PLUS_INT, 0, out_capacity=cap),
                  K9.mxm_plain(A, B, op.MULT_INT, op.PLUS_INT, 0, out_capacity=cap))
    empty = F.csr_from_entries((A.shape[0], A.shape[0]), [], [], [], dtype=np.int32, device=dev)
    for a, b in ((empty, B), (A, empty)):
        got = K9.mxm(a, b, op.MULT_INT, op.PLUS_INT, 0)
        assert int(got.nnz) == 0 and got.capacity == 0 and int(got.indptr[-1]) == 0
    a, b = spgemm_bins(600, seed=3)
    Ar = F.csr_from_scipy(a[:, :450].tocsr(), device=dev)
    Br = F.csr_from_scipy(b[:450, :300].tocsr(), device=dev)
    _same_csr(K9.mxm(Ar, Br, op.MULT_FLOAT, op.MAX_FLOAT, -np.inf),
              K9.mxm_plain(Ar, Br, op.MULT_FLOAT, op.MAX_FLOAT, -np.inf))


def test_mxm_dispatch_and_raises_without_its_library(dev, monkeypatch):
    """ops.mxm launches kernel 9 for a covered request (products_cap takes
    the torch path), and raises, not falls back, when the library fails to
    build."""
    A, B = _bins_operands(dev, "f32")
    kernels.reset_launches()
    before = dict(TG.DISPATCH_STATS)
    got = TG.mxm(A, B, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
    capped = TG.mxm(A, B, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0, products_cap=K9.mxm_plan(A, B).products)
    assert kernels.LAUNCHES["spgemm_mxm"] == 1
    assert TG.DISPATCH_STATS["mxm_kernel"] == before["mxm_kernel"] + 1
    assert TG.DISPATCH_STATS["mxm_torch"] == before["mxm_torch"] + 1
    _same_csr(got, capped, float_plus=True)

    def broken():
        raise BuildError("nvcc failed")

    monkeypatch.setattr(K9, "load_library", broken)
    with pytest.raises(BuildError):
        TG.mxm(A, B, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
    assert kernels.LAUNCHES["spgemm_mxm"] == 1


def _dense_graph(dev, n=1024, d=128, inf=False):
    """random_graph(n, d) with values uniform in [0.5, 1.5) on the card: C = A
    @ A has ~n d^2 products, over the dense gate at n = 1024, d = 128
    (16.8 M against 2^22 and MXM_DENSE_PER_MKN n^3); with ``inf`` one
    stored value is +inf."""
    a = random_graph(n, d)
    a.data = np.random.default_rng(d).uniform(0.5, 1.5, a.nnz).astype(np.float32)
    if inf:
        a.data[a.indptr[3]] = np.inf
    return a, F.csr_from_scipy(a, device=dev)


def test_mxm_dense_route_matches_kernel9(dev):
    """ops.mxm takes the dense route over the gate (DISPATCH_STATS mxm_dense,
    no kernel 9 launch), and its C equals kernel 9's on the same input:
    indptr, columns, rows, nnz, capacity, padding and fill bitwise, values
    within rtol 1e-5 of scipy's float64 A @ A."""
    a, A = _dense_graph(dev)
    products = K9.mxm_plan(A, A).products
    assert products >= max(TG.MXM_DENSE_MIN_PRODUCTS, TG.MXM_DENSE_PER_MKN * A.shape[0] ** 3)
    kernels.reset_launches()
    before = dict(TG.DISPATCH_STATS)
    got = TG.mxm(A, A, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
    assert TG.DISPATCH_STATS["mxm_dense"] == before["mxm_dense"] + 1
    assert TG.DISPATCH_STATS["mxm_kernel"] == before["mxm_kernel"] and kernels.LAUNCHES["spgemm_mxm"] == 0
    _same_csr(got, K9.mxm(A, A, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0), float_plus=True)
    ref = (a.astype(np.float64) @ a.astype(np.float64)).tocsr()
    ref.sort_indices()
    k = int(got.nnz)
    assert k == ref.nnz
    np.testing.assert_array_equal(got.indptr.cpu().numpy(), ref.indptr)
    np.testing.assert_array_equal(got.cols[:k].cpu().numpy(), ref.indices)
    np.testing.assert_allclose(got.values[:k].cpu().numpy(), ref.data, rtol=1e-5)


def test_mxm_dense_route_full_f32_whatever_tf32(dev):
    """With torch.backends.cuda.matmul.allow_tf32 set by the caller the route
    still multiplies in full f32: C equals the TF32-off C bitwise, the
    setting is True again after, and a TF32 matmul of the same dense
    operands would have differed."""
    _, A = _dense_graph(dev)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = TG._mxm_dense(A, A)
        torch.backends.cuda.matmul.allow_tf32 = True
        on = TG._mxm_dense(A, A)
        assert torch.backends.cuda.matmul.allow_tf32
        _same_csr(on, off)
        n = A.shape[0]
        Ad = TG._dense0(A, n, n)
        assert not torch.equal(torch.matmul(Ad, Ad), TG._dense_matmul(Ad, Ad))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_mxm_dense_route_reads_the_host_once(dev):
    """No step of the route waits for the device but the one read of C's
    size: with out_capacity it runs under set_sync_debug_mode("error"),
    and without it one synchronizing call is reported (mode "warn")."""
    import warnings

    _, A = _dense_graph(dev)
    cap = TG._mxm_dense(A, A).capacity
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = TG._mxm_dense(A, A, out_capacity=cap)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert got.capacity == cap
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            TG._mxm_dense(A, A)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert sum("synchroniz" in str(w.message) for w in seen) == 1


def test_mxm_dense_route_out_capacity_and_empty_operands(dev):
    """out_capacity below the entry count keeps the first entries (nnz the
    capacity), above it pads, as kernel 9 does; operands with no stored
    entry give an empty C of capacity 0."""
    _, A = _dense_graph(dev)
    full = K9.mxm(A, A, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
    for cap in (1000, int(full.nnz) + 50):
        _same_csr(TG._mxm_dense(A, A, out_capacity=cap),
                  K9.mxm(A, A, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0, out_capacity=cap), float_plus=True)
    empty = F.csr_from_entries(A.shape, [], [], [], dtype=np.float32, device=dev)
    for a, b in ((empty, A), (A, empty)):
        got = TG._mxm_dense(a, b)
        _same_csr(got, K9.mxm(a, b, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0))
        assert int(got.nnz) == 0 and got.capacity == 0


def test_mxm_dense_gate_dispatch(dev):
    """Over the gate only MULT/PLUS f32, init 0, finite, with no
    products_cap or block_products takes the dense route: a stored inf, an
    i32 graph and MIN/PLUS launch kernel 9, the caps take the torch path,
    and a graph under the gate launches kernel 9; each result as the
    route it took computes it."""
    _, A = _dense_graph(dev)
    _, Ainf = _dense_graph(dev, inf=True)
    Ai = replace(A, values=A.values.to(torch.int32), fill=A.fill.to(torch.int32))
    _, small = _dense_graph(dev, 1024, 16)
    calls = {"inf": (Ainf, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0, {}, "mxm_kernel"),
             "i32": (Ai, op.MULT_INT, op.PLUS_INT, 0, {}, "mxm_kernel"),
             "min": (A, op.PLUS_FLOAT, op.MIN_FLOAT, float("inf"), {}, "mxm_kernel"),
             "init": (A, op.MULT_FLOAT, op.PLUS_FLOAT, 1.0, {}, "mxm_kernel"),
             "small": (small, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0, {}, "mxm_kernel"),
             "capped": (A, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0, {"products_cap": 1 << 30}, "mxm_torch"),
             "windows": (A, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0, {"block_products": 1 << 22}, "mxm_torch"),
             "dense": (A, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0, {}, "mxm_dense")}
    for name, (M, om, oa, init, kw, route) in calls.items():
        before = dict(TG.DISPATCH_STATS)
        got = TG.mxm(M, M, om, oa, init, **kw)
        moved = {k for k in TG.DISPATCH_STATS if TG.DISPATCH_STATS[k] != before[k]}
        assert moved == {route}, name
        if route == "mxm_kernel":
            _same_csr(got, K9.mxm_plain(M, M, om, oa, init), float_plus=oa.name == "PLUS" and name != "i32")
    assert TG.stored_finite(A) and not TG.stored_finite(Ainf)


def _road(side, seed=9):
    """A side x side grid in row-major order, weights uniform(0.1, 1.0),
    symmetric."""
    idx = np.arange(side * side).reshape(side, side)
    r = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    c = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    w = np.random.default_rng(seed).uniform(0.1, 1.0, r.size).astype(np.float32)
    n = side * side
    return sp.coo_matrix((np.concatenate([w, w]), (np.concatenate([r, c]), np.concatenate([c, r]))),
                         shape=(n, n)).tocsr()


def _random(n=3000, seed=1):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)
    a = sp.coo_matrix((rng.uniform(0.1, 2.0, r.size).astype(np.float32), (r, c)), shape=(n, n)).tocsr()
    a.sum_duplicates()
    return a  # directed, some vertices unreachable


def _isolated_source():
    """A side-48 grid and one vertex with no entries, the source: the queue
    empties in round 1."""
    a = _road(48)
    n = a.shape[0] + 1
    return sp.csr_matrix((a.data, a.indices, np.append(a.indptr, a.nnz)), shape=(n, n)), n - 1


RESIDENT_GRAPHS = {
    "path": lambda: (path_graph(4096), 0),
    "barbell": lambda: (barbell_graph(300, 8192, 8), 0),
    "road": lambda: (_road(48), 0),
    "random": lambda: (_random(), 0),
    "isolated": _isolated_source,
}


@pytest.mark.parametrize("graph", list(RESIDENT_GRAPHS))
def test_resident_matches_plain(dev, graph):
    """Kernel 6 against its plain versions, from the graph's source and
    from vertex n - 1: depths and distances bitwise, BFS stats (rounds,
    capped, wide rounds) equal, SSSP's cap flag clear and its rounds at
    most the plain version's.  The path's depths are arange + 1 and its
    distances the f32 running sums of its weights; the barbell's rounds run
    on the lead cluster and on the whole grid, in turn."""
    a, source = RESIDENT_GRAPHS[graph]()
    n = a.shape[0]
    A = F.csr_from_scipy(a, fill=np.float32(np.inf), device=dev)
    plan = K6.resident_plan(A)
    for src in (source, n - 1):
        v, stats = K6.bfs_resident(A, src)
        ref, ref_stats = K6.bfs_resident_plain(A, src)
        _assert_same(v, ref)
        assert stats.tolist() == ref_stats.tolist()
        d, stats = K6.sssp_resident(A, src)
        ref, ref_stats = K6.sssp_resident_plain(A, src)
        _assert_same(d, ref)
        assert stats.tolist()[1] == ref_stats.tolist()[1] == 0
        assert 0 < stats.tolist()[0] <= ref_stats.tolist()[0]
        assert stats.tolist()[2] <= stats.tolist()[0]
    v, stats = K6.bfs_resident(A, source)
    rounds, _, wide = stats.tolist()
    if graph == "path":
        np.testing.assert_array_equal(v.cpu().numpy(), np.arange(1, n + 1))
        w = a.diagonal(1).astype(np.float32)
        d, _ = K6.sssp_resident(A, 0)
        np.testing.assert_array_equal(d.cpu().numpy(), np.concatenate([[0], np.cumsum(w)]).astype(np.float32))
        assert rounds == n and wide == 0
    if graph == "barbell":
        assert plan.wide_above == K6.LEAD_CTAS * K6.CTA_THREADS // plan.team
        assert 0 < wide < rounds
    if graph == "isolated":
        assert stats.tolist() == [1, 0, 0] and int(v.sum()) == 1


@pytest.mark.parametrize("graph", ["path", "barbell"])
def test_resident_every_round_wide(dev, graph):
    """Kernel 6 with T = 0: every round on the whole grid, the first one
    too, and the run ends right after a wide round.  The plain versions'
    results; BFS's rounds equal and all wide."""
    a, source = RESIDENT_GRAPHS[graph]()
    A = F.csr_from_scipy(a, fill=np.float32(np.inf), device=dev)
    v, stats = K6._launch_bfs(A, source, 0)
    ref, ref_stats = K6.bfs_resident_plain(A, source)
    _assert_same(v, ref)
    rounds = ref_stats.tolist()[0]
    assert stats.tolist() == [rounds, 0, rounds]
    d, stats = K6._launch_sssp(A, source, 0)
    _assert_same(d, K6.sssp_resident_plain(A, source)[0])
    assert stats.tolist()[1] == 0 and stats.tolist()[0] == stats.tolist()[2]


def test_resident_stops_a_negative_cycle(dev):
    """0 -> 1 -> 2 -> 0 weighs -1: kernel 6 stops after n + 2 rounds and
    flags it."""
    a = sp.csr_matrix((np.array([1.0, 1.0, -3.0, 1.0], np.float32), ([0, 1, 2, 2], [1, 2, 0, 3])),
                      shape=(5, 5))
    A = F.csr_from_scipy(a, fill=np.float32(np.inf), device=dev)
    d, stats = K6.sssp_resident(A, 0)
    assert stats.tolist()[:2] == [7, 1]
    assert bool(torch.isinf(d[4])) and bool((d[:4] < 3).all())


def test_resident_does_not_synchronize(dev):
    """Once a matrix's plan is built, neither kind of kernel 6 waits for the
    stream: the caller's one read of stats is the run's only host read."""
    a = barbell_graph(100, 4096, 8)
    A = F.csr_from_scipy(a, fill=np.float32(np.inf), device=dev)
    K6.resident_plan(A)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        v, v_stats = K6.bfs_resident(A, 0)
        d, d_stats = K6.sssp_resident(A, 0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _assert_same(v, K6.bfs_resident_plain(A, 0)[0])
    _assert_same(d, K6.sssp_resident_plain(A, 0)[0])
    assert v_stats.tolist()[2] > 0


def test_road_route_launches_kernel6(dev, monkeypatch):
    """The public bfs / sssp take the resident route on a road grid: one
    launch and one host read per run, results equal to the level loop's."""
    a = _road(40)
    A = F.csr_from_scipy(a, fill=np.float32(np.inf), device=dev)
    kernels.reset_launches()
    for k in alg.STATS:
        alg.STATS[k] = 0
    v = alg.bfs(A, 0, At=A).values
    d = alg.sssp(A, 0, At=A).values
    assert kernels.LAUNCHES["bfs_resident"] == kernels.LAUNCHES["sssp_resident"] == 1
    assert alg.STATS["resident"] == alg.STATS["host_syncs"] == 2
    assert int(v.max()) == 79
    monkeypatch.setattr(alg, "RESIDENT_BYTES", 0)
    _assert_same(v, alg.bfs(A, 0, At=A).values)
    _assert_same(d, alg.sssp(A, 0, At=A).values)
    assert alg.STATS["level_loop"] == 2


@pytest.mark.parametrize("mode", ["auto", "push", "pull"])
@pytest.mark.parametrize("kind", ["bfs", "sssp"])
def test_level_loop_counts_its_work_as_the_plain_loop_does(dev, kind, mode, monkeypatch):
    """The level loop on the card counts the plain loop's push_edges and
    pull_entries (the hub source's degree from word 0 of the first read),
    reads the count once a level, and launches BFS one launch a push level,
    SSSP two, and a pull level the pack of the mask into kernel 1's bitmap,
    kernel 1 and kernel 3's update; kernel 1 walks one segment of x a pull
    (x fits the card's L2)."""
    monkeypatch.setattr(alg, "RESIDENT_BYTES", 0)
    a = _graph()
    a = (a + a.T).tocsr()
    descriptor = {"auto": None, "push": Descriptor(push_only=True), "pull": Descriptor(pull_only=True)}[mode]
    run = alg.bfs if kind == "bfs" else alg.sssp
    seen = {}
    for device in ("cpu", dev):
        M = F.csr_from_scipy(a, fill=np.float32(np.inf), device=device)
        run(M, 17, descriptor, At=M)  # the pull plan and the stored count, read once a matrix
        kernels.reset_launches()
        for k in alg.STATS:
            alg.STATS[k] = 0
        run(M, 17, descriptor, At=M)
        seen[str(device)] = dict(alg.STATS), dict(kernels.LAUNCHES)
    (cpu, _), (card, launches) = seen["cpu"], seen[str(dev)]
    assert card == cpu and card["host_syncs"] == card["levels"]
    assert card["push_edges"] >= (a.indptr[18] - a.indptr[17] if card["push"] else 0)
    per_push = {"bfs": ("bfs_push_level", 1), "sssp": ("sssp_push_level", 2)}[kind]
    assert launches[per_push[0]] == per_push[1] * card["push"]
    assert launches["spmv_pull"] == launches["level_update"] == launches["valid_bits"] == card["pull"]
    assert launches["pull_segments"] == card["pull"]
    assert sum(v for k, v in launches.items() if k != "pull_segments") == per_push[1] * card["push"] + 3 * card["pull"]


def test_pr_packs_no_mask(dev):
    """PageRank's pulls pass no x_valid: kernel 1 an iteration and no pack."""
    a = _graph(n=2000, seed=5, hub=300)
    a = (a + a.T).tocsr()
    outdeg = np.asarray(a.sum(axis=0)).ravel()
    M = F.csr_from_scipy(a.multiply(0.85 / outdeg).tocsr().astype(np.float32), device=dev)
    levels = alg.STATS["levels"]
    kernels.reset_launches()
    alg.pr(M)
    assert kernels.LAUNCHES["spmv_pull"] == alg.STATS["levels"] - levels > 0
    assert kernels.LAUNCHES["valid_bits"] == 0


@pytest.fixture
def manual_dma(monkeypatch):
    """kernels.staged.MANUAL_DMA on, as SPLA_MANUAL_DMA=1 sets it."""
    monkeypatch.setattr(K7, "MANUAL_DMA", True)


def _check_pull(got, ref, exact):
    if exact:
        _assert_same(got, ref)
    else:
        # summation order differs: f32 tolerance
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5, equal_nan=True)


@pytest.mark.parametrize("graph", list(PULL_GRAPHS))
@pytest.mark.parametrize("add", ["PLUS", "MIN", "MAX"])
@pytest.mark.parametrize("stage", [16, 1024])
def test_spmv_pull_staged_matches_plain_and_kernel1(dev, graph, add, stage):
    """Kernel 7 at 2, 3 and 4 slots against its plain version and kernel 1,
    every mul, both operand orders, with and without masks, on kernel 1's
    test graphs (at stage 1024 the hub graphs' rows of 5000 and 9000
    entries are rows of two and three chunks; at 16 every row of more than
    four entries is a long row); the structural variant; a repeated call
    gives the same bits."""
    A = _pull_matrix(graph, "f32", dev, extra=11 if graph in ("hub", "deg6") else 0)
    n = A.shape[0]
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.random(n, dtype=np.float32)).to(dev)
    x[3], x[5] = float("nan"), float("inf")
    x_valid = torch.from_numpy(rng.random(n) < 0.8).to(dev)
    row_sel = torch.from_numpy(rng.random(n) < 0.6).to(dev)
    oa = getattr(op.FLOAT, add)
    for mul in MULS:
        om = getattr(op.FLOAT, mul)
        for xv, rs, swap in ((None, None, False), (x_valid, row_sel, True)):
            ref, ref_has = K7.spmv_pull_staged_plain(A, x, om, oa, oa.identity, xv, rs, swap, stage=stage)
            k1, k1_has = K1.spmv_pull(A, x, om, oa, oa.identity, xv, rs, want_has=True, swap=swap)
            for slots in (2, 3, 4):
                got, has = K7.spmv_pull_staged(A, x, om, oa, oa.identity, xv, rs, want_has=True,
                                               swap=swap, slots=slots, stage=stage)
                assert torch.equal(has, ref_has) and torch.equal(has, k1_has)
                _check_pull(got, ref, add != "PLUS")
                _check_pull(got, k1, add != "PLUS")
                again, _ = K7.spmv_pull_staged(A, x, om, oa, oa.identity, xv, rs, swap=swap, slots=slots,
                                               stage=stage)
                _assert_same(again, got)
    for slots in (2, 3, 4):
        for xv in (x_valid, x > 0.99):
            _assert_same(K7.spmv_pull_staged_structural(A, xv, row_sel, slots=slots, stage=stage),
                         K1.spmv_pull_structural(A, xv, row_sel))


def test_spmv_pull_staged_fewer_stages_than_slots(dev):
    """One stage in all (the reference's manual kernel fails on one batch):
    every slot count gives kernel 1's result."""
    rng = np.random.default_rng(12)
    n = 200
    a = sp.random(n, n, density=0.002, random_state=12, format="csr", dtype=np.float32)
    A = F.csr_from_scipy(a, device=dev)
    assert K7.staged_plan(A).nunits == 1
    x = torch.from_numpy(rng.random(n, dtype=np.float32)).to(dev)
    ref, _ = K1.spmv_pull(A, x, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
    for slots in (2, 3, 4):
        got, _ = K7.spmv_pull_staged(A, x, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0, slots=slots)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        got, _ = K7.spmv_pull_staged(A, x, op.PLUS_FLOAT, op.MIN_FLOAT, float("inf"), slots=slots)
        _assert_same(got, K1.spmv_pull(A, x, op.PLUS_FLOAT, op.MIN_FLOAT, float("inf"))[0])
    with pytest.raises(ValueError, match=r"\(2, 3, 4\)"):
        K7.spmv_pull_staged(A, x, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0, slots=5)


def test_pull_kernels_do_not_synchronize(dev, monkeypatch):
    """Once a matrix's plans are built, no call of kernel 1 or kernel 7 (value
    and structural, init a Python number or a CUDA tensor, kernel 7 through
    spmv_pull's out under MANUAL_DMA) waits for the stream."""
    A = _pull_matrix("hub_ends", "f32", dev)
    n = A.shape[0]
    x = torch.from_numpy(np.random.default_rng(18).random(n, dtype=np.float32)).to(dev)
    x_valid, row_sel = x > 0.2, x < 0.7
    init_t = torch.zeros((), device=dev)
    out = torch.empty(n, device=dev)
    K1.pull_plan(A), K7.staged_plan(A)
    assert K1.pull_plan(A).nhub == K7.staged_plan(A).nhub == 2
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for init in (0.0, init_t):
            K1.spmv_pull(A, x, op.MULT_FLOAT, op.PLUS_FLOAT, init, x_valid, row_sel, want_has=True)
            K7.spmv_pull_staged(A, x, op.MULT_FLOAT, op.PLUS_FLOAT, init, x_valid, row_sel, want_has=True)
        K1.spmv_pull_structural(A, x_valid, row_sel)
        K7.spmv_pull_staged_structural(A, x_valid, row_sel)
        monkeypatch.setattr(K7, "MANUAL_DMA", True)
        got, _ = K1.spmv_pull(A, x, op.MULT_FLOAT, op.PLUS_FLOAT, init_t, out=out)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert got.data_ptr() == out.data_ptr()
    torch.testing.assert_close(out, K1.spmv_pull_plain(A, x, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)[0],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("phase", kernels.PROBE_PHASES)
def test_spmv_probe_matches_plain(dev, phase):
    """Each kernel-8 phase against its plain version: f32 sums within rtol
    1e-5 (summation order), XOR checksums bitwise."""
    a = _graph(seed=13)
    n = a.shape[0]
    A = F.csr_from_scipy(a, device=dev)
    x = torch.from_numpy(np.random.default_rng(14).random(n, dtype=np.float32)).to(dev)
    for stage, slots in ((1024, 2), (16, 3), (64, 4)):
        got = K8.spmv_probe(phase, A, x, slots=slots, stage=stage)
        ref = K8.spmv_probe_plain(phase, A, x, stage=stage)
        for g, r in zip(got, ref):
            assert (g is None) == (r is None)
            if g is None:
                continue
            if g.dtype == torch.int32:
                _assert_same(g, r)
            else:
                torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)


def test_manual_dma_routes_f32_to_kernel7(dev, manual_dma, monkeypatch):
    """Under MANUAL_DMA, mxv_masked and the pull levels of bfs / sssp / pr
    launch kernel 7 (i32 stays on kernel 1), with the unstaged results."""
    monkeypatch.setattr(alg, "RESIDENT_BYTES", 0)
    a = _graph(n=2000, seed=15, hub=300)
    a = (a + a.T).tocsr()
    a.data = np.random.default_rng(16).uniform(0.1, 2.0, a.nnz).astype(np.float32)
    A = F.csr_from_scipy(a, device=dev)
    n = a.shape[0]
    x = DenseVec(torch.from_numpy(np.random.default_rng(17).random(n, dtype=np.float32)).to(dev),
                 torch.tensor(0.0, device=dev))
    kernels.reset_launches()
    staged = {"mxv": TS.mxv_masked(x, A, x, op.MULT_FLOAT, op.PLUS_FLOAT, op.NQZERO_FLOAT, 0.0).values,
              "mxv i32": TS.mxv_masked(x, F.csr_from_scipy((a * 100).astype(np.int32), device=dev),
                                       DenseVec(x.values.int(), torch.tensor(0, device=dev)),
                                       op.MULT_INT, op.PLUS_INT, op.NQZERO_FLOAT, 0).values}
    for name, fn in (("bfs", alg.bfs), ("sssp", alg.sssp)):
        staged[name] = fn(A, 0, Descriptor(pull_only=True)).values
    staged["pr"] = alg.pr(A, 0.85, 1e-6).values
    assert kernels.LAUNCHES["spmv_pull_staged"] > 0
    assert kernels.LAUNCHES["spmv_pull"] == 1  # the i32 mxv
    monkeypatch.setattr(K7, "MANUAL_DMA", False)
    torch.testing.assert_close(
        staged["mxv"], TS.mxv_masked(x, A, x, op.MULT_FLOAT, op.PLUS_FLOAT, op.NQZERO_FLOAT, 0.0).values,
        rtol=1e-5, atol=1e-5)
    for name, fn in (("bfs", alg.bfs), ("sssp", alg.sssp)):
        _assert_same(staged[name], fn(A, 0, Descriptor(pull_only=True)).values)
    torch.testing.assert_close(staged["pr"], alg.pr(A, 0.85, 1e-6).values, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("graph", ["deg1", "deg16", "deg64", "hub", "hub_ends"])
@pytest.mark.parametrize("stage", [16, 1024])
def test_spmv_pull_staged_generic_matches_plain(dev, graph, stage):
    """Kernel 7's generic family (the mul a kernel argument) against its plain
    version: every f32 (mul, add), each with one of the three mask and
    operand-order settings and one slot count in turn (the swap reaches
    MINUS, DIV and MINUS_POW2), the templated requests sent to the family by
    ``generic=True``; f32 PLUS within the tolerance, MIN and MAX bitwise."""
    A = _typed_pull_matrix(graph, "f32", dev)
    n = A.shape[0]
    rng = np.random.default_rng(35)
    x = _typed_x(n, "f32", dev, rng)
    x_valid = torch.from_numpy(rng.random(n) < 0.8).to(dev)
    row_sel = torch.from_numpy(rng.random(n) < 0.6).to(dev)
    settings = ((None, None, False), (x_valid, row_sel, False), (x_valid, row_sel, True))
    k = 0
    for add in GENERIC_ADDS["f32"]:
        oa = getattr(op.FLOAT, add)
        for mul in GENERIC_MULS["f32"]:
            om = getattr(op.FLOAT, mul)
            xv, rs, swap = settings[k % 3]
            slots = K7.SLOT_COUNTS[(k // 3) % 3]
            k += 1
            kernels.reset_launches()
            got, has = K7.spmv_pull_staged(A, x, om, oa, oa.identity, xv, rs, want_has=True, swap=swap,
                                           slots=slots, stage=stage, generic=True)
            assert kernels.LAUNCHES["spmv_pull_staged_generic"] == 1 and kernels.LAUNCHES["spmv_pull_staged"] == 0
            ref, ref_has = K7.spmv_pull_staged_plain(A, x, om, oa, oa.identity, xv, rs, swap, stage=stage)
            assert torch.equal(has, ref_has), (mul, add)
            _same_values(got, ref, add == "PLUS")


def test_manual_dma_takes_every_f32_request_on_kernel7(dev, manual_dma):
    """Under MANUAL_DMA, mxv_masked and vxm_masked_dense with each of the 36
    f32 (mul, add) requests count as a kernel dispatch and launch kernel 7
    once (its templated instance for the six muls, its generic family for
    MINUS, DIV, MINUS_POW2, BONE, LOR and LAND) and kernel 1 never, with the
    CPU's results (f32 PLUS within rtol 1e-5, MIN and MAX bitwise)."""
    A, Ac = (_typed_pull_matrix("hub", "f32", d) for d in (dev, "cpu"))
    n = A.shape[0]
    rng = np.random.default_rng(34)
    xc = _typed_x(n, "f32", "cpu", rng)
    mc = torch.from_numpy((rng.random(n) < 0.7).astype(np.float32))
    on = {d: (DenseVec(mc.to(d), torch.tensor(0.0, device=d)), DenseVec(xc.to(d), torch.tensor(7.0, device=d)),
              A if d == dev else Ac) for d in (dev, "cpu")}
    calls = {"mxv_kernel": lambda mask, x, M, om, oa: TS.mxv_masked(mask, M, x, om, oa, op.NQZERO_FLOAT, oa.identity),
             "vxm_kernel": lambda mask, x, M, om, oa: TS.vxm_masked_dense(mask, x, M, om, oa, op.NQZERO_FLOAT,
                                                                          oa.identity)}
    for add in GENERIC_ADDS["f32"]:
        oa = getattr(op.FLOAT, add)
        for mul in GENERIC_MULS["f32"]:
            om = getattr(op.FLOAT, mul)
            name = "spmv_pull_staged" if K1.templated(*K1.pull_codes(om, oa, torch.float32)) else \
                "spmv_pull_staged_generic"
            for route, call in calls.items():
                kernels.reset_launches()
                before = dict(TS.DISPATCH_STATS)
                got = call(*on[dev], om, oa).values
                moved = {k: TS.DISPATCH_STATS[k] - before[k] for k in before if TS.DISPATCH_STATS[k] != before[k]}
                launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
                assert moved == {route: 1} and launched == {name: 1}, (mul, add, route, moved, launched)
                _same_values(got, call(*on["cpu"], om, oa).values, add == "PLUS")


# ---------------------------------------------------------------- signed zeros (IEEE 754-2019 MIN / MAX)


def _signed_zeros(n, add, rng, neg=0.5):
    """f32 values, 80% zeros (a share ``neg`` of them -0.0), the rest in
    [0.5, 2) (MIN) or in (-2, -0.5] (MAX), so that a tie of +0.0 and -0.0
    decides most folds."""
    r = rng.random(n)
    far = rng.uniform(0.5, 2.0, n) * (1.0 if add == "MIN" else -1.0)
    zero = np.where(rng.random(n) < neg, np.float32(-0.0), np.float32(0.0))
    return np.where(r < 0.8, zero, far).astype(np.float32)


def _flip_zeros(t):
    """``t`` with its zeros' signs swapped: the other order of every tie."""
    return torch.where(t == 0, -t, t)


def _both_signs(t):
    """Whether ``t`` holds +0.0 and -0.0."""
    z = t[t == 0]
    return bool(torch.signbit(z).any()) and bool((~torch.signbit(z)).any())


@pytest.mark.parametrize("add", ["MIN", "MAX"])
@pytest.mark.parametrize("graph", ["deg1", "deg6", "deg64", "hub", "hub_ends"])
def test_pull_kernels_fold_signed_zeros_by_the_rule(dev, graph, add):
    """Kernels 1 and 7, templated and generic, at 2, 3 and 4 slots, on x of
    +-0.0 (A's values positive) and on x with its zeros' signs swapped (the
    other order of every tie): bit for bit their plain version, which puts
    -0.0 below +0.0; MULT, the add as the mul in both operand orders, and
    DIV under vxm's swap.  The -0.0 share of x's zeros is set by the mean
    row length so that about half the rows fold no -0.0 (MIN) or, swapped,
    no +0.0 (MAX): the MULT results of the two orders hold zeros of both signs."""
    A = _pull_matrix(graph, "f32", dev)
    A = replace(A, values=A.values + 0.5)
    n = A.shape[0]
    rng = np.random.default_rng(31)
    oa = getattr(op.FLOAT, add)
    zeros_a_row = 0.8 * 0.9 * int(A.nnz) / n
    x0 = torch.from_numpy(_signed_zeros(n, add, rng, 1 - 0.5 ** (1 / max(zeros_a_row, 1.0)))).to(dev)
    x_valid = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    products = []
    for x in (x0, _flip_zeros(x0)):
        for om, swap in ((op.MULT_FLOAT, False), (oa, False), (oa, True), (op.DIV_FLOAT, True)):
            ref, _ = K1.spmv_pull_plain(A, x, om, oa, oa.identity, x_valid, None, swap)
            if om is op.MULT_FLOAT:
                products.append(ref)
            for generic in (False, True):
                _assert_same(K1.spmv_pull(A, x, om, oa, oa.identity, x_valid, swap=swap, generic=generic)[0], ref)
                for slots in K7.SLOT_COUNTS:
                    _assert_same(K7.spmv_pull_staged(A, x, om, oa, oa.identity, x_valid, swap=swap, slots=slots,
                                                     generic=generic)[0], ref)
    assert _both_signs(torch.cat(products))


@pytest.mark.parametrize("add", ["MIN", "MAX"])
@pytest.mark.parametrize("graph", ["hub", "deg48"])
def test_mxmt_masked_folds_signed_zeros_by_the_rule(dev, graph, add):
    """Kernel 5 with B's values +-0.0 (A's positive), and with their zeros'
    signs swapped: bit for bit its plain version; MULT and the add as the mul."""
    mask, A = _mxmt_operands(dev, "f32", graph)
    B = replace(A, values=torch.from_numpy(_signed_zeros(A.capacity, add, np.random.default_rng(32))).to(dev))
    oa = getattr(op.FLOAT, add)
    for Bz in (B, replace(B, values=_flip_zeros(B.values))):
        for om in (op.MULT_FLOAT, oa):
            got, has = K45.mxmt_masked(mask, A, Bz, om, oa, oa.identity)
            ref, ref_has = K45.mxmt_masked_plain(mask, A, Bz, om, oa, oa.identity)
            assert torch.equal(has, ref_has)
            _assert_same(got, ref)
            assert om is not op.MULT_FLOAT or _both_signs(ref[ref_has])


@pytest.mark.parametrize("add", ["MIN", "MAX"])
def test_mxm_folds_signed_zeros_by_the_rule(dev, add):
    """Kernel 9 with B's values +-0.0 (A's positive), rows in all three bins
    (the large bin's CAS folds, the medium bin's sorted folds), and with
    the zeros' signs swapped: bit for bit its plain version."""
    A, B = _bins_operands(dev, "f32")
    B = replace(B, values=torch.from_numpy(_signed_zeros(B.capacity, add, np.random.default_rng(33))).to(dev))
    oa = getattr(op.FLOAT, add)
    for Bz in (B, replace(B, values=_flip_zeros(B.values))):
        for om in (op.MULT_FLOAT, oa):
            ref = K9.mxm_plain(A, Bz, om, oa, oa.identity)
            _same_csr(K9.mxm(A, Bz, om, oa, oa.identity), ref)
            assert om is not op.MULT_FLOAT or _both_signs(ref.values[:int(ref.nnz)])


def test_atomics_and_level_updates_order_signed_zeros(dev):
    """Kernels 2 and 6 fold with integer atomics on the floats' bits
    (csrc/frontier.cuh atomic_fold, csrc/resident.cu atomic_min_float),
    which put -0.0 below +0.0.  Kernel 2: products of +-0.0 from half the
    vertices scattered into their columns, the frontier in two orders and
    the zeros' signs swapped, MIN and MAX: bit for bit the plain version.
    Kernel 3's SSSP update (op_min) on ties of +-0.0 in both orders.
    Kernel 6: SSSP over weights of +-0.0, both ways: the plain version's
    bits; no distance is -0.0 there (+0.0 + -0.0 is +0.0)."""
    a = _graph(seed=2)
    n = a.shape[0]
    rng = np.random.default_rng(36)
    A = F.csr_from_scipy(a, device=dev)
    front = torch.from_numpy(rng.choice(n, n // 2, replace=False).astype(np.int32)).to(dev)
    for add in ("MIN", "MAX"):
        oa = getattr(op.FLOAT, add)
        x = torch.from_numpy(_signed_zeros(n, add, rng)).to(dev)
        for xx, ff in ((x, front), (_flip_zeros(x), front.flip(0))):
            ref = K2.spmv_push_plain(A, ff, xx, op.MULT_FLOAT, oa, oa.identity)
            _assert_same(K2.spmv_push(A, ff, xx, op.MULT_FLOAT, oa, oa.identity), ref)
            assert _both_signs(ref)
    hits = torch.from_numpy(_signed_zeros(n, "MIN", rng)).to(dev)
    v0 = torch.from_numpy(_signed_zeros(n, "MIN", rng)).to(dev)
    for h, v_start in ((hits, v0), (v0, hits)):
        res = []
        for fn in (K3.sssp_level_update, K3.sssp_level_update_plain):
            v, ch = v_start.clone(), torch.zeros(n, dtype=torch.bool, device=dev)
            lst = torch.empty(n, dtype=torch.int32, device=dev)
            cnt = torch.zeros(1, dtype=torch.int32, device=dev)
            fn(h, v, ch, lst, cnt)
            res.append((v, ch, torch.sort(lst[: int(cnt)]).values))
        for got, ref in zip(*res):
            _assert_same(got, ref)
        assert _both_signs(res[1][0])
    road = _road(48)
    w = _signed_zeros(road.nnz, "MIN", rng)
    for data in (w, np.where(w == 0, -w, w).astype(np.float32)):
        R = F.csr_from_scipy(sp.csr_matrix((data, road.indices, road.indptr), shape=road.shape),
                             fill=np.float32(np.inf), device=dev)
        d, _ = K6.sssp_resident(R, 0)
        _assert_same(d, K6.sssp_resident_plain(R, 0)[0])
        assert not bool(torch.signbit(d[d == 0]).any())


# ---------------------------------------------------------------- the op layer (plain PyTorch, no kernel)


def _op_inputs(device):
    """The op-layer tests' inputs, from one seed, on ``device``: f32 and i32
    matrices sorted by column (300 x 300, row 7 and column 11 of 150
    entries), small kron operands, sparse and dense vectors of n = 300 and
    banded BSR matrices."""
    rng = np.random.default_rng(70)
    n = 300

    def matrix(seed, dtype, fill=0):
        r = np.random.default_rng(seed)
        rows = np.concatenate([r.integers(0, n, 2400), np.full(150, 7), r.integers(0, n, 150)])
        cols = np.concatenate([r.integers(0, n, 2400), r.integers(0, n, 150), np.full(150, 11)])
        vals = r.uniform(-2, 2, rows.size) if dtype == np.float32 else r.integers(-9, 9, rows.size)
        return F.csr_from_entries((n, n), rows, cols, vals, fill=fill, dtype=dtype,
                                  capacity=rows.size + 5, device=device)

    def band(dtype):
        offs = np.arange(-9, 10)
        rows = np.repeat(np.arange(256), offs.size)
        cols = rows + np.tile(offs, 256)
        keep = (cols >= 0) & (cols < 256)
        vals = rng.uniform(0.5, 1.5, keep.sum()) if dtype == np.float32 else rng.integers(-50, 50, keep.sum())
        A = F.csr_from_entries((256, 256), rows[keep], cols[keep], vals, dtype=dtype, device=device)
        return F.bsr_from_csr_host(A, block=32)

    def vec(idx_seed, nnz):
        r = np.random.default_rng(idx_seed)
        return F.sparse_vec_from_entries(n, r.choice(n, nnz, replace=False), r.uniform(-1, 1, nnz),
                                         dtype=np.float32, capacity=nnz + 3, device=device)

    dvals = rng.uniform(-1, 1, n).astype(np.float32)
    dvals[rng.random(n) < 0.3] = 0
    dev_of = (lambda a: torch.from_numpy(a).to(device))
    return {
        "A": matrix(71, np.float32), "A2": matrix(72, np.float32),
        "Ainf": matrix(71, np.float32, np.float32(np.inf)), "A2inf": matrix(72, np.float32, np.float32(np.inf)),
        "Ai": matrix(73, np.int32), "A2i": matrix(74, np.int32),
        "K": F.csr_from_entries((12, 10), rng.integers(0, 12, 30), rng.integers(0, 10, 30), rng.uniform(0.5, 1.5, 30),
                                dtype=np.float32, device=device),
        "B": F.csr_from_entries((9, 11), rng.integers(0, 9, 20), rng.integers(0, 11, 20), rng.uniform(0.5, 1.5, 20),
                                dtype=np.float32, device=device),
        "Ki": F.csr_from_entries((12, 10), rng.integers(0, 12, 30), rng.integers(0, 10, 30), rng.integers(-9, 9, 30),
                                 dtype=np.int32, device=device),
        "u": vec(75, 60), "v": vec(76, 60),
        "d": DenseVec(dev_of(dvals), torch.tensor(0.0, device=device)),
        "d2": DenseVec(dev_of(rng.uniform(-1, 1, n).astype(np.float32)), torch.tensor(0.0, device=device)),
        "band": band(np.float32), "band_i": band(np.int32),
        "x": dev_of(rng.uniform(-1, 1, 256).astype(np.float32)),
        "xi": dev_of(rng.integers(-9, 9, 256).astype(np.int32)),
        "X": dev_of(rng.uniform(-1, 1, (256, 24)).astype(np.float32)),
        "Xi": dev_of(rng.integers(-9, 9, (256, 24)).astype(np.int32)),
        "index": torch.tensor(7, device=device),
    }


# name: (the call on the inputs, f32 PLUS fold: compared within rtol 1e-5, else bitwise)
OP_CALLS = {
    "m_transpose": (lambda I: TO.m_transpose(I["A"], op.AINV_FLOAT), False),
    "m_eadd PLUS f32": (lambda I: TO.m_eadd(I["A"], I["A2"], op.PLUS_FLOAT), False),
    "m_eadd PLUS i32 cut": (lambda I: TO.m_eadd(I["Ai"], I["A2i"], op.PLUS_INT, out_capacity=1000), False),
    "m_emult MIN +inf": (lambda I: TO.m_emult(I["Ainf"], I["A2inf"], op.MIN_FLOAT), False),
    "m_reduce_by_row PLUS f32": (lambda I: TO.m_reduce_by_row(I["A"], op.PLUS_FLOAT, 0.0), True),
    "m_reduce_by_row BOR i32": (lambda I: TO.m_reduce_by_row(I["Ai"], op.BOR_INT, 0), False),
    "m_reduce_by_column MIN +inf": (lambda I: TO.m_reduce_by_column(I["Ainf"], op.MIN_FLOAT, np.inf), False),
    "m_reduce_by_column LOR i32": (lambda I: TO.m_reduce_by_column(I["Ai"], op.LOR_INT, 0), False),
    "m_extract_row": (lambda I: (TO.m_extract_row(I["A"], 7, op.IDENTITY_FLOAT),
                                 TO.m_extract_row(I["A"], I["index"], op.IDENTITY_FLOAT, 40)), False),
    "m_extract_column": (lambda I: (TO.m_extract_column(I["Ai"], 11, op.AINV_INT),
                                    TO.m_extract_column(I["Ai"], I["index"], op.AINV_INT, 20)), False),
    "kron MULT f32": (lambda I: TO.kron(I["K"], I["B"], op.MULT_FLOAT), False),
    "kron MULT i32 cut": (lambda I: TO.kron(I["Ki"], I["Ki"], op.MULT_INT, 300), False),
    "v_eadd": (lambda I: (TO.v_eadd(I["u"], I["v"], op.PLUS_FLOAT), TO.v_eadd(I["u"], I["d"], op.MIN_FLOAT),
                          TO.v_eadd(I["d"], I["d2"], op.MAX_FLOAT)), False),
    "v_emult": (lambda I: (TO.v_emult(I["u"], I["v"], op.MULT_FLOAT), TO.v_emult(I["d"], I["v"], op.MINUS_FLOAT)),
                False),
    "v_map": (lambda I: (TO.v_map(I["u"], op.ABS_FLOAT), TO.v_map(I["d"], op.AINV_FLOAT)), False),
    "v_reduce PLUS f32": (lambda I: (TO.v_reduce(0.0, I["u"], op.PLUS_FLOAT),
                                     TO.v_reduce(1.0, I["d"], op.PLUS_FLOAT, stored_only=True)), True),
    "v_reduce MIN": (lambda I: TO.v_reduce(np.inf, I["d"], op.MIN_FLOAT), False),
    "v_count_mf": (lambda I: (TO.v_count_mf(I["u"]), TO.v_count_mf(I["d"])), False),
    "v_assign_masked": (lambda I: (TO.v_assign_masked(I["d"], I["u"], 0.25, op.SECOND_FLOAT, op.GTZERO_FLOAT),
                                   TO.v_assign_masked(I["d"], I["d2"], 2.0, op.PLUS_FLOAT, op.LTZERO_FLOAT)),
                        False),
    "v_eadd_fdb": (lambda I: (TO.v_eadd_fdb(I["d"], I["v"], op.MIN_FLOAT),
                              TO.v_eadd_fdb(I["d"], I["d2"], op.MIN_FLOAT)), False),
    "bsr_spmv f32": (lambda I: (TO.bsr_spmv(I["band"], I["x"]), TO.bsr_spmv(I["band"], I["x"], init=1.5)), True),
    "bsr_spmv i32": (lambda I: TO.bsr_spmv(I["band_i"], I["xi"], init=3), False),
    "bsr_spmm f32": (lambda I: TO.bsr_spmm(I["band"], I["X"]), True),
    "bsr_spmm i32": (lambda I: TO.bsr_spmm(I["band_i"], I["Xi"]), False),
}


def _same_result(got, ref, float_plus):
    """A CUDA result against the CPU one: every tensor field (uint32 through
    int64), bitwise or within the f32 PLUS tolerance."""
    if isinstance(ref, tuple):
        for g, r in zip(got, ref):
            _same_result(g, r, float_plus)
        return
    if not isinstance(ref, torch.Tensor):
        assert type(got) is type(ref)
        for name, value in vars(ref).items():
            if isinstance(value, torch.Tensor):
                _same_result(getattr(got, name), value, float_plus and name in ("value", "values"))
            else:
                assert getattr(got, name) == value
        return
    assert got.device.type == "cuda" and got.dtype == ref.dtype and got.shape == ref.shape
    got, ref = got.cpu(), ref.cpu()
    if ref.dtype == torch.uint32:
        got, ref = got.to(torch.int64), ref.to(torch.int64)
    if float_plus:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    else:
        _assert_same(got, ref)


@pytest.mark.parametrize("name", list(OP_CALLS))
def test_op_layer_matches_cpu_without_synchronizing(dev, name):
    """Each op of the op layer on CUDA tensors against the same op on CPU
    tensors, the CUDA call under set_sync_debug_mode("error") (no host read,
    no copy from the host)."""
    call, float_plus = OP_CALLS[name]
    cpu, card = _op_inputs("cpu"), _op_inputs(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = call(card)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _same_result(got, call(cpu), float_plus)


def test_lex_order_past_63_bits_on_the_card(dev):
    """The multi-key sort with key ranges whose product passes 2**63 (one
    stable sort a key) and one that fits (a fused key), on the card and
    without a host read, against numpy's lexsort."""
    rng = np.random.default_rng(77)
    keys = [rng.integers(0, 1 << 40, 5000) // (1 << 37) * (1 << 37), rng.integers(0, 1 << 33, 5000) // 4,
            rng.integers(0, 3, 5000)]
    card = [torch.from_numpy(k).to(dev) for k in keys]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        wide = lex_order(card, (1 << 40, 1 << 33, 3))
        fused = lex_order(card[1:], (1 << 33, 3))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    np.testing.assert_array_equal(wide.cpu().numpy(), np.lexsort(keys[::-1]))
    np.testing.assert_array_equal(fused.cpu().numpy(), np.lexsort(keys[:0:-1]))


def test_bsr_products_refuse_tf32(dev, monkeypatch):
    I = _op_inputs(dev)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        TO.bsr_spmm(I["band"], I["X"])


# ---------------------------------------------------------------- the facade


@pytest.fixture
def facade_lib():
    """The library with acceleration on and device 0, restored after the test."""
    lib = get_library()
    saved = dict(vars(lib))
    lib.set_force_no_acceleration(False)
    lib.set_device(0)
    yield lib
    vars(lib).update(saved)
    profiler.enabled = False
    profiler.reset()


def _facade_graph(n=3000, seed=4, device=None):
    """A facade f32 Matrix of random_graph(n, 12) with values in [0.5, 1.5),
    built through the bulk path."""
    a = random_graph(n, 12, seed=seed).tocoo()
    vals = np.random.default_rng(seed).uniform(0.5, 1.5, a.nnz).astype(np.float32)
    M = FC.Matrix((n, n), FLOAT, device=device)
    M.build(FC.MemView(a.row), FC.MemView(a.col), FC.MemView(vals))
    return M


def test_facade_default_device_is_cuda(dev, facade_lib):
    assert FC.Matrix((4, 4), FLOAT).device == torch.device("cuda", 0)
    assert FC.Vector.dense(4, FLOAT, 1.0).device == torch.device("cuda", 0)
    v = FC.Vector.from_lists([1], [2.0], 4, FLOAT)
    assert v._device().values.device.type == "cuda"
    facade_lib.set_force_no_acceleration(True)
    assert FC.Vector(4, FLOAT).device == torch.device("cpu")


def test_facade_ops_launch_kernels_1_9_and_5(dev, facade_lib):
    """Vector.vxm and Matrix.mxv launch kernel 1, Matrix.mxm kernel 9 and
    Matrix.mxmT kernel 5; each result equals the same call on the CPU."""
    M, Mc = _facade_graph(), _facade_graph(device="cpu")
    n = M.n_rows
    rng = np.random.default_rng(5)
    idx = np.sort(rng.choice(n, 300, replace=False))
    vals = rng.uniform(0.5, 1.5, idx.size).astype(np.float32)
    v, vc = (FC.Vector.from_lists(idx, vals, n, FLOAT, device=d) for d in (None, "cpu"))
    mask, maskc = (FC.Vector(n, FLOAT, device=d) for d in (None, "cpu"))
    F_ = (op.MULT_FLOAT, op.PLUS_FLOAT)
    runs = {
        "vxm": (lambda: v.vxm(mask, M, *F_, op.ALWAYS_FLOAT), lambda: vc.vxm(maskc, Mc, *F_, op.ALWAYS_FLOAT),
                "spmv_pull", "vxm_kernel"),
        "mxv": (lambda: M.mxv(mask, v, *F_, op.ALWAYS_FLOAT), lambda: Mc.mxv(maskc, vc, *F_, op.ALWAYS_FLOAT),
                "spmv_pull", "mxv_kernel"),
        "mxm": (lambda: M.mxm(M, *F_), lambda: Mc.mxm(Mc, *F_), "spgemm_mxm", "mxm_kernel"),
        "mxmT": (lambda: M.mxmT(M, M, *F_, op.ALWAYS_FLOAT), lambda: Mc.mxmT(Mc, Mc, *F_, op.ALWAYS_FLOAT),
                 "mxmt_masked", "mxmT_kernel"),
    }
    for name, (gpu, cpu, kernel, stat) in runs.items():
        kernels.reset_launches()
        for k in TS.DISPATCH_STATS:
            TS.DISPATCH_STATS[k] = 0
        got = gpu()
        assert kernels.LAUNCHES[kernel] == 1 and TS.DISPATCH_STATS[stat] == 1, name
        assert got.device == torch.device("cuda", 0)
        want = cpu()
        if isinstance(got, FC.Vector):
            torch.testing.assert_close(torch.from_numpy(got.to_numpy()), torch.from_numpy(want.to_numpy()),
                                       rtol=1e-5, atol=1e-6)
        else:
            (gr, gc, gv), (wr, wc, wv) = got.read(), want.read()
            np.testing.assert_array_equal(gr, wr)
            np.testing.assert_array_equal(gc, wc)
            np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-6)
    # an integer semiring and a user op's gate on the card
    Mi = FC.Matrix.from_lists([0, 1, 2], [1, 2, 0], [1, 2, 3], (3, 3), INT)
    vi = FC.Vector.from_lists([0, 1, 2], [1, 10, 100], 3, INT)
    ones = FC.Vector.dense(3, INT, 1)
    kernels.reset_launches()
    assert Mi.mxv(ones, vi, INT.MULT, INT.PLUS, INT.NQZERO).to_numpy().tolist() == [10, 200, 3]
    assert kernels.LAUNCHES["spmv_pull"] == 1
    user_add = op.OpBinary.make("user_plus", INT, lambda a, b: a + b, identity=np.int32(0), scatter="add",
                                associative=True, commutative=True)
    kernels.reset_launches()
    assert vi.vxm(ones, Mi, INT.MULT, user_add, INT.NQZERO).to_numpy().tolist() == [300, 1, 20]
    assert kernels.LAUNCHES["spmv_pull"] == 0  # the static gate: no kernel code, the plain path


def test_facade_instrument_synchronizes_when_profiling(dev, facade_lib, monkeypatch):
    M = _facade_graph()
    v = FC.Vector.dense(M.n_rows, FLOAT, 1.0)
    mask = FC.Vector(M.n_rows, FLOAT)
    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: (calls.append(device), real(device)))
    v.vxm(mask, M, op.MULT_FLOAT, op.PLUS_FLOAT, op.ALWAYS_FLOAT)
    assert calls == []  # profiling off: no wait
    profiler.reset()
    facade_lib.set_time_profiling(True)
    r = v.vxm(mask, M, op.MULT_FLOAT, op.PLUS_FLOAT, op.ALWAYS_FLOAT)
    assert calls == [torch.device("cuda", 0)]
    assert torch.cuda.current_stream().query()  # the result's work is done
    s = profiler.stats()["vector_vxm"]
    assert s["count"] == 1 and s["ms"] > 0
    r.reduce(op.PLUS_FLOAT)
    assert calls == [torch.device("cuda", 0)]  # a Scalar result is on the host already


def test_facade_device_transpose_equals_host_transpose(dev, facade_lib):
    A = _facade_graph(n=2000)
    B = A.mxm(A, op.MULT_FLOAT, op.PLUS_FLOAT)
    for M in (A, B):
        got, host = M._device_t(), F.csr_transpose_host(M._device())
        nnz = int(host.nnz)
        assert got.shape == host.shape and int(got.nnz) == nnz
        _assert_same(got.indptr, host.indptr)
        for field in ("cols", "values", "row_ids"):
            _assert_same(getattr(got, field)[:nnz], getattr(host, field)[:nnz])


# ---------------------------------------------------------------- the sharded layer (parallel)

DIST_SPEC = {"n": 4096, "deg": 8, "road": 32, "mxm_n": 512}  # tools.dist_times.SMALL, cut


@pytest.fixture(scope="module")
def dist_meshes():
    """A world of one rank in this process: its NCCL mesh on cuda:0, and a
    gloo group of the same rank whose mesh holds CPU tensors (the plain
    versions) or CUDA tensors (staged through host memory)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist
    from spla_tpu_torch import parallel as P

    nccl = P.make_device_mesh(device="cuda:0")
    gloo = dist.new_group(backend="gloo")
    yield {"nccl": nccl, "cpu": P.Mesh(gloo, 0, 1, torch.device("cpu"), "gloo"),
           "staged": P.Mesh(gloo, 0, 1, torch.device("cuda:0"), "gloo")}
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def dist_runs(dist_meshes):
    """Every dist function once on each mesh, with what it launched."""
    from spla_tpu_torch.parallel import comm
    from spla_tpu_torch.tools import dist_times as DT

    out = {}
    for name, mesh in dist_meshes.items():
        sh = DT.shard_all(mesh, DT.graphs(DIST_SPEC, mesh.device))
        comm.reset_comm_stats()
        out[name] = DT.run_all(mesh, sh)
        out[name + " staged bytes"] = comm.COMM_STATS["staged_bytes"]
    return out


DIST_SPMV = ("spmv", "pr", "pr_overlap", "pr_pallas", "pr_pallas_overlap", "bfs", "bfs_pallas",
             "bfs_pallas_overlap", "sssp", "sssp_pallas", "sssp_pallas_overlap", "road_bfs")


def _same_dist(name, got, want):
    g, w = got["result"], want["result"]
    if name == "mxm":
        for f in ("row_ids", "cols"):
            np.testing.assert_array_equal(g[f], w[f])
        np.testing.assert_allclose(g["values"], w["values"], rtol=1e-5)
    elif name in ("spmv",) or name.startswith("pr"):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)  # f32 PLUS: the fold order differs
    else:
        np.testing.assert_array_equal(g, w)  # depths, min-plus distances, counts
    assert got["stats"] == want["stats"] and got["host_reads"] == want["host_reads"]


@pytest.mark.parametrize("name", [*DIST_SPMV, "tc", "mxm"])
def test_dist_on_the_card_matches_the_plain_versions(dist_runs, name):
    """World of one on NCCL (kernels 1 and 4) against the same loop on CPU
    tensors (their plain versions), and the gloo mesh's staged run."""
    card, plain, staged = (dist_runs[k][name] for k in ("nccl", "cpu", "staged"))
    _same_dist(name, card, plain)
    _same_dist(name, staged, card)
    for run in (card, staged):
        assert not any(k.endswith("_torch") for k in run["dispatch"])
        if name in DIST_SPMV:
            assert run["launches"]["spmv_pull"] > 0
        if name == "tc":
            assert run["launches"]["mxmt_reduce"] > 0
    assert dist_runs["staged staged bytes"] > 0 and dist_runs["nccl staged bytes"] == 0


def test_kernel1_on_an_empty_off_diagonal_block(dist_meshes):
    """At world 1 every column is on the diagonal: the off-diagonal block
    stores nothing, and kernel 1 gives init and no hit on every row."""
    from spla_tpu_torch import parallel as P

    mesh = dist_meshes["nccl"]
    a = F.csr_from_scipy(random_graph(1000, 8).astype(np.float32), device=mesh.device)
    diag, off = P.shard_cell_spmv_split(a, 1, mesh)
    assert int(off.block.nnz) == 0 and int(diag.block.nnz) == int(a.nnz)
    x = torch.rand(1000, device=mesh.device)
    kernels.reset_launches()
    out, _ = K1.spmv_pull(off.block, x, op.MULT_FLOAT, op.PLUS_FLOAT, 3.0)
    hits = K1.spmv_pull_structural(off.block, x > 0.5)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["spmv_pull"] == 2
    _assert_same(out, torch.full((1000,), 3.0, device=mesh.device))
    assert not hits.any()


def test_pin_dist_tc_sums_in_int64_on_the_card(dist_meshes):
    """Kernel 4 sums in int64 on the card; on CPU tensors the sum is taken
    in int32 and wraps, as the JAX package's does
    (``tests/test_torch_dist.py::test_pin_dist_tc_int32_sum_wraps_on_the_cpu``)."""
    from spla_tpu_torch import parallel as P
    from spla_tpu_torch.ops.spmv import DISPATCH_STATS

    a = random_graph(60, 8, seed=6).astype(np.int32)
    a.data[:] = 30_000
    b = a.astype(np.int64)
    exact = int((b @ b.T).multiply(b > 0).sum())  # the products of the selected mask entries
    got = {}
    for name in ("nccl", "cpu"):
        mesh = dist_meshes[name]
        sc = P.shard_csr_by_rows(F.csr_from_scipy(a, device=mesh.device), 1, mesh)
        for k in DISPATCH_STATS:
            DISPATCH_STATS[k] = 0
        got[name] = P.dist_tc(mesh, sc)
        assert DISPATCH_STATS["mxmT_kernel" if name == "nccl" else "mxmT_torch"] == 1
    assert exact > 1 << 31
    assert got["nccl"] == exact
    assert got["cpu"] == (exact + (1 << 31)) % (1 << 32) - (1 << 31)


def test_dist_on_four_gloo_ranks_of_one_card(dist_runs):
    """Four ranks on cuda:0 in a gloo world (collectives staged through host
    memory), each launching kernels 1 and 4 on its shard, equal to the
    world of one."""
    from spla_tpu_torch import parallel as P
    from spla_tpu_torch.kernels.build import load_library
    from spla_tpu_torch.tools import dist_times as DT

    load_library()
    res = P.spawn_world(DT.rank_job, 4, "gloo", ["cuda:0"] * 4, args=(DIST_SPEC,), timeout_s=300.0)
    one = dist_runs["nccl"]
    for name, want in one.items():
        parts = [r["calls"][name] for r in res]
        for p in parts:
            assert not any(k.endswith("_torch") for k in p["dispatch"])
            assert p["launches"].get("spmv_pull", 0) > 0 or name not in DIST_SPMV
            assert p["launches"].get("mxmt_reduce", 0) > 0 or name != "tc"
        w = want["result"]
        if name == "mxm":
            got = np.concatenate([p["result"]["cols"] for p in parts])
            np.testing.assert_array_equal(got, w["cols"])
        elif isinstance(w, np.ndarray):
            g = np.concatenate([p["result"] for p in parts])[:w.shape[0]]
            if g.dtype.kind == "f" and (name == "spmv" or name.startswith("pr")):
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
            else:
                np.testing.assert_array_equal(g, w)
        else:
            assert all(p["result"] == w for p in parts)


# ---------------------------------------------------------------- the reference's surface on the card

# spla_tpu's answers (XLA saturates its float-to-int cast of 1 / a)
MINV_EDGES = {"INT": (np.array([0, 1, -1, 2, -2, -2**31, 2**31 - 1], np.int32),
                      np.array([2**31 - 1, 1, -1, 0, 0, 0, 0], np.int32)),
              "UINT": (np.array([0, 1, 2, 2**32 - 1], np.uint32),
                       np.array([2**32 - 1, 1, 0, 0], np.uint32))}


@pytest.mark.parametrize("tname", ["INT", "UINT"])
def test_int_minv_is_the_same_on_both_devices(dev, tname):
    a, want = MINV_EDGES[tname]
    o = op.lookup("MINV", getattr(op, tname))
    got = [o(torch.from_numpy(a).to(d)).cpu() for d in (dev, "cpu")]
    for g in got:
        np.testing.assert_array_equal(g.view(torch.int32).numpy().view(a.dtype), want)


def test_signed_zero_min_max_is_the_same_on_both_devices(dev):
    """MIN and MAX f32 put -0.0 below +0.0 in either order, as spla_tpu's do."""
    a = torch.tensor([0.0, -0.0, 0.0, -0.0, float("nan"), 1.0])
    b = torch.tensor([-0.0, 0.0, 0.0, -0.0, 1.0, float("nan")])
    for o, want in ((op.MIN_FLOAT, [-0.0, -0.0, 0.0, -0.0]), (op.MAX_FLOAT, [0.0, 0.0, 0.0, -0.0])):
        for d in (dev, "cpu"):
            got = o(a.to(d), b.to(d)).cpu()
            assert torch.isnan(got[4:]).all()
            assert got[:4].view(torch.int32).tolist() == torch.tensor(want).view(torch.int32).tolist()


def test_surface_builders_on_the_card(dev):
    from spla_tpu_torch.containers import Scalar, SparseVec

    on = torch.device(dev).type
    s = Scalar.of(2.5, device=dev)
    assert s.value.device.type == on and s.type is FLOAT and s.item() == np.float32(2.5)
    v = SparseVec.empty(10, 4, np.inf, np.float32, device=dev)
    assert v.indices.device.type == on and int(v.nnz) == 0 and v.indices.tolist() == [10] * 4
    assert torch.isinf(v.values).all() and not v.valid_mask().any()
    for o in (op.MIN_FLOAT, op.BAND_UINT, op.PLUS_INT):
        t = o.identity_array(device=dev)
        assert t.device.type == on and t.dim() == 0 and t.dtype == o.type.dtype
        assert t.cpu().view(torch.int32) == o.identity_array(device="cpu").view(torch.int32)


@pytest.mark.parametrize("field", ["push_pull", "early_exit", "struct_only"])
def test_advisory_descriptor_fields_change_nothing_on_the_card(dev, field):
    a = random_graph(1 << 12, 8, seed=3)
    aw = a.copy()
    aw.data = np.random.default_rng(4).uniform(0.1, 2.0, a.nnz).astype(np.float32)
    A = F.csr_from_scipy(a.astype(np.int32), device=dev)
    Aw = F.csr_from_scipy(aw, fill=np.float32(np.inf), device=dev)
    d = Descriptor(**{field: True})
    _assert_same(alg.bfs(A, 0, d, At=A).values, alg.bfs(A, 0, At=A).values)
    _assert_same(alg.sssp(Aw, 0, d).values, alg.sssp(Aw, 0).values)


def test_kernel_1_keeps_f32_subnormals(dev):
    """Stored values of 1e-38 (subnormal) times x = 1.5, one entry a row:
    kernel 1 gives torch's IEEE products, bitwise, none flushed to 0."""
    n = 1 << 12
    perm = np.random.default_rng(8).permutation(n).astype(np.int32)
    indptr, rows = np.arange(n + 1, dtype=np.int32), np.arange(n, dtype=np.int32)
    M = csr_from_numpy((n, n), indptr, perm, np.full(n, 1e-38, np.float32), rows, n, 0, dev)
    x = torch.full((n,), 1.5, device=dev)
    got, _ = K1.spmv_pull(M, x, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
    ref, _ = K1.spmv_pull_plain(M, x, op.MULT_FLOAT, op.PLUS_FLOAT, 0.0)
    _assert_same(got, ref)
    assert (got.cpu() == np.float32(1e-38) * np.float32(1.5)).all()
