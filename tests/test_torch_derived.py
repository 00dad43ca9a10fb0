"""The store of derived facts (``formats.derived``) and the hub-chunk cut that
kernels 1, 4 and 5 share (``kernels.spmv.hub_chunks``), on the CPU.

Every fact the port derives from a matrix is keyed on the tensors it reads:
a matrix that keeps another's ``values`` but takes a new structure gets its
own transpose, skew stats and verdicts; an entry dies with any of its
tensors; the same tensors hit the same object.  Kernels 4 and 5's plan
(``kernels.mxmt.mxmt_plan``) is held to a numpy definition of its hub
chunks, as ``tests/test_torch_pull_plan.py`` holds kernel 1's.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from spla_tpu_torch import algorithms as alg, formats as F
from spla_tpu_torch.interop import csr_from_numpy
from spla_tpu_torch.kernels import mxmt as K45, resident as K6, spgemm as K9, spmv as K1
from spla_tpu_torch.kernels import staged as K7, traversal as K2


def _unbuilt():
    raise AssertionError("the fact was not in the store")


def _csr(n, rows, cols, values, capacity=None):
    """A CPU CsrMatrix of the (row, col) entries sorted row-major, with
    ``values`` (their dtype) and padding up to ``capacity``."""
    rows, cols, values = (np.asarray(a) for a in (rows, cols, values))
    order = np.lexsort((cols, rows))
    rows, cols, values = rows[order], cols[order], values[order]
    nnz = rows.size
    pad = (nnz if capacity is None else capacity) - nnz
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return csr_from_numpy((n, n), indptr, np.concatenate([cols, np.zeros(pad, np.int32)]),
                          np.concatenate([values, np.zeros(pad, values.dtype)]),
                          np.concatenate([rows, np.full(pad, n, np.int32)]), nnz, values.dtype.type(0), "cpu")


def _pair():
    """``(A, R)``: A a directed graph on 9 vertices whose last two stored
    values are 2 and +inf, the others 1; R A with its ``values`` kept and the
    structure (indptr, cols, row_ids, nnz) of a symmetric graph of two fewer
    entries, so every value R stores is 1."""
    rng = np.random.default_rng(3)
    n, k = 9, 14
    edges = rng.choice(n * n, k + 2, replace=False)
    A = _csr(n, edges // n, edges % n, np.ones(k + 2, np.float32))
    A.values[k:] = torch.tensor([2.0, np.inf])
    half = [(i, (i + 1 + i % 3) % n) for i in range(k // 2)]
    rows, cols = zip(*half, *((j, i) for i, j in half))
    G = _csr(n, rows, cols, np.ones(k, np.float32), capacity=k + 2)
    R = dataclasses.replace(A, indptr=G.indptr, cols=G.cols, row_ids=G.row_ids, nnz=G.nnz)
    return A, R


def _fresh(M):
    """M with every tensor copied: nothing it derives can come from the store."""
    return dataclasses.replace(M, **{f: getattr(M, f).clone()
                                     for f in ("indptr", "cols", "values", "row_ids", "nnz", "fill")})


def _same_matrix(X, Y):
    return X.shape == Y.shape and all(torch.equal(getattr(X, f), getattr(Y, f))
                                      for f in ("indptr", "cols", "values", "row_ids", "nnz", "fill"))


REPLACED = {
    "transpose_of": lambda M: F.transpose_of(M),
    "skew_stats": lambda M: F.skew_stats(M),
    "stored_finite": lambda M: F.stored_finite(M),
    "tc pattern verdict": lambda M: alg._is_pattern(M),
    "default At": lambda M: alg._default_At(M),
}


@pytest.mark.parametrize("fact", list(REPLACED))
def test_a_replaced_structure_gets_its_own_facts(fact):
    """A matrix made by ``dataclasses.replace`` that keeps A's ``values`` but
    takes another graph's indptr, cols, row_ids and nnz gets what a copy of
    it with tensors of its own gets, after A's fact was built, and not A's."""
    A, R = _pair()
    of = REPLACED[fact]
    mine, theirs, want = of(A), of(R), of(_fresh(R))
    if fact == "default At":
        assert mine is not A and _same_matrix(mine, F.csr_transpose_host(A))  # A is directed
        assert theirs is R and want is not R  # R is symmetric: its own default At is R itself
    elif fact == "transpose_of":
        assert _same_matrix(theirs, want) and not _same_matrix(theirs, mine)
    else:
        assert theirs == want != mine


# each derived fact, how a matrix M asks for it, and the tensors and plain key it is a fact of
KEYED = {
    "stored_finite": (F.stored_finite, F.stored_finite, lambda M: (M.values, M.nnz), lambda M: ()),
    "transpose_of": (F.transpose_of, F.transpose_of,
                     lambda M: (M.row_ids, M.cols, M.values, M.nnz, M.fill), lambda M: M.shape),
    "skew_stats": (F.skew_stats, F.skew_stats, lambda M: (M.row_ids, M.cols, M.nnz), lambda M: M.shape),
    "_default_At": (alg._default_At, alg._default_At,
                    lambda M: (M.row_ids, M.cols, M.values, M.nnz, M.fill), lambda M: M.shape),
    "_is_pattern": (alg._is_pattern, alg._is_pattern, lambda M: (M.values, M.nnz), lambda M: ()),
    "_stored": (alg._stored, alg._stored, lambda M: (M.nnz,), lambda M: ()),
    "pull_plan": (K1.pull_plan, K1.pull_plan, lambda M: (M.indptr,), lambda M: ()),
    "push_degrees": (K2.push_degrees, K2.push_degrees, lambda M: (M.indptr,), lambda M: ()),
    "resident_plan": (K6.resident_plan, K6.resident_plan, lambda M: (M.indptr,), lambda M: ()),
    "staged_plan": (K7.staged_plan, lambda M: K7.staged_plan(M, 16), lambda M: (M.indptr,), lambda M: (16,)),
    "mxmt_plan": (K45.mxmt_plan, lambda M: K45.mxmt_plan(M, M),
                  lambda M: (M.indptr, M.cols, M.row_ids, M.indptr), lambda M: ()),
    "ordered_walk": (K45.ordered_walk, K45.ordered_walk, lambda M: (M.indptr, M.cols, M.row_ids, M.nnz),
                     lambda M: M.shape),
    "mxm_plan": (K9.mxm_plan, lambda M: K9.mxm_plan(M, M), lambda M: (M.indptr, M.cols, M.nnz, M.indptr),
                 lambda M: ()),
}


@pytest.mark.parametrize("fact", list(KEYED))
def test_each_fact_is_keyed_on_the_tensors_it_reads(fact):
    """After a fact is asked of a matrix, the store holds it under exactly
    the tensors (and plain key) the fact reads, also for copies of the
    matrix with any one tensor replaced by a copy of its own; a copy of a
    tensor the fact does not read gets the same object, a copy of one it
    reads a fact of its own."""
    owner, ask, tensors, extra = KEYED[fact]
    A = _pair()[0]
    got = ask(A)
    assert F.derived(owner, tensors(A), _unbuilt, extra(A)) is got
    for field in ("indptr", "cols", "values", "row_ids", "nnz", "fill"):
        M = dataclasses.replace(A, **{field: getattr(A, field).clone()})
        read = any(t is getattr(M, field) for t in tensors(M))
        if read:
            with pytest.raises(AssertionError, match="not in the store"):
                F.derived(owner, tensors(M), _unbuilt, extra(M))
        again = ask(M)
        assert F.derived(owner, tensors(M), _unbuilt, extra(M)) is again
        if not read:
            assert again is got


class _Fact:
    """A fact that can be referenced weakly."""


@pytest.mark.parametrize("dies", [0, 1, 2])
def test_an_entry_dies_with_any_of_its_tensors(dies):
    """An entry keyed on three tensors lives while all three do, and is
    dropped (its fact freed) when any one of them is collected."""
    def owner():
        pass

    keyed = [torch.zeros(4) for _ in range(3)]
    fact = _Fact()
    alive = weakref.ref(fact)
    assert F.derived(owner, tuple(keyed), lambda: fact) is fact
    del fact
    gc.collect()
    assert alive() is not None
    assert F.derived(owner, tuple(keyed), _unbuilt) is alive()
    del keyed[dies]
    gc.collect()
    assert alive() is None


def test_a_second_call_with_the_same_tensors_returns_the_same_object():
    """The same live tensors and plain key hit the fact built first, whatever
    build the second call brings; other tensors of equal content, another
    plain key or another owner build their own."""
    def owner():
        pass

    def other():
        pass

    a, b = torch.arange(5), torch.arange(6)
    built = []

    def build():
        built.append(_Fact())
        return built[-1]

    first = F.derived(owner, (a, b), build, (7,))
    assert F.derived(owner, (a, b), build, (7,)) is first and len(built) == 1
    assert F.derived(owner, (a, b.clone()), build, (7,)) is not first
    assert F.derived(owner, (a, b), build, (8,)) is not first
    assert F.derived(other, (a, b), build, (7,)) is not first
    assert len(built) == 4 and F.derived(owner, (a, b), _unbuilt, (7,)) is first
    A = _pair()[0]
    assert K1.pull_plan(A) is K1.pull_plan(dataclasses.replace(A, values=A.values.clone()))
    assert K45.mxmt_plan(A, A) is K45.mxmt_plan(A, A) and alg._default_At(A) is alg._default_At(A)


# ---------------------------------------------------------------- the hub-chunk cut

B_LENGTHS = {
    "no hub": [3] * 40,
    "one hub row": [5] * 20 + [K45.HUB_LEN + 1] + [2] * 19,
    "chunk edges": [2 * K45.HUB_CHUNK, 4, 2 * K45.HUB_CHUNK + 1, K45.HUB_CHUNK, K45.HUB_CHUNK + 1],
    "at the limit": [K45.HUB_LEN, 1, K45.HUB_LEN, 0],
    "only hubs": [K45.HUB_LEN + 1] * 3,
    "mixed": np.random.default_rng(8).integers(0, 3 * K45.HUB_CHUNK, 30).tolist(),
    "empty mask": [K45.HUB_CHUNK + 9] * 4,
}


def _mxmt_operands(name, extra_capacity):
    """``(mask, B)``: B with the named row lengths (columns sorted, repeats
    kept) and a mask of 12 rows over B's rows, each entry a B row (a row of
    the mask may name a B row more than once); capacity beyond nnz by
    ``extra_capacity``."""
    lens = np.asarray(B_LENGTHS[name], np.int64)
    nb = lens.size
    rng = np.random.default_rng(nb)
    brows = np.repeat(np.arange(nb, dtype=np.int32), lens)
    bip = np.zeros(nb + 1, np.int64)
    np.cumsum(lens, out=bip[1:])
    bcols = np.sort(rng.integers(0, 16, (nb, int(lens.max(initial=0)))), axis=1)
    bcols = np.concatenate([bcols[j, :lens[j]] for j in range(nb)]).astype(np.int32)
    B = csr_from_numpy((nb, 16), bip, bcols, np.ones(brows.size, np.int32), brows, brows.size, np.int32(0), "cpu")
    m = 12
    per_row = np.zeros(m, np.int64) if name == "empty mask" else rng.integers(0, 2 * nb, m)
    mrows = np.repeat(np.arange(m, dtype=np.int32), per_row)
    mcols = np.concatenate([np.sort(rng.integers(0, nb, k)) for k in per_row]).astype(np.int32)
    mip = np.zeros(m + 1, np.int64)
    np.cumsum(per_row, out=mip[1:])
    pad = extra_capacity
    mask = csr_from_numpy((m, nb), mip, np.concatenate([mcols, np.zeros(pad, np.int32)]),
                          np.ones(mrows.size + pad, np.int32), np.concatenate([mrows, np.full(pad, m, np.int32)]),
                          mrows.size, np.int32(0), "cpu")
    return mask, B


def _numpy_mxmt_plan(mask, B):
    """By definition: the stored entries e (in order) whose B row j =
    mask.cols[e] holds more than HUB_LEN entries are the hubs; hub h's
    chunks walk B's entries from its row's start in steps of HUB_CHUNK,
    each for entry e of mask row mask.row_ids[e]; the products are the B
    rows' lengths summed over the stored entries."""
    mip, bip = mask.indptr.numpy().astype(np.int64), B.indptr.numpy().astype(np.int64)
    mcols, mrows = mask.cols.numpy(), mask.row_ids.numpy()
    stored = int(mip[-1])
    entry, row, c0, c1, hub, first, products = [], [], [], [], [], [0], 0
    for e in range(stored):
        j = mcols[e]
        lo, hi = bip[j], bip[j + 1]
        products += hi - lo
        if hi - lo <= K45.HUB_LEN:
            continue
        for c in range(lo, hi, K45.HUB_CHUNK):
            entry.append(e), row.append(mrows[e]), c0.append(c), c1.append(min(c + K45.HUB_CHUNK, hi))
            hub.append(len(first) - 1)
        first.append(len(entry))
    return {"chunk_entry": entry, "chunk_row": row, "chunk_c0": c0, "chunk_c1": c1, "chunk_hub": hub,
            "chunk_first": first, "stored": stored, "nhub": len(first) - 1, "nchunks": len(entry),
            "products": int(products)}


@pytest.mark.parametrize("extra_capacity", [0, 13])
@pytest.mark.parametrize("name", list(B_LENGTHS))
def test_mxmt_plan_hub_chunks_match_numpy(name, extra_capacity):
    """Kernels 4 and 5's plan (capacity beyond nnz or not) against its
    definition: every chunk array int32 and equal to numpy's, the counts,
    and the scratch of a hub cut in several chunks."""
    mask, B = _mxmt_operands(name, extra_capacity)
    plan = K45.mxmt_plan(mask, B)
    want = _numpy_mxmt_plan(mask, B)
    for field, value in want.items():
        got = getattr(plan, field)
        if isinstance(got, torch.Tensor):
            assert got.dtype == torch.int32, field
            got = got.tolist()
        assert got == value, field
    assert (plan.part is not None) == (plan.nchunks > plan.nhub)
    if plan.part is not None:
        assert plan.part.shape == (plan.nchunks,) and plan.done.shape == (plan.nhub,)
        assert not bool(plan.done.any())
    if name not in ("no hub", "at the limit", "empty mask"):
        assert plan.nhub > 0


def test_hub_chunks_reads_its_extra_counts_with_its_own():
    """The cut on hand-made items: item 1 (entries 10-310) and item 3
    (entries 400-1500) are hubs at hub_len 256, cut in chunks of 512; the
    extra 0-d tensors come back as ints after the counts."""
    starts = torch.tensor([0, 10, 310, 400], dtype=torch.long)
    lens = torch.tensor([10, 300, 90, 1100], dtype=torch.long)
    cut, counts = K1.hub_chunks(starts, lens, 256, 512, lens.sum(), torch.tensor(7))
    assert counts == (2, 4, 1500, 7)
    hubs, item, c0, c1, hub, first = (t.tolist() for t in cut)
    assert (hubs, item, hub, first) == ([1, 3], [1, 3, 3, 3], [0, 1, 1, 1], [0, 1, 4])
    assert list(zip(c0, c1)) == [(10, 310), (400, 912), (912, 1424), (1424, 1500)]
    assert all(t.dtype == torch.long for t in cut)
