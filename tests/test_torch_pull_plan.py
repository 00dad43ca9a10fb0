"""Kernel 1's launch plan (``kernels/spmv.py`` ``pull_plan``, ``team_size``)
against numpy definitions, one segment and cut into segments of x at a
budget passed in (the card's L2 share in a launch), and kernel 1's CPU path
on a graph with hub rows against spla_tpu's XLA ``mxv_masked``.

Tolerances: MIN-plus bitwise; MULT/PLUS within rtol=1e-5, atol=1e-5 (the
summation order differs).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spla_tpu.formats as JF
import spla_tpu.op as JOP
import spla_tpu.ops.spmv as JS
from spla_tpu.containers import DenseVec as JDenseVec

from spla_tpu_torch import op as OP
from spla_tpu_torch.interop import csr_from_numpy, from_spla_tpu
from spla_tpu_torch.kernels import spmv as K1
from spla_tpu_torch.ops import spmv as TS


def _numpy_plan(lens):
    """(hub rows, each chunk's hub, each hub's first chunk, each chunk's
    (row, first entry, end), team size) by definition: rows longer than
    HUB_LEN, cut into chunks of HUB_CHUNK entries; the least power of two in
    [2, 32] at or above the other rows' mean length over ENTRIES_PER_LANE."""
    lens = np.asarray(lens, np.int64)
    hub = lens > K1.HUB_LEN
    rest = lens[~hub]
    want = rest.sum() / max(rest.size, 1) / K1.ENTRIES_PER_LANE
    team = next((g for g in (2, 4, 8, 16) if g >= want), 32)
    hubs = np.flatnonzero(hub).tolist()
    starts = np.concatenate([[0], np.cumsum(lens)])
    chunk_hub, chunk_first, ranges = [], [0], []
    for h, r in enumerate(hubs):
        count = -(-int(lens[r]) // K1.HUB_CHUNK)
        chunk_hub += [h] * count
        chunk_first.append(chunk_first[-1] + count)
        for c in range(count):
            c0 = starts[r] + c * K1.HUB_CHUNK
            ranges.append((r, c0, min(c0 + K1.HUB_CHUNK, starts[r + 1])))
    return hubs, chunk_hub, chunk_first, ranges, team


def _csr(lens, extra_capacity=0, seed=0):
    """A CPU CsrMatrix with the given row lengths and random columns."""
    lens = np.asarray(lens, np.int64)
    m = lens.size
    n = max(m, 1)
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m, dtype=np.int32), lens)
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(lens, out=indptr[1:])
    cols = rng.integers(0, n, rows.size, dtype=np.int32)
    vals = rng.random(rows.size, dtype=np.float32)
    cap = rows.size + extra_capacity
    pad = cap - rows.size
    return csr_from_numpy((m, n), indptr, np.concatenate([cols, np.zeros(pad, np.int32)]),
                          np.concatenate([vals, np.zeros(pad, np.float32)]),
                          np.concatenate([rows, np.full(pad, m, np.int32)]), rows.size, np.float32(0),
                          "cpu")


@pytest.mark.parametrize("walked,rows,team", [
    (0, 0, 2), (0, 10, 2), (10, 10, 2), (40, 10, 2), (41, 10, 4), (80, 10, 4), (81, 10, 8),
    (16 * 2**21, 2**21, 8), (24 * 100, 100, 16), (64 * 100, 100, 32), (10**6, 10, 32),
])
def test_team_size_from_the_mean_row_length(walked, rows, team):
    assert K1.team_size(walked, rows) == team


LENGTHS = {
    "empty matrix": [],
    "all rows empty": [0] * 37,
    "one hub row": [3] * 20 + [K1.HUB_LEN + 1] + [5] * 19,
    "hubs at both ends": [5000] + [16] * 50 + [K1.HUB_LEN + 7],
    "chunk edges": [2 * K1.HUB_CHUNK, 4, 2 * K1.HUB_CHUNK + 1, K1.HUB_CHUNK],
    "only hubs": [K1.HUB_LEN + 1] * 3,
    "at the limit": [K1.HUB_LEN, 1, K1.HUB_LEN],
    "uniform deg 24": [24] * 64,
}


@pytest.mark.parametrize("extra_capacity", [0, 13])
@pytest.mark.parametrize("name", list(LENGTHS))
def test_pull_plan_matches_numpy(name, extra_capacity):
    """The plan of a matrix (capacity beyond nnz or not) against its
    definition; it is cached per indptr tensor."""
    lens = LENGTHS[name]
    A = _csr(lens, extra_capacity)
    plan = K1.pull_plan(A)
    hubs, chunk_hub, chunk_first, ranges, team = _numpy_plan(lens)
    for t in (plan.hub_rows, plan.chunk_row, plan.chunk_c0, plan.chunk_c1, plan.chunk_hub, plan.chunk_first):
        assert t.dtype == torch.int32
    assert plan.hub_rows.tolist() == hubs and plan.chunk_hub.tolist() == chunk_hub
    assert plan.chunk_first.tolist() == chunk_first
    assert list(zip(plan.chunk_row.tolist(), plan.chunk_c0.tolist(), plan.chunk_c1.tolist())) == ranges
    assert (plan.nhub, plan.nchunks, plan.team) == (len(hubs), len(chunk_hub), team)
    assert K1.pull_plan(A) is plan


def _sorted_csr(lens, extra_capacity=0, seed=0):
    """``_csr`` with the columns of each row sorted."""
    A = _csr(lens, extra_capacity, seed)
    ip = A.indptr.long()
    for r in range(A.shape[0]):
        A.cols[ip[r]:ip[r + 1]] = A.cols[ip[r]:ip[r + 1]].sort().values
    return A


def _numpy_segmented(indptr, cols, n, segments):
    """The segmented plan by definition: ``(edges, long hubs' chunks as
    (row, c0, c1, hub), chunk_first, short hub rows, cuts, items)``.  A hub
    row's S + 1 edges: its start, the first of its entries with a column at
    or past s * ceil(n / S) for s = 1 .. S - 1, its end.  A row of more than
    HUB_CHUNK entries is cut at its edges and into HUB_CHUNK-entry chunks of
    each piece; the launch takes, segment by segment, the chunks in it,
    then the short hubs' pieces in it, 8 hubs an item."""
    indptr, cols = np.asarray(indptr, np.int64), np.asarray(cols, np.int64)
    lens = np.diff(indptr)
    width = -(-n // segments)
    edges = {}
    for r in np.flatnonzero(lens > K1.HUB_LEN):
        row = cols[indptr[r]:indptr[r + 1]]
        inner = [indptr[r] + np.searchsorted(row, s * width) for s in range(1, segments)]
        edges[int(r)] = [int(indptr[r]), *map(int, inner), int(indptr[r + 1])]
    chunks, chunk_first, chunk_seg = [], [0], []
    for h, r in enumerate(r for r in edges if lens[r] > K1.HUB_CHUNK):
        for s in range(segments):
            for c0 in range(edges[r][s], edges[r][s + 1], K1.HUB_CHUNK):
                chunks.append((r, c0, min(c0 + K1.HUB_CHUNK, edges[r][s + 1]), h))
                chunk_seg.append(s)
        chunk_first.append(len(chunks))
    short = [r for r in edges if lens[r] <= K1.HUB_CHUNK]
    cuts = [c for r in short for c in edges[r][1:-1]]
    blocks = -(-len(short) // K1.WARPS_PER_CTA)
    items = []
    for s in range(segments):
        items += [b for b, cs in enumerate(chunk_seg) if cs == s]
        items += [-1 - (c * segments + s) for c in range(blocks)]
    return edges, chunks, chunk_first, short, cuts, items


@pytest.mark.parametrize("segments", [2, 3, 5])
@pytest.mark.parametrize("name", list(LENGTHS))
def test_segmented_pull_plan_matches_numpy(name, segments):
    """The value kernel's plan at a budget of 4n / S bytes against its
    definition; every hub entry in exactly one chunk or piece, none across a
    segment's edge, the launch segment-major; with no hub row it is the
    plain plan itself; the plain (structural) plan stays as it was."""
    lens = LENGTHS[name]
    A = _sorted_csr(lens, extra_capacity=7)
    n = A.shape[1]
    budget = -(-n * K1.X_BYTES // segments)
    plan = K1.pull_plan(A, budget)
    assert K1.pull_plan(A, budget) is plan
    hubs, chunk_hub, chunk_first, ranges, team = _numpy_plan(lens)
    base = K1.pull_plan(A)
    assert base.hub_rows.tolist() == hubs and base.chunk_first.tolist() == chunk_first and base.segments == 1
    assert list(zip(base.chunk_row.tolist(), base.chunk_c0.tolist(), base.chunk_c1.tolist())) == ranges
    if not hubs:
        assert plan is base
        return
    S = -(-n * K1.X_BYTES // budget)
    edges, chunks, first, short, cuts, items = _numpy_segmented(A.indptr, A.cols, n, S)
    assert (plan.segments, plan.team, plan.nhub) == (S, team, len(hubs)) and plan.hub_rows.tolist() == hubs
    got = list(zip(*(t.tolist() for t in (plan.chunk_row, plan.chunk_c0, plan.chunk_c1, plan.chunk_hub))))
    assert got == chunks and plan.nchunks == len(chunks) and plan.chunk_first.tolist() == first
    assert plan.short_rows.tolist() == short and plan.cuts.tolist() == cuts and plan.items.tolist() == items
    assert plan.nitems == len(items)
    for t in (plan.chunk_row, plan.items, plan.short_rows, plan.cuts, plan.done):
        assert t.dtype == torch.int32
    nshort = len(short)
    assert plan.part.numel() == plan.part_any.numel() == len(chunks) + nshort * S
    assert plan.done.tolist() == [0] * (len(first) - 1 + nshort)
    # each hub entry once; each chunk or piece inside one segment; items segment-major
    width, cols = -(-n // S), A.cols.long()
    seen = torch.zeros(A.cols.numel(), dtype=torch.int64)
    segment_of = []
    for row, c0, c1, _ in chunks:
        assert 0 < c1 - c0 <= K1.HUB_CHUNK and len(set((cols[c0:c1] // width).tolist())) == 1
        seen[c0:c1] += 1
        segment_of.append(int(cols[c0]) // width)
    for j, r in enumerate(short):
        e = [int(A.indptr[r]), *cuts[j * (S - 1):(j + 1) * (S - 1)], int(A.indptr[r + 1])]
        for s in range(S):
            assert e[s] <= e[s + 1] and bool(((cols[e[s]:e[s + 1]] // width) == s).all())
            seen[e[s]:e[s + 1]] += 1
    hub_entry = torch.zeros_like(seen)
    for r in hubs:
        hub_entry[int(A.indptr[r]):int(A.indptr[r + 1])] = 1
    assert torch.equal(seen, hub_entry)
    order = [segment_of[i] if i >= 0 else (-1 - i) % S for i in items]
    assert order == sorted(order)


@pytest.mark.parametrize("name", ["one hub row", "hubs at both ends", "chunk edges", "only hubs"])
def test_segmented_pull_plan_holds_each_entry_once_on_unsorted_rows(name):
    """Where a row's columns are not sorted, its pieces no longer keep to
    their segments, but they still hold each of its entries once."""
    A = _csr(LENGTHS[name], seed=5)
    S = 4
    plan = K1.pull_plan(A, -(-A.shape[1] * K1.X_BYTES // S))
    assert plan.segments == S
    seen = torch.zeros(A.cols.numel(), dtype=torch.int64)
    for c0, c1 in zip(plan.chunk_c0.tolist(), plan.chunk_c1.tolist()):
        seen[c0:c1] += 1
    cuts = plan.cuts.view(-1, S - 1).long()
    for r, inner in zip(plan.short_rows.tolist(), cuts):
        e = [int(A.indptr[r]), *inner.tolist(), int(A.indptr[r + 1])]
        assert e == sorted(e)
        seen[e[0]:e[-1]] += 1
    want = torch.zeros_like(seen)
    for r in plan.hub_rows.tolist():
        want[int(A.indptr[r]):int(A.indptr[r + 1])] = 1
    assert torch.equal(seen, want)


def test_segmented_pull_plan_of_one_segment_is_the_plain_plan():
    """x within the budget: the plain plan, the same object, bit for bit."""
    A = _sorted_csr(LENGTHS["hubs at both ends"])
    plan = K1.pull_plan(A, A.shape[1] * K1.X_BYTES)
    assert plan is K1.pull_plan(A) and plan.segments == 1 and plan.items is None and plan.nitems == plan.nchunks


def test_segmented_pull_plan_is_a_fact_of_indptr_and_cols():
    """A matrix that keeps A's indptr but takes a new cols tensor (the same
    columns) gets a new segmented plan, equal to A's, and the same plain
    plan; a new width gets a new one."""
    A = _sorted_csr(LENGTHS["hubs at both ends"])
    budget = A.shape[1] * K1.X_BYTES // 3
    plan = K1.pull_plan(A, budget)
    B = dataclasses.replace(A, cols=A.cols.clone())
    again = K1.pull_plan(B, budget)
    assert again is not plan and K1.pull_plan(B) is K1.pull_plan(A)
    for f in ("chunk_row", "chunk_c0", "chunk_c1", "chunk_hub", "chunk_first", "items", "short_rows", "cuts"):
        assert torch.equal(getattr(again, f), getattr(plan, f))
    assert K1.pull_plan(dataclasses.replace(A, shape=(A.shape[0], 2 * A.shape[1])), budget) is not plan


def test_pull_plan_of_a_row_split_part():
    """A split_rows part has its own indptr and so its own plan: its hub rows
    are the whole matrix's in its range, rebased."""
    from spla_tpu_torch import formats as F

    lens = [16] * 40 + [600] + [16] * 40 + [900, 2]
    A = _csr(lens)
    parts = F.split_rows(A, 2)
    got, r0 = [], 0
    for part in parts:
        plan = K1.pull_plan(part)
        assert plan is not K1.pull_plan(A)
        got += (plan.hub_rows.long() + r0).tolist()
        r0 += part.shape[0]
    assert got == K1.pull_plan(A).hub_rows.tolist() == [40, 81]


@pytest.mark.parametrize("mul,add,fill", [("PLUS", "MIN", np.inf), ("MULT", "PLUS", 0.0)])
def test_spmv_pull_on_hub_rows_matches_spla_tpu(mul, add, fill):
    """Kernel 1's CPU path through mxv_masked on a graph with three hub rows
    (one at each end) and empty rows, against spla_tpu's XLA path."""
    n = 600
    rng = np.random.default_rng(4)
    hubs = [0, 300, n - 1]
    rows = np.concatenate([rng.integers(0, n, 3 * n), np.repeat(hubs, K1.HUB_LEN + 50)])
    # distinct columns in the hub rows, so that no duplicate folds them below HUB_LEN
    cols = np.concatenate([rng.integers(0, n, 3 * n),
                           *(rng.permutation(n)[: K1.HUB_LEN + 50] for _ in hubs)])
    vals = rng.uniform(0.1, 2.0, rows.size).astype(np.float32)
    JA = JF.csr_from_entries((n, n), rows, cols, vals, fill=fill, dtype=np.float32,
                             capacity=rows.size + 9)
    A = from_spla_tpu(JA, "cpu")
    assert K1.pull_plan(A).nhub == 3
    x = rng.uniform(-2, 2, n).astype(np.float32)
    x[rng.random(n) < 0.3] = fill
    mvals = (rng.random(n) < 0.7).astype(np.float32)
    jv, jmask = JDenseVec(jnp.asarray(x), jnp.float32(fill)), JDenseVec(jnp.asarray(mvals), jnp.float32(0))
    want = JS.mxv_masked(jmask, JA, jv, JOP.lookup(mul, JOP.FLOAT), JOP.lookup(add, JOP.FLOAT),
                         JOP.NQZERO_FLOAT, fill)
    got = TS.mxv_masked(from_spla_tpu(jmask, "cpu"), A, from_spla_tpu(jv, "cpu"),
                        OP.lookup(mul, OP.FLOAT), OP.lookup(add, OP.FLOAT), OP.NQZERO_FLOAT, fill)
    g, w = got.values.numpy(), np.asarray(want.values)
    if add == "PLUS":
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(g, w)
