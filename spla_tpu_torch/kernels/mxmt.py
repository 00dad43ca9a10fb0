"""Kernels 4 and 5: masked SpGEMM-T by sorted-row intersection
(``csrc/mxmt.cu``), each with its plain version.

For mask entries e = (i, j) = ``(mask.row_ids[e], mask.cols[e])`` with
``sel[e]`` (the caller's ``op_select(mask.values) & mask.valid_mask()``;
``sel`` None selects every stored entry)::

    products(e) = { mul(A[i,k], B[j,k]) : k = B.cols[t], t in row j of B,
                    k found in row i of A }
    kernel 4  mxmt_reduce:  total  = sum of products(e) over every e
    kernel 5  mxmt_masked:  out[e] = init (+) fold_(+) products(e)
                            has[e] = sel[e] and products(e) is not empty

Kernel 4 replaces ``spla_tpu/pallas/mxmt.py`` ``pallas_mxmT_reduce`` (:335);
kernel 5 replaces ``pallas_mxmT_job_partials`` (:362) with the segment fold
after it (``spla_tpu/ops/spgemm.py:711``).  Rows of A and B must be sorted
by column (non-decreasing), as the port's builders make them.  Each
product of B's row j counts, duplicates included; in A's row i only the
first of equal columns matches (a lower-bound search).  ``struct_only``
treats every hit's product as 1 and reads no values.

Kernel 4 sums i32 and u32 products and hits in int64 and f32 products in
float64; its result is a 0-d tensor of that dtype.

Kernel 4's structural instance also walks in order (``ordered``): only the
mask entries (i, j) with j < i, each over the columns k < j of B's row j.
Where mask = A = B is a symmetric pattern with no diagonal entry and
strictly increasing rows (``ordered_walk`` checks it on the device, once
per matrix), that counts each triangle k < j < i once, a sixth of the full
structural sum: GAP's ordered count, which ``algorithms.tc`` takes there.
On a uniform graph it reads about a sixth of the full walk's B elements
(``ordered_walk``'s count against ``mxmt_products``).

They take what spla_tpu's Pallas SpGEMM-T takes (``_pallas_mxmT_try``,
``spla_tpu/ops/spgemm.py:630``; ``masked_codes``): an add of PLUS, MIN or
MAX (``_MXMT_IDENT``), with every built-in mul in f32 and with PLUS, MULT,
FIRST, SECOND, MIN or MAX (``_MXMT_INT_MULS``) in i32 and u32; kernel 4 the
same muls.  One instance per (add, dtype) serves them all: the mul is a
kernel argument (``csrc/mxmt.cu``).

The kernels walk the mask's stored entries in windows of ``WINDOW``, a
warp a window, which stages the window's rows of A in shared memory when
they hold at most ``A_STAGE`` entries (it reads ``mask.row_ids``), and fold
each entry with a team of ``TEAM`` (two) lanes.  Their launch is shaped by
``mxmt_plan``, built on the device from the mask and B at their first CUDA
call, a fact of the tensors it reads (``formats.derived``): the stored
count and the entries whose B row is longer than ``HUB_LEN``, cut into
chunks of ``HUB_CHUNK`` B entries, a CTA each (kernel 1's cut,
``spmv.hub_chunks``).  Building it reads the host once, and that read also
gives the products the kernels walk (``MxmtPlan.products``,
``mxmt_products``).  No argument or setting chooses any of it.  The CUDA source's header
says what bounds the kernels and how they are laid out.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import op as OP
from ..containers import CsrMatrix
from ..formats import derived
from ..utils.bits import cat, gather
from ..utils.primitives import expand_schedule
from ..utils.search import bisect_steps, rowwise_find
from ..utils.segments import segment_fold
from . import LAUNCHES
from .build import check, load_library
from .spmv import (DTYPE_CODES, PULL_ADDS, TEMPLATED_MULS, _init_arg, _mask, _on_cpu, _ptr, _require_cuda,
                   hub_chunks, hub_scratch, semiring_codes)

__all__ = [
    "PRODUCT_CHUNK",
    "WINDOW",
    "A_STAGE",
    "TEAM",
    "HUB_LEN",
    "HUB_CHUNK",
    "MxmtPlan",
    "mxmt_plan",
    "mxmt_products",
    "ordered_walk",
    "masked_codes",
    "reduce_codes",
    "mxmt_masked",
    "mxmt_masked_plain",
    "mxmt_reduce",
    "mxmt_reduce_plain",
]

# the plain versions expand at most this many product slots at once: the
# mask is cut into ranges of whole entries, so no entry's fold is split
PRODUCT_CHUNK = 1 << 26

WINDOW = 32  # stored mask entries a warp walks at once, a lane each (csrc/mxmt.cu kWindow)
A_STAGE = 256  # entries of A's rows a warp stages in shared memory (kStage); more: global memory
TEAM = 2  # lanes that fold one entry (kTeam)
HUB_LEN = 256  # a B row of more entries is walked in chunks, a CTA each
HUB_CHUNK = 2048  # entries of a long B row a CTA walks

VERDICT_CHUNK = 1 << 26  # entries ordered_walk's check takes at once


def masked_codes(op_mul, op_add, dtype, struct_only=False):
    """``(mul, add, dtype)`` codes when kernel 5 covers the request, else None
    (mul is 0 and unused for ``struct_only``, which takes any mul)."""
    if struct_only:
        add = getattr(op_add, "kernel_code", None)
        if add not in PULL_ADDS or dtype not in DTYPE_CODES:
            return None
        return 0, int(add), DTYPE_CODES[dtype]
    codes = semiring_codes(op_mul, op_add, dtype, int_adds=PULL_ADDS)
    if codes is None or (not dtype.is_floating_point and codes[0] not in TEMPLATED_MULS):
        return None
    return codes


def reduce_codes(op_mul, dtype, struct_only=False):
    """``(mul, dtype)`` codes when kernel 4 covers the request (the muls of
    ``masked_codes``), else None."""
    if struct_only:
        return 0, 0
    codes = masked_codes(op_mul, OP.PLUS_FLOAT, dtype)  # the gate reads the add's code only
    return None if codes is None else (codes[0], codes[2])


# ---------------------------------------------------------------- plain versions


def _entry_ranges(deg):
    """``[(e0, e1, products)]``: consecutive ranges of whole mask entries with
    at most PRODUCT_CHUNK products each (more only for a single entry)."""
    ends = torch.cumsum(deg, 0)
    total = int(ends[-1]) if ends.numel() else 0
    if total <= PRODUCT_CHUNK:
        return [(0, deg.shape[0], total)]
    ends = ends.cpu().numpy()
    ranges, e0, base = [], 0, 0
    while e0 < ends.size:
        e1 = int(np.searchsorted(ends, base + PRODUCT_CHUNK, side="right"))
        e1 = max(e1, e0 + 1)
        ranges.append((e0, e1, int(ends[e1 - 1]) - base))
        e0, base = e1, int(ends[e1 - 1])
    return ranges


def _lower_degrees(B: CsrMatrix) -> torch.Tensor:
    """The stored entries of each row r of B whose column is below r (int64
    [B.shape[0]]): the prefix of a sorted row that the ordered walk reads."""
    mb = B.shape[0]
    below = B.valid_mask() & (B.cols.long() < B.row_ids.long())
    out = torch.zeros(mb, dtype=torch.long, device=B.cols.device)
    return out.index_add_(0, B.row_ids.long().clamp(0, max(mb - 1, 0)), below.long())


def _entry_degrees(mask: CsrMatrix, B: CsrMatrix, ordered: bool = False) -> torch.Tensor:
    """B's row length at each stored mask entry's column, 0 past the stored
    entries (int64 [mask.capacity]): the product slots of each entry.  With
    ``ordered``, the entries (i, j) with j < i only, each with the columns
    of B's row j below j."""
    mcols = mask.cols.long().clamp(0, max(B.shape[0] - 1, 0))
    if ordered:
        lens = _lower_degrees(B)
        keep = mask.valid_mask() & (mask.cols < mask.row_ids)
    else:
        lens, keep = B.indptr[1:] - B.indptr[:-1], mask.valid_mask()
    return torch.where(keep, lens[mcols].long(), 0)


def _ranges_and_steps(mask: CsrMatrix, A: CsrMatrix, B: CsrMatrix, products_cap, ordered=False):
    """The entry ranges to expand, each with its slot count, and the
    bisection steps that cover A's longest row (host reads)."""
    deg = _entry_degrees(mask, B, ordered)
    if products_cap is not None:  # one pass of a given size; slots past it drop
        ranges = [(0, mask.capacity, int(products_cap))]
    else:
        ranges = _entry_ranges(deg)
    deg_a = A.indptr[1:] - A.indptr[:-1]
    steps = bisect_steps(max(int(deg_a.max()) if deg_a.numel() else 0, 1))
    return deg, ranges, steps


def _intersect(mask, A, B, sel, deg, e0, e1, cap, steps):
    """Expand mask entries [e0, e1) to ``cap`` product slots (one per element
    of B's row j) and find each slot's column in A's row i.  Returns
    ``(src, a_pos, b_pos, valid)``; ``src`` is the entry relative to e0."""
    m = A.shape[0]
    src, local, slot_valid = expand_schedule(deg[e0:e1], mask.valid_mask()[e0:e1], max(cap, 1))
    srcl = src.long()
    j = mask.cols[e0:e1].long().clamp(0, max(B.shape[0] - 1, 0))[srcl]
    b_pos = (B.indptr[j] + local).clamp(0, max(B.capacity - 1, 0)).long()
    kk = B.cols[b_pos]
    i = mask.row_ids[e0:e1].long().clamp(0, max(m - 1, 0))[srcl]
    a_pos, found = rowwise_find(A.cols, A.indptr[i], A.indptr[i + 1], kk, steps)
    return src, a_pos.long(), b_pos, slot_valid & found & sel[e0:e1][srcl]


def mxmt_masked_plain(mask: CsrMatrix, A: CsrMatrix, B: CsrMatrix, op_mul, op_add, init, sel=None,
                      struct_only=False, products_cap=None):
    """Plain PyTorch version of kernel 5 for any semiring: the expand / find /
    fold of ``spla_tpu/ops/spgemm.py`` ``_mxmT_numeric``.  Returns
    ``(out, has)`` of length ``mask.capacity``.  ``products_cap`` expands in
    one pass of that many slots (later slots drop, as in spla_tpu); by
    default the exact count, in ranges of at most PRODUCT_CHUNK."""
    init = torch.as_tensor(init, dtype=A.values.dtype, device=A.values.device)
    sel = mask.valid_mask() if sel is None else sel
    deg, ranges, steps = _ranges_and_steps(mask, A, B, products_cap)
    outs, hass = [], []
    for e0, e1, cap in ranges:
        src, a_pos, b_pos, valid = _intersect(mask, A, B, sel, deg, e0, e1, cap, steps)
        if struct_only:
            prod = torch.ones(valid.shape, dtype=init.dtype, device=init.device)
        else:
            prod = op_mul(gather(A.values, a_pos), gather(B.values, b_pos))
        out, has = segment_fold(prod, src, valid, e1 - e0, op_add, init, sorted_ids=True)
        outs.append(out)
        hass.append(has)
    return cat(outs), torch.cat(hass)


def _acc_dtype(dtype, struct_only):
    return torch.float64 if dtype.is_floating_point and not struct_only else torch.int64


def mxmt_reduce_plain(mask: CsrMatrix, A: CsrMatrix, B: CsrMatrix, op_mul, sel=None,
                      struct_only=False, ordered=False):
    """Plain version of kernel 4: the same expansion, every product summed in
    int64 (integers, and hits when ``struct_only``) or float64 (floats).
    ``ordered`` is kernel 4's ordered walk: only the mask entries (i, j)
    with j < i, each over the columns k < j of B's row j."""
    acc = _acc_dtype(A.values.dtype, struct_only)
    sel = mask.valid_mask() if sel is None else sel
    deg, ranges, steps = _ranges_and_steps(mask, A, B, None, ordered)
    total = torch.zeros((), dtype=acc, device=A.values.device)
    for e0, e1, cap in ranges:
        _, a_pos, b_pos, valid = _intersect(mask, A, B, sel, deg, e0, e1, cap, steps)
        if struct_only:
            total += valid.sum()
        else:
            prod = op_mul(gather(A.values, a_pos), gather(B.values, b_pos)).to(acc)
            total += torch.where(valid, prod, 0).sum()
    return total


# ---------------------------------------------------------------- the plan


@dataclass(frozen=True)
class MxmtPlan:
    """The launch shape of kernels 4 and 5 (and of the gather) for one mask
    and B, on their device.  ``stored`` is the mask's ``indptr[m]``: its
    ``ceil(stored / WINDOW)`` windows are walked a warp each.  The hub
    entries are the stored entries whose B row is longer than ``HUB_LEN``,
    in entry order; hub h has chunks ``chunk_first[h]`` ..
    ``chunk_first[h + 1] - 1``, chunk b walking B's entries ``[chunk_c0[b],
    chunk_c1[b])`` for mask entry ``chunk_entry[b]`` of row
    ``chunk_row[b]``, a CTA each.  ``products`` is the sum of B's row
    length over the stored entries: the elements of B the kernels walk.
    Where a hub has several chunks, ``part``/``part_any``/``done`` are
    kernel 5's scratch (``spmv.hub_scratch``)."""

    chunk_entry: torch.Tensor  # int32 [nchunks]
    chunk_row: torch.Tensor  # int32 [nchunks]
    chunk_c0: torch.Tensor  # int32 [nchunks]
    chunk_c1: torch.Tensor  # int32 [nchunks]
    chunk_hub: torch.Tensor  # int32 [nchunks]
    chunk_first: torch.Tensor  # int32 [nhub + 1]
    stored: int
    nhub: int
    nchunks: int
    products: int
    part: torch.Tensor | None = None
    part_any: torch.Tensor | None = None
    done: torch.Tensor | None = None


def mxmt_plan(mask: CsrMatrix, B: CsrMatrix) -> MxmtPlan:
    """The plan of ``mask`` against ``B``, built on their device, a fact of
    mask.indptr, mask.cols, mask.row_ids and B.indptr; the stored, hub and
    chunk counts and the products are read on the host once, at the first
    build."""
    return derived(mxmt_plan, (mask.indptr, mask.cols, mask.row_ids, B.indptr), lambda: _mxmt_plan(mask, B))


def _mxmt_plan(mask: CsrMatrix, B: CsrMatrix) -> MxmtPlan:
    device = mask.cols.device
    mip, bip = mask.indptr.long(), B.indptr.long()
    stored = torch.arange(mask.capacity, device=device) < mip[-1]
    j = mask.cols.long().clamp(0, max(B.shape[0] - 1, 0))
    blen = torch.where(stored, (bip[1:] - bip[:-1])[j], 0)
    (_, chunk_entry, *cut), (nhub, nchunks, nstored, products) = hub_chunks(
        bip[j], blen, HUB_LEN, HUB_CHUNK, mip[-1], blen.sum())
    scratch = hub_scratch(nchunks, nhub, device) if nchunks > nhub else {}
    i32 = [t.to(torch.int32) for t in (chunk_entry, mask.row_ids[chunk_entry], *cut)]
    return MxmtPlan(*i32, nstored, nhub, nchunks, products, **scratch)


def mxmt_products(mask: CsrMatrix, B: CsrMatrix) -> int:
    """The elements of B's rows that a call over every stored entry of
    ``mask`` walks: the sum of B's row length over the stored entries.  On
    CUDA tensors it is the cached plan's ``products``, so no host read
    follows the plan's build; on CPU tensors the plain versions' slot
    count (``_entry_degrees``), summed."""
    if mask.cols.device.type == "cuda":
        return mxmt_plan(mask, B).products
    return int(_entry_degrees(mask, B).sum())


def ordered_walk(A: CsrMatrix) -> int | None:
    """The elements of A's rows that kernel 4's ordered walk of ``tc`` reads
    (``mxmt_reduce(A, A, A, ..., ordered=True)``): Σ over the stored (i, j)
    with j < i of the entries of row j below j.  None unless A is square,
    symmetric, with no diagonal entry and strictly increasing rows (no
    duplicate column), the inputs on which that walk, times 6, is the full
    structural sum.  Checked on A's device, where it leaves nothing
    allocated; a fact of A.indptr, A.cols, A.row_ids, A.nnz and the shape,
    and the check reads the host once."""
    return derived(ordered_walk, (A.indptr, A.cols, A.row_ids, A.nnz),
                   lambda: _ordered_walk(A) if A.shape[0] == A.shape[1] else None, A.shape)


def _ordered_walk(A: CsrMatrix) -> int | None:
    """``ordered_walk``'s check.  Each stored entry is the int64 key
    ``row * n + col``; the keys strictly increase, and ``indptr`` starts each
    row where they say, exactly when the rows are sorted with no duplicate
    and agree with ``row_ids``.  Then each entry (i, j) finds the key of
    (j, i) by a search of the keys, and row j's entries below j end where
    the key of (j, j) would go."""
    n, cap, device = A.shape[0], A.capacity, A.cols.device
    top = torch.iinfo(torch.int64).max  # past the stored entries: the keys stay sorted
    keys = torch.empty(cap, dtype=torch.long, device=device)
    bad = torch.zeros(3, dtype=torch.long, device=device)  # out of order, diagonal, mirror missing
    chunks = [(c0, min(c0 + VERDICT_CHUNK, cap)) for c0 in range(0, cap, VERDICT_CHUNK)]
    for c0, c1 in chunks:
        stored = torch.arange(c0, c1, device=device) < A.nnz
        r, c = A.row_ids[c0:c1].long(), A.cols[c0:c1].long()
        keys[c0:c1] = torch.where(stored, r * n + c, top)
        bad[1] += (stored & (r == c)).sum()
    for c0, c1 in chunks:
        stored = torch.arange(c0, c1, device=device) < A.nnz
        mirror = A.cols[c0:c1].long() * n + A.row_ids[c0:c1].long()
        found = keys[torch.searchsorted(keys, mirror).clamp_(max=cap - 1)] == mirror
        bad[2] += (stored & ~found).sum()
        lo = max(c0, 1)
        bad[0] += ((keys[lo:c1] <= keys[lo - 1:c1 - 1]) & stored[lo - c0:]).sum()
    rows = torch.arange(n + 1, device=device)
    starts = torch.searchsorted(keys, rows * n)
    bad[0] += (starts != A.indptr.long()).sum()
    low = torch.searchsorted(keys, rows[:n] * (n + 1)) - starts[:n]  # row j's entries below j
    walked = (low * (starts[1:] - starts[:n] - low)).sum()  # × the entries (i, j), i > j, of column j
    counts = torch.cat([bad, walked.reshape(1)]).tolist()
    del keys
    return None if any(counts[:3]) else counts[3]


# ---------------------------------------------------------------- kernels


def _check_operands(what, mask, A, B, sel, values):
    """Raise unless mask, A, B and sel lie on one CUDA device with int32
    indices, contiguous, in matching shapes (and, with ``values``, one value
    dtype)."""
    _require_cuda(what, A, {"mask.indptr": mask.indptr, "mask.cols": mask.cols, "mask.row_ids": mask.row_ids,
                            "sel": _mask(sel, what, "sel")},
                  {"mask.row_ids": mask.capacity, "sel": mask.capacity})
    _require_cuda(what, B, {}, {})
    if B.values.device != A.values.device:
        raise ValueError(f"{what}: B is on {B.values.device}, A on {A.values.device}")
    if any(t.dtype != torch.int32 for t in (mask.indptr, mask.cols, mask.row_ids)):
        raise TypeError(f"{what}: mask indices must be int32")
    if mask.indptr.shape != (mask.shape[0] + 1,):
        raise ValueError(f"{what}: mask.indptr has shape {tuple(mask.indptr.shape)}, "
                         f"want ({mask.shape[0] + 1},)")
    if mask.shape != (A.shape[0], B.shape[0]) or A.shape[1] != B.shape[1]:
        raise ValueError(f"{what}: shapes mask {mask.shape}, A {A.shape}, B {B.shape} "
                         "do not fit mask = A x B^T")
    if values and B.values.dtype != A.values.dtype:
        raise TypeError(f"{what}: B is {B.values.dtype}, A {A.values.dtype}")


def _launch(what, mode, codes, mask, A, B, sel, init=None, init_bits=0, out=None, has=None,
            total=None, ordered=False):
    """One launch of ``csrc/mxmt.cu``'s ``spla_mxmt`` (mode 0: kernel 4, 1:
    kernel 5, 2: the gather; ``ordered``: the ordered walk of kernel 4's
    structural instance and of the gather) with ``mask``'s plan against B."""
    mul, add, dtype, structural = codes
    plan = mxmt_plan(mask, B)
    rc = load_library().spla_mxmt(
        mode, mul, add, dtype, structural, int(ordered), mask.capacity, mask.row_ids.data_ptr(),
        mask.cols.data_ptr(), _ptr(sel), A.indptr.data_ptr(), A.cols.data_ptr(), A.values.data_ptr(),
        B.indptr.data_ptr(), B.cols.data_ptr(), B.values.data_ptr(), HUB_LEN, plan.stored, plan.nhub, plan.nchunks,
        *(t.data_ptr() for t in (plan.chunk_entry, plan.chunk_row, plan.chunk_c0, plan.chunk_c1,
                                 plan.chunk_hub, plan.chunk_first)),
        _ptr(plan.part), _ptr(plan.part_any), _ptr(plan.done), _ptr(init), init_bits, _ptr(out),
        _ptr(has), _ptr(total), torch.cuda.current_stream(A.values.device).cuda_stream)
    check(rc, what)
    LAUNCHES[what] += 1


def mxmt_masked(mask: CsrMatrix, A: CsrMatrix, B: CsrMatrix, op_mul, op_add, init, sel=None,
                struct_only=False):
    """Kernel 5.  Returns ``(out, has)`` of length ``mask.capacity``; ``sel``
    None selects every stored entry.  CPU tensors take the plain version;
    CUDA tensors launch the kernel, and a request it does not cover raises.
    ``init`` reaches the kernel by value (a number) or by pointer (a CUDA
    tensor), never by a copy from the host."""
    if _on_cpu(A.values, B.values, mask.cols, sel):
        return mxmt_masked_plain(mask, A, B, op_mul, op_add, init, sel, struct_only)
    what = "mxmt_masked"
    codes = masked_codes(op_mul, op_add, A.values.dtype, struct_only)
    if codes is None:
        raise NotImplementedError(
            f"{what}: no kernel instance for mul={getattr(op_mul, 'key', op_mul)}, "
            f"add={getattr(op_add, 'key', op_add)}, dtype={A.values.dtype}")
    _check_operands(what, mask, A, B, sel, values=not struct_only)
    init_t, init_bits = _init_arg(init, A.values)
    out = torch.empty(mask.capacity, dtype=A.values.dtype, device=A.values.device)
    has = torch.empty(mask.capacity, dtype=torch.bool, device=A.values.device)
    _launch(what, 1, (*codes, int(struct_only)), mask, A, B, sel, init_t, init_bits, out, has)
    return out, has


def mxmt_reduce(mask: CsrMatrix, A: CsrMatrix, B: CsrMatrix, op_mul, sel=None, struct_only=False,
                ordered=False):
    """Kernel 4: the 0-d int64 (i32, u32, hits) or float64 (f32) sum of all
    products; ``sel`` None selects every stored entry.  ``ordered`` (the
    structural instance only) walks the mask entries (i, j) with j < i over
    the columns k < j of B's row j: on ``ordered_walk``'s inputs, mask = A =
    B, a sixth of the full sum.  CPU tensors take the plain version; CUDA
    tensors launch the kernel, and a request it does not cover raises."""
    if _on_cpu(A.values, B.values, mask.cols, sel):
        return mxmt_reduce_plain(mask, A, B, op_mul, sel, struct_only, ordered)
    what = "mxmt_reduce"
    codes = reduce_codes(op_mul, A.values.dtype, struct_only)
    if ordered and not struct_only:
        raise NotImplementedError(f"{what}: the ordered walk has only the structural instance")
    if codes is None:
        raise NotImplementedError(
            f"{what}: no kernel instance for mul={getattr(op_mul, 'key', op_mul)}, "
            f"dtype={A.values.dtype}")
    _check_operands(what, mask, A, B, sel, values=not struct_only)
    total = torch.zeros(1, dtype=_acc_dtype(A.values.dtype, struct_only), device=A.values.device)
    mul, dtype = codes
    _launch(what, 0, (mul, 0, dtype, int(struct_only)), mask, A, B, sel, total=total, ordered=ordered)
    return total.reshape(())
