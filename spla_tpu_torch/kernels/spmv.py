"""Kernel 1: the CSR semiring pull SpMV (``csrc/spmv_pull.cu``) and its plain version.

Replaces ``spla_tpu/pallas/spmv.py`` ``fused_cell_spmv_apply`` (:2055) and
the full-grid branch of ``fused_spmv2d_adaptive`` (:2346).  The CUDA
source's header says what bounds the kernel and how it is laid out.

``spmv_pull`` computes, for ``A`` of shape (m, n) and ``x`` of length n::

    out[i] = init (+) fold_(+) { mul(A[i,j], x[j]) : j stored in row i, x_valid[j] }
    has[i] = row_sel[i] and at least one such product
    out[i] = init where not has[i]

``swap=True`` computes ``mul(x[j], A[i,j])`` instead (vxm's product order,
``spla_tpu/ops/spmv.py:575``); the kernel then runs FIRST as SECOND and
SECOND as FIRST, and the generic family swaps the operands of MINUS, DIV
and MINUS_POW2 (spla_tpu's ``_swapped_mul``).

The kernel takes what spla_tpu's Pallas SpMV takes (``pull_codes``): every
built-in mul; in f32 an add of PLUS, MIN or MAX (``_SCATTER_MONOIDS``,
``spla_tpu/pallas/spmv.py:573``), in i32 and u32 any add with an identity
(``_pallas_spmv_fn_int_native``, ``:1059``): PLUS, MULT, MIN, MAX, LOR,
BOR, BAND, BXOR.  Two kinds of instance serve it (``csrc/semiring.cuh``):
templated ones for the six muls PLUS, MULT, FIRST, SECOND, MIN, MAX with
PLUS, MIN or MAX in f32 and i32 (``csrc/spmv_pull.cu``), and the generic
family, whose mul is a kernel argument, for the rest
(``csrc/spmv_pull_generic.cu``; ``generic=True`` sends a templated request
there too, to hold the two against each other).

The kernel's launch is shaped by ``pull_plan``, built on the device from
``indptr`` at a matrix's first CUDA call, a fact of the indptr tensor
(``formats.derived``; a ``formats.split_rows`` part has its own): the rows
longer than ``HUB_LEN`` entries, cut into chunks of ``HUB_CHUNK`` entries
walked by a CTA each (``hub_chunks``, the cut kernels 4 and 5 share), and
the team size G of the other rows, the power of two from 2 to 32 nearest
above their mean length over ``ENTRIES_PER_LANE``.  Building it reads the
host once.  No argument or setting chooses any of it.

The value kernel's plan also reads ``cols`` (``pull_plan(A, budget)``, the
budget ``l2_budget``: ``L2_SHARE`` of the card's L2).  Where x's bytes pass
it and A has hub rows, the columns fall into S = ceil(x bytes / budget)
segments of equal width, and every hub row is cut where its sorted columns
cross a segment's edge (a binary search at plan time, none in the kernel).
The pieces are launched segment by segment, so the hub CTAs in flight
gather from one window of x that L2 holds: a row of more than
``HUB_CHUNK`` entries in CTA chunks cut at the edges too, the other hub
rows a warp a piece, a CTA's warps on the pieces of one segment.  Each row
still folds its pieces in column order.  With one segment the plan is the
structural kernel's.

A CUDA call that passes ``x_valid`` first packs it into the plan's bitmap
(``pack_valid_bits``: bit ``j & 31`` of int32 word ``j >> 5``), which the
kernel reads in place of the bytes: n/8 bytes stay in L2 where n do not,
and x is gathered only where the bit is set.  The plain versions read the
bytes as before.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..containers import CsrMatrix
from ..formats import derived
from ..op import KernelCode
from ..utils.bits import gather, where
from ..utils.segments import segment_fold
from . import LAUNCHES
from .build import check, load_library

__all__ = [
    "DTYPE_CODES",
    "PULL_ADDS",
    "INT_ADDS",
    "TEMPLATED_MULS",
    "semiring_codes",
    "templated",
    "HUB_LEN",
    "HUB_CHUNK",
    "PullPlan",
    "pull_plan",
    "hub_chunks",
    "l2_budget",
    "team_size",
    "pull_codes",
    "pack_valid_bits",
    "pack_valid_bits_plain",
    "spmv_pull",
    "spmv_pull_plain",
    "spmv_pull_structural",
    "spmv_pull_structural_plain",
]

# kept equal to ``enum DtypeCode`` in csrc/semiring.cuh
DTYPE_CODES = {torch.float32: 0, torch.int32: 1, torch.uint32: 2}
_TEMPLATED_DTYPES = frozenset({0, 1})
# the adds of f32 requests, and of the templated instances
PULL_ADDS = frozenset({KernelCode.PLUS, KernelCode.MIN, KernelCode.MAX})
# the adds of i32 and u32 requests: every built-in add with an identity
INT_ADDS = PULL_ADDS | {KernelCode.MULT, KernelCode.LOR, KernelCode.BOR, KernelCode.BAND, KernelCode.BXOR}
TEMPLATED_MULS = frozenset({KernelCode.PLUS, KernelCode.MULT, KernelCode.FIRST, KernelCode.SECOND,
                            KernelCode.MIN, KernelCode.MAX})
_BITWISE = frozenset({KernelCode.BOR, KernelCode.BAND, KernelCode.BXOR})  # integer muls only
_SWAPPED = {KernelCode.FIRST: KernelCode.SECOND, KernelCode.SECOND: KernelCode.FIRST}
_ORDERED = frozenset({KernelCode.MINUS, KernelCode.DIV, KernelCode.MINUS_POW2})  # swapped at run time

HUB_LEN = 256  # a row of more entries is a hub row, walked by CTAs
HUB_CHUNK = 4096  # entries of a hub row a CTA walks
ENTRIES_PER_LANE = 2  # a lane's share of a row of the mean length
MAX_TEAM = 32  # a warp
WARPS_PER_CTA = 8  # kThreads / 32: the pieces of one segment a CTA of the value kernel takes
X_BYTES = 4  # an element of x: every instance is 32-bit
L2_SHARE = 0.5  # of the card's L2, the bytes of x a segment holds (PERF.md, kernel 1 at kron s25)


@dataclass(frozen=True)
class PullPlan:
    """Kernel 1's launch shape for one ``indptr`` (and, cut into segments,
    ``cols``), on its device: the hub rows (longer than ``HUB_LEN``) in
    order; the CTA chunks, chunk b walking entries ``[chunk_c0[b],
    chunk_c1[b])`` of row ``chunk_row[b]``, hub ``chunk_hub[b]`` of the rows
    cut into them, whose first chunk is ``chunk_first``; and ``team`` the
    lanes G of a team walking each other row.  With one segment every hub
    row is cut into ``HUB_CHUNK``-entry chunks, launched in order.  With
    ``segments`` S > 1 the rows of more than ``HUB_CHUNK`` entries are cut
    at the segments' edges too, and the others, ``short_rows``, into S
    pieces, piece s of short hub j ending at ``cuts[j * (S - 1) + s]``
    (its row's end for the last); ``items`` is the launch order, item k
    chunk ``items[k]`` where it is not negative, else the pieces of segment
    s of short hubs 8 c to 8 c + 7, a warp each, with ``-1 - items[k] = c S
    + s``.  Where a row has several chunks or pieces, ``part``/``part_any``
    hold their folds during a launch (the chunks', then S a short hub's)
    and ``done`` counts each row's finished ones (the chunked rows', then
    the short hubs'); the kernel leaves it zero.  ``valid_bits`` holds a
    masked call's ``x_valid`` packed (a word a 32 columns).  So launches on
    one matrix follow one another on a stream."""

    hub_rows: torch.Tensor  # int32 [nhub]
    chunk_row: torch.Tensor  # int32 [nchunks]
    chunk_c0: torch.Tensor  # int32 [nchunks]
    chunk_c1: torch.Tensor  # int32 [nchunks]
    chunk_hub: torch.Tensor  # int32 [nchunks]
    chunk_first: torch.Tensor  # int32 [rows cut into chunks + 1]
    nhub: int
    nchunks: int
    team: int
    part: torch.Tensor | None = None  # 32-bit words: a chunk's or piece's fold, f32 or i32
    part_any: torch.Tensor | None = None  # uint8
    done: torch.Tensor | None = None  # int32, a row cut into chunks or pieces
    valid_bits: torch.Tensor | None = None  # int32 [ceil(n / 32)]
    segments: int = 1
    items: torch.Tensor | None = None  # int32 [nitems]
    short_rows: torch.Tensor | None = None  # int32 [nshort]
    cuts: torch.Tensor | None = None  # int32 [nshort * (segments - 1)]

    @property
    def nitems(self) -> int:
        return self.nchunks if self.items is None else self.items.numel()


def team_size(walked: int, rows: int) -> int:
    """G for ``rows`` rows holding ``walked`` entries: the least power of two
    from 2 to ``MAX_TEAM`` at or above their mean length over
    ``ENTRIES_PER_LANE``."""
    want = walked / max(rows, 1) / ENTRIES_PER_LANE
    g = 2
    while g < MAX_TEAM and g < want:
        g *= 2
    return g


def pull_plan(A: CsrMatrix, budget: int | None = None) -> PullPlan:
    """The plan of A's ``indptr``, built on its device, a fact of the indptr
    tensor; the hub and chunk counts and the other rows' entry count are
    read on the host once, at the first build.  With ``budget``, the bytes
    of x a segment may hold (``l2_budget`` in a launch), the plan cut into
    segments, a fact of indptr and cols (its counts read in two host reads):
    the plain plan itself where x fits one segment or A has no hub row."""
    if budget is None:
        return derived(pull_plan, (A.indptr,), lambda: _pull_plan(A))
    return derived(pull_plan, (A.indptr, A.cols), lambda: _segmented_plan(A, budget), (budget, A.shape[1]))


@functools.cache
def l2_budget(device) -> int:
    """The value kernel's budget on a card: ``L2_SHARE`` of its L2."""
    return int(torch.cuda.get_device_properties(device).L2_cache_size * L2_SHARE)


def _pull_plan(A: CsrMatrix) -> PullPlan:
    ip = A.indptr.long()
    lens = ip[1:] - ip[:-1]
    cut, (nhub, nchunks, walked) = hub_chunks(ip[:-1], lens, HUB_LEN, HUB_CHUNK,
                                              torch.where(lens > HUB_LEN, 0, lens).sum())
    scratch = hub_scratch(nchunks, nhub, ip.device) if nchunks > nhub else {}
    bits = torch.empty(_words(A.shape[1]), dtype=torch.int32, device=ip.device)
    return PullPlan(*(t.to(torch.int32) for t in cut), nhub, nchunks, team_size(walked, A.shape[0] - nhub),
                    **scratch, valid_bits=bits)


def _segmented_plan(A: CsrMatrix, budget: int) -> PullPlan:
    segments = -(-A.shape[1] * X_BYTES // budget)
    if segments < 2:
        return pull_plan(A)
    ip = A.indptr.long()
    lens = ip[1:] - ip[:-1]
    hub_rows = torch.nonzero(lens > HUB_LEN).flatten()
    if hub_rows.numel() == 0:
        return pull_plan(A)
    device = ip.device
    hub_lens = lens[hub_rows]
    # each hub row's S + 1 edges: its start, where its columns reach each inner segment's first, its end
    width = -(-A.shape[1] // segments)
    first = ip[hub_rows]
    edges = torch.cat([first[:, None],
                       _lower_bound(A.cols, first, first + hub_lens,
                                    torch.arange(1, segments, device=device) * width, A.cols.numel().bit_length()),
                       (first + hub_lens)[:, None]], 1)
    long = hub_lens > HUB_CHUNK
    # the long rows' pieces (S a row, in column order) cut into CTA chunks
    ledges = edges[long]
    (_, chunk_piece, chunk_c0, chunk_c1, _, _), (_, nchunks, walked) = hub_chunks(
        ledges[:, :-1].flatten(), (ledges[:, 1:] - ledges[:, :-1]).flatten(), 0, HUB_CHUNK,
        lens.sum() - hub_lens.sum())
    chunk_hub = torch.div(chunk_piece, segments, rounding_mode="floor")
    nlong = ledges.shape[0]
    chunk_first = torch.zeros(nlong + 1, dtype=torch.long, device=device)
    torch.cumsum(torch.bincount(chunk_hub, minlength=nlong), 0, out=chunk_first[1:])
    short_rows = hub_rows[~long]
    nshort = short_rows.numel()
    # the launch order: segment by segment, its CTA chunks, then its short pieces 8 hubs an item
    blocks = -(-nshort // WARPS_PER_CTA)
    seg = torch.arange(segments, device=device)
    pieces = -1 - (torch.arange(blocks, device=device)[:, None] * segments + seg).flatten()
    order = torch.cat([chunk_piece % segments * 2, seg.repeat(blocks) * 2 + 1]).argsort(stable=True)
    items = torch.cat([torch.arange(nchunks, device=device), pieces])[order]
    i32 = [t.to(torch.int32) for t in (hub_rows, hub_rows[long][chunk_hub], chunk_c0, chunk_c1, chunk_hub,
                                       chunk_first, items, short_rows, edges[~long, 1:-1].flatten())]
    return PullPlan(*i32[:6], hub_rows.numel(), nchunks, team_size(walked, A.shape[0] - hub_rows.numel()),
                    **hub_scratch(nchunks + nshort * segments, nlong + nshort, device),
                    valid_bits=torch.empty(_words(A.shape[1]), dtype=torch.int32, device=device),
                    segments=segments, items=i32[6], short_rows=i32[7], cuts=i32[8])


def _lower_bound(cols, lo, hi, values, steps: int):
    """For each row r and value v: the first entry k in ``[lo[r], hi[r])``
    with ``cols[k] >= v`` (``hi[r]`` if none), by ``steps`` halvings, as
    many as the longest range has bits (int64 [rows, values]).  On sorted
    columns the edges of the pieces; on any columns they still rise along a
    row, so the pieces still hold each entry once."""
    lo = lo[:, None].expand(-1, values.numel()).clone()
    hi = hi[:, None].expand(-1, values.numel()).clone()
    for _ in range(steps + 1):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        live = lo < hi
        right = live & (cols[torch.where(live, mid, 0)] < values)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(live & ~right, mid, hi)
    return lo


def hub_chunks(starts, lens, hub_len: int, chunk: int, *also):
    """The cut of the items longer than ``hub_len`` entries (kernel 1's rows;
    kernels 4 and 5's mask entries, each over its row of B) into chunks of
    ``chunk`` entries, a CTA each.  Item i holds entries ``[starts[i],
    starts[i] + lens[i])`` (int64 tensors).  Returns ``(cut, counts)``: the
    int64 tensors ``(hubs, chunk_item, chunk_c0, chunk_c1, chunk_hub,
    chunk_first)``, the hub items in order, chunk b walking entries
    ``[chunk_c0[b], chunk_c1[b])`` of item ``chunk_item[b]``, hub
    ``chunk_hub[b]``, and hub h's first chunk ``chunk_first[h]``; and the
    ints ``(nhub, nchunks, *also)``, the 0-d tensors ``also`` read with the
    counts in the one host read."""
    device = lens.device
    hub = lens > hub_len
    chunks = torch.where(hub, torch.div(lens + chunk - 1, chunk, rounding_mode="floor"), 0)
    nhub, nchunks, *rest = (int(v) for v in torch.stack([hub.sum(), chunks.sum(), *also]).tolist())
    # each hub item's rank among the hub items; the others go to slot nhub, dropped
    slot = torch.where(hub, torch.cumsum(hub, 0) - 1, nhub)
    items = torch.empty(nhub + 1, dtype=torch.long, device=device)
    items.scatter_(0, slot, torch.arange(lens.shape[0], device=device))
    per_hub = chunks[items[:nhub]]
    chunk_first = torch.zeros(nhub + 1, dtype=torch.long, device=device)
    torch.cumsum(per_hub, 0, out=chunk_first[1:])
    chunk_hub = torch.repeat_interleave(torch.arange(nhub, device=device), per_hub, output_size=nchunks)
    chunk_item = items[chunk_hub]
    first = starts[chunk_item]
    chunk_c0 = first + (torch.arange(nchunks, device=device) - chunk_first[chunk_hub]) * chunk
    chunk_c1 = torch.minimum(chunk_c0 + chunk, first + lens[chunk_item])
    return (items[:nhub], chunk_item, chunk_c0, chunk_c1, chunk_hub, chunk_first), (nhub, nchunks, *rest)


def hub_scratch(nchunks: int, nhub: int, device) -> dict:
    """What the chunks of rows cut over several CTAs fold through (kernels
    1 and 7, ``csrc/semiring.cuh`` ``fold_chunks``): ``part``, a 32-bit word
    a chunk for its fold; ``part_any``, a byte a chunk for whether it folded
    anything; ``done``, a counter a row, zero between launches."""
    return {"part": torch.empty(nchunks, dtype=torch.int32, device=device),
            "part_any": torch.empty(nchunks, dtype=torch.uint8, device=device),
            "done": torch.zeros(nhub, dtype=torch.int32, device=device)}


def _words(n: int) -> int:
    return (n + 31) // 32


def pack_valid_bits_plain(x_valid):
    """Plain version of the pack: bool [n] to int32 [ceil(n / 32)], bit
    ``j & 31`` of word ``j >> 5`` set where ``x_valid[j]``, 0 past n."""
    n, device = x_valid.shape[0], x_valid.device
    padded = torch.zeros(_words(n) * 32, dtype=torch.int64, device=device)
    padded[:n] = x_valid
    w = (padded.view(-1, 32) << torch.arange(32, device=device)).sum(1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def pack_valid_bits(x_valid, out=None):
    """``x_valid`` packed as ``pack_valid_bits_plain`` does, into ``out`` if
    given (a contiguous int32 [ceil(n / 32)] tensor): the plain version for
    a CPU tensor, one launch of the pack kernel (``csrc/spmv_pull.cu``) for
    a CUDA one."""
    what = "pack_valid_bits"
    _mask(x_valid, what, "x_valid")
    words = _words(x_valid.shape[0])
    if out is not None and (out.shape != (words,) or out.dtype != torch.int32 or out.device != x_valid.device
                            or not out.is_contiguous()):
        raise ValueError(f"{what}: out must be a contiguous int32 [{words}] tensor on {x_valid.device}")
    if x_valid.device.type == "cpu":
        return _into(out, pack_valid_bits_plain(x_valid))
    if x_valid.dim() != 1 or not x_valid.is_contiguous():
        raise ValueError(f"{what}: x_valid must be a contiguous 1-d tensor")
    bits = torch.empty(words, dtype=torch.int32, device=x_valid.device) if out is None else out
    _launch_pack(x_valid, bits)
    return bits


def _launch_pack(x_valid, bits) -> None:
    check(load_library().spla_pack_valid_bits(x_valid.shape[0], x_valid.data_ptr(), bits.data_ptr(),
                                              torch.cuda.current_stream(x_valid.device).cuda_stream),
          "pack_valid_bits")
    LAUNCHES["valid_bits"] += 1


def _plan_bits(plan: PullPlan, x_valid):
    """The words a masked launch packs x_valid into (``_launch_pack``, just
    before the kernel), or None without a mask: the plan's, or words of its
    own for a matrix of other columns than the plan's first (an indptr
    shared by two shapes)."""
    if x_valid is None:
        return None
    words = _words(x_valid.shape[0])
    if plan.valid_bits.numel() == words:
        return plan.valid_bits
    return torch.empty(words, dtype=torch.int32, device=x_valid.device)


def _plan_args(plan: PullPlan):
    """The plan's leading C arguments: log2 G, HUB_LEN, the counts of rows
    cut into chunks and of chunks, and the chunk arrays (the value kernel's
    segments and scratch follow)."""
    return (plan.team.bit_length() - 1, HUB_LEN, plan.chunk_first.numel() - 1, plan.nchunks,
            *(t.data_ptr() for t in (plan.chunk_row, plan.chunk_c0, plan.chunk_c1, plan.chunk_hub,
                                     plan.chunk_first)))


def _segment_args(plan: PullPlan):
    """The value kernel's C arguments after ``_plan_args``: S, the item and
    short hub counts, the launch order, the short hubs and their cuts."""
    short = 0 if plan.short_rows is None else plan.short_rows.numel()
    return (plan.segments, plan.nitems, short, _ptr(plan.items), _ptr(plan.short_rows), _ptr(plan.cuts))


def semiring_codes(op_mul, op_add, dtype, int_adds=INT_ADDS):
    """``(mul, add, dtype)`` codes of a built-in mul in ``dtype`` (the bitwise
    ones in i32 and u32 only) with an add of ``PULL_ADDS`` (f32) or
    ``int_adds`` (i32, u32), else None.  The gates of kernels 1, 5 and 9
    narrow it further."""
    mul = getattr(op_mul, "kernel_code", None)
    add = getattr(op_add, "kernel_code", None)
    if mul is None or dtype not in DTYPE_CODES:
        return None
    if dtype.is_floating_point:
        if add not in PULL_ADDS or mul in _BITWISE:
            return None
    elif add not in int_adds:
        return None
    return int(mul), int(add), DTYPE_CODES[dtype]


def templated(mul, add, dtype) -> bool:
    """Whether the codes have a templated instance of kernel 1 (the generic
    family serves the others); kernel 7 has the f32 ones, and a family of its own."""
    return mul in TEMPLATED_MULS and add in PULL_ADDS and dtype in _TEMPLATED_DTYPES


def pull_codes(op_mul, op_add, dtype, swap=False):
    """``(mul, add, dtype)`` kernel codes when kernel 1 covers the request,
    else None: spla_tpu's Pallas SpMV gate (module docstring).  With
    ``swap`` FIRST and SECOND trade places."""
    codes = semiring_codes(op_mul, op_add, dtype)
    if codes is None:
        return None
    mul, add, dt = codes
    return (int(_SWAPPED.get(mul, mul)) if swap else mul), add, dt


def _on_cpu(*tensors) -> bool:
    return all(t is None or t.device.type == "cpu" for t in tensors)


def _require_cuda(what, A: CsrMatrix, tensors: dict, lengths: dict) -> None:
    """Raise unless every tensor lies on A's CUDA device, is contiguous and
    has its expected length; the CSR index arrays must be int32."""
    device = A.values.device
    if device.type != "cuda":
        raise ValueError(f"{what}: needs CUDA tensors, got {device}")
    if A.indptr.dtype != torch.int32 or A.cols.dtype != torch.int32:
        raise TypeError(f"{what}: CSR indices must be int32")
    if A.indptr.shape != (A.shape[0] + 1,):
        raise ValueError(f"{what}: indptr has shape {tuple(A.indptr.shape)}, want ({A.shape[0] + 1},)")
    for name, t in {"indptr": A.indptr, "cols": A.cols, "values": A.values, **tensors}.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, the matrix on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if name in lengths and t.shape != (lengths[name],):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, want ({lengths[name]},)")


def _mask(t, what, name):
    if t is not None and t.dtype != torch.bool:
        raise TypeError(f"{what}: {name} must be a bool tensor, got {t.dtype}")
    return t


def _ptr(t):
    return None if t is None else t.data_ptr()


def spmv_pull_plain(A: CsrMatrix, x, op_mul, op_add, init, x_valid=None, row_sel=None, swap=False):
    """Plain PyTorch version (gather + segment fold) for any semiring; the
    reference the kernel is held against.  Returns ``(out, has)``."""
    m, n = A.shape
    init = torch.as_tensor(init, dtype=A.values.dtype, device=A.values.device)
    cols = A.cols.long().clamp(0, max(n - 1, 0))
    xg = gather(x, cols)
    valid = A.valid_mask()
    if x_valid is not None:
        valid = valid & x_valid[cols]
    prod = op_mul(xg, A.values) if swap else op_mul(A.values, xg)
    out, has = segment_fold(prod, A.row_ids, valid, m, op_add, init, sorted_ids=True)
    if row_sel is not None:
        out = where(row_sel, out, init)
        has = has & row_sel
    return out, has


def spmv_pull(A: CsrMatrix, x, op_mul, op_add, init, x_valid=None, row_sel=None,
              want_has=False, swap=False, out=None, generic=False):
    """Kernel 1.  Returns ``(out, has)``; ``has`` is None unless ``want_has``.
    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    a request the kernel does not cover raises.  ``out``, if given, is the
    contiguous tensor the result is written to.  ``generic`` launches the
    generic family for a request a templated instance holds.

    Under ``staged.MANUAL_DMA`` every f32 request goes to kernel 7
    (``staged.spmv_pull_staged``, its plain version on CPU tensors; with
    ``generic``, its generic family) with the default slot count; i32 and
    u32 requests stay here."""
    from . import staged  # imported here: staged imports this module

    if staged.staged_codes(op_mul, op_add, A.values.dtype, swap) is not None:
        return staged.spmv_pull_staged(A, x, op_mul, op_add, init, x_valid, row_sel, want_has, swap,
                                       out=out, generic=generic)
    if _on_cpu(A.values, x, x_valid, row_sel):
        res, has = spmv_pull_plain(A, x, op_mul, op_add, init, x_valid, row_sel, swap)
        return _into(out, res), (has if want_has else None)
    what = "spmv_pull"
    codes = pull_codes(op_mul, op_add, A.values.dtype, swap)
    if codes is None:
        raise NotImplementedError(
            f"{what}: no kernel instance for mul={getattr(op_mul, 'key', op_mul)}, "
            f"add={getattr(op_add, 'key', op_add)}, dtype={A.values.dtype}")
    m, n = A.shape
    _require_cuda(what, A, {"x": x, "x_valid": _mask(x_valid, what, "x_valid"),
                            "row_sel": _mask(row_sel, what, "row_sel")},
                  {"x": n, "x_valid": n, "row_sel": m})
    if x.dtype != A.values.dtype:
        raise TypeError(f"{what}: x is {x.dtype}, the matrix {A.values.dtype}")
    init_t, init_bits = _init_arg(init, x)
    out = _out_arg(out, m, x, what)
    has = torch.empty(m, dtype=torch.bool, device=x.device) if want_has else None
    plan = pull_plan(A, l2_budget(x.device))
    bits = _plan_bits(plan, x_valid)
    args = (m, *_plan_args(plan), *_segment_args(plan), _ptr(plan.part), _ptr(plan.part_any), _ptr(plan.done),
            A.indptr.data_ptr(), A.cols.data_ptr(), A.values.data_ptr(), x.data_ptr(), _ptr(bits),
            _ptr(row_sel), _ptr(init_t), init_bits, out.data_ptr(), _ptr(has),
            torch.cuda.current_stream(x.device).cuda_stream)
    mul, add, dt = codes
    family = generic or not templated(*codes)
    entry = getattr(load_library(),
                    f"spla_spmv_pull{'_generic' if family else ''}{'' if bits is None else '_masked'}")
    lead = (mul, int(swap and mul in _ORDERED), add, dt) if family else codes
    if bits is not None:
        _launch_pack(x_valid, bits)
    check(entry(*lead, *args), what)
    LAUNCHES["spmv_pull_generic" if family else "spmv_pull"] += 1
    LAUNCHES["pull_segments"] += plan.segments
    return out, has


def _init_arg(init, x):
    """Kernel 1's init as ``(tensor, bits)``: a CUDA tensor goes by pointer
    (converted to x's dtype on the device), anything else by the 32 bits of
    its value in x's dtype.  Either way no call copies from the host, which
    would wait for the stream.  Kernel 7's wrapper passes its init so too."""
    if isinstance(init, torch.Tensor) and init.device.type == "cuda":
        return init.to(device=x.device, dtype=x.dtype).reshape(1), 0
    value = init.item() if isinstance(init, torch.Tensor) else init
    if x.dtype == torch.float32:
        return None, int(np.float32(value).view(np.uint32))
    return None, int(value) & 0xFFFFFFFF


def _out_arg(out, m, x, what):
    """The output of a CUDA launch: ``out`` if it is a contiguous [m] tensor
    of x's dtype on x's device (raises otherwise), or a new one."""
    if out is None:
        return torch.empty(m, dtype=x.dtype, device=x.device)
    if out.shape != (m,) or out.dtype != x.dtype or out.device != x.device or not out.is_contiguous():
        raise ValueError(f"{what}: out must be a contiguous {x.dtype} [{m}] tensor on {x.device}")
    return out


def _hits_arg(out, m, x_valid, nhub, what):
    """The bool output of a structural launch: ``out`` if given (raises
    unless it is a contiguous bool [m] tensor on x_valid's device) or a new
    one; zeroed where a hub row's chunks, which only ever write True, take
    their False from it (kernels 1 and 7)."""
    if out is None:
        return (torch.zeros if nhub else torch.empty)(m, dtype=torch.bool, device=x_valid.device)
    if out.shape != (m,) or out.dtype != torch.bool or out.device != x_valid.device \
            or not out.is_contiguous():
        raise ValueError(f"{what}: out must be a contiguous bool [{m}] tensor on {x_valid.device}")
    return out.zero_() if nhub else out


def _into(out, res):
    if out is None:
        return res
    out.copy_(res)
    return out


def spmv_pull_structural_plain(A: CsrMatrix, x_valid, row_sel=None):
    """Plain version of the structural variant: hits[i] = row_sel[i] and
    some stored (i, j) has x_valid[j]."""
    m, n = A.shape
    cols = A.cols.long().clamp(0, max(n - 1, 0))
    hit = A.valid_mask() & x_valid[cols]
    hits = torch.zeros(m + 1, dtype=torch.bool, device=x_valid.device)
    hits[torch.where(hit, A.row_ids.long(), m)] = True
    hits = hits[:m]
    return hits & row_sel if row_sel is not None else hits


def spmv_pull_structural(A: CsrMatrix, x_valid, row_sel=None, out=None):
    """Structural kernel 1 (reads no values); bool ``hits`` of length m,
    written to ``out`` if it is given (a contiguous bool [m] tensor).
    Under ``staged.MANUAL_DMA`` it is kernel 7's structural variant."""
    from . import staged

    if staged.MANUAL_DMA:
        return staged.spmv_pull_staged_structural(A, x_valid, row_sel, out=out)
    if _on_cpu(A.cols, x_valid, row_sel):
        return _into(out, spmv_pull_structural_plain(A, x_valid, row_sel))
    what = "spmv_pull_structural"
    m, n = A.shape
    _require_cuda(what, A, {"x_valid": _mask(x_valid, what, "x_valid"),
                            "row_sel": _mask(row_sel, what, "row_sel")},
                  {"x_valid": n, "row_sel": m})
    plan = pull_plan(A)
    hits = _hits_arg(out, m, x_valid, plan.nhub, what)
    bits = _plan_bits(plan, x_valid)
    args = (m, *_plan_args(plan), A.indptr.data_ptr(), A.cols.data_ptr(), bits.data_ptr(), _ptr(row_sel),
            hits.data_ptr(), torch.cuda.current_stream(x_valid.device).cuda_stream)
    _launch_pack(x_valid, bits)
    rc = load_library().spla_spmv_pull_structural(*args)
    check(rc, what)
    LAUNCHES["spmv_pull"] += 1
    LAUNCHES["pull_segments"] += 1
    return hits
