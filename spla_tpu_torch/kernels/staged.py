"""Kernel 7: the staged-stream pull SpMV (``csrc/spmv_staged.cu``) and its plain version.

Replaces ``spla_tpu/pallas/spmv.py`` ``fused_cell_spmv_apply_manual``
(:2140), the TPU SpMV that keeps its stream in HBM and fills ``slots``
VMEM buffers by hand one batch ahead of the compute.  It computes kernel
1's function (``kernels/spmv.py``) for f32, with the same arguments and
results, plus ``slots``; the column and value streams go through a ring of
``slots`` shared-memory stages of ``stage`` entries (the CUDA header
``csrc/spmv_staged.cuh`` says how).  It takes every f32 request that
spla_tpu's manual kernel takes (``staged_codes``: the 12 muls of f32 x
PLUS, MIN, MAX), as kernel 1 does, through two kinds of instance: the
templated ones of kernel 1's six muls (``csrc/spmv_staged.cu``) and a
generic family whose mul is a kernel argument (``csrc/spmv_staged_generic.cu``;
``generic=True`` sends a templated request there too, to hold the two
against each other), counted in ``LAUNCHES["spmv_pull_staged_generic"]``.

Kernel 7 reads ``x_valid`` as bytes: kernel 1's bitmap (``spmv.pack_valid_bits``)
has not been brought here.

The switch is the reference's (``spla_tpu/pallas/spmv.py:2136-2137``):
``SPLA_MANUAL_DMA=1`` sets ``MANUAL_DMA``, under which kernel 1's wrappers
send f32 requests here (``kernels/spmv.py``); ``SPLA_MANUAL_SLOTS`` sets the
default slot count, raised to at least 2 as at :2154.  Both are read from
the environment when this module is imported; ``MANUAL_DMA`` is read again
at every call, so code may set it.

Work is cut into units by ``staged_plan``, which the kernel and the plain
version share.  With ``long = max(stage // 4, 1)``, a row of more than
``long`` entries is a long row; the other rows are packed into units of
several rows: a row starts a new unit when its first entry lies in another
bucket of ``stage - long`` entries than the previous row's, when it or the
previous row is long, or every ``BLOCK_ROWS`` rows, so a unit of several
rows holds fewer than ``stage`` entries (about ``stage - long``, fewer where
long rows cut it) and is one stage.  A long row is cut into chunks of
``CHUNK_STAGES`` stages, each chunk a unit; a row of several chunks is a
hub, whose chunks' folds the last of them to finish folds in chunk order.
The plain version folds each (row, stage) piece of the entry stream, then
each row's pieces in stage order.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from ..containers import CsrMatrix
from ..formats import derived
from ..utils.segments import segment_fold
from . import LAUNCHES
from .build import check, load_library
from .spmv import (_ORDERED, _hits_arg, _init_arg, _into, _mask, _on_cpu, _out_arg, _ptr, _require_cuda,
                   hub_scratch, pull_codes, templated)

__all__ = [
    "MANUAL_DMA",
    "MANUAL_DMA_SLOTS",
    "SLOT_COUNTS",
    "MAX_STAGE",
    "BLOCK_ROWS",
    "CHUNK_STAGES",
    "StagedPlan",
    "long_row_len",
    "staged_plan",
    "staged_codes",
    "spmv_pull_staged",
    "spmv_pull_staged_plain",
    "spmv_pull_staged_structural",
    "spmv_pull_staged_structural_plain",
]

MANUAL_DMA = os.environ.get("SPLA_MANUAL_DMA") == "1"
MANUAL_DMA_SLOTS = int(os.environ.get("SPLA_MANUAL_SLOTS", "2"))

SLOT_COUNTS = (2, 3, 4)  # the instances csrc/spmv_staged.cu compiles
# entries a stage holds, at most and by default; kept equal to kMaxStage in csrc/staged.cuh
MAX_STAGE = 1024
BLOCK_ROWS = 256  # rows of a unit of several rows, at most; kept equal to kBlockRows in csrc/staged.cuh
CHUNK_STAGES = 4  # stages of a long row's chunk, at most


@dataclass(frozen=True)
class StagedPlan:
    """Kernel 7's units for one ``indptr`` and stage, on its device: unit u
    holds rows ``[units[u, 0], units[u, 1])`` and entries ``[units[u, 2],
    units[u, 3])``, in stream order.  ``unit_hub[u]`` is the rank of u's row
    among the hubs (long rows of several chunks), else -1; ``hub_units[h]``
    is hub h's first unit and chunk count.  Where there are hubs,
    ``part``/``part_any`` hold the chunks' folds during a launch and
    ``done`` counts each hub's finished chunks; the kernel leaves it zero,
    so launches on one matrix follow one another on a stream."""

    units: torch.Tensor  # int32 [nunits, 4]
    unit_hub: torch.Tensor  # int32 [nunits]
    hub_units: torch.Tensor  # int32 [nhub, 2]
    nunits: int
    nhub: int
    stage: int
    part: torch.Tensor | None = None  # 32-bit words [nunits]: a chunk's fold
    part_any: torch.Tensor | None = None  # uint8 [nunits]
    done: torch.Tensor | None = None  # int32 [nhub]


def resolve_slots(slots) -> int:
    """``slots``, or ``MANUAL_DMA_SLOTS`` when None, raised to at least 2;
    raises unless the library holds that many."""
    s = max(int(MANUAL_DMA_SLOTS if slots is None else slots), 2)
    if s not in SLOT_COUNTS:
        raise ValueError(f"kernel 7 is compiled for {SLOT_COUNTS} slots, not {s}")
    return s


def _check_stage(stage: int) -> int:
    if not 2 <= stage <= MAX_STAGE:
        raise ValueError(f"kernel 7's stage holds 2 to {MAX_STAGE} entries, not {stage}")
    return stage


def staged_codes(op_mul, op_add, dtype, swap=False):
    """Kernel codes when ``MANUAL_DMA`` routes this request to kernel 7, else
    None: every f32 request kernel 1 covers (spla_tpu's manual kernel is f32
    only, ``spla_tpu/pallas/spmv.py:2064``); kernel 1 takes i32 and u32."""
    if not MANUAL_DMA:
        return None
    return _staged_codes(op_mul, op_add, dtype, swap)


def _staged_codes(op_mul, op_add, dtype, swap):
    return pull_codes(op_mul, op_add, dtype, swap) if dtype == torch.float32 else None


def long_row_len(stage: int) -> int:
    """A row of more entries than this is a long row: its own units.  A
    quarter of a stage: kernel 1's HUB_LEN at the default stage."""
    return max(stage // 4, 1)


def staged_plan(A: CsrMatrix, stage: int = MAX_STAGE) -> StagedPlan:
    """A's units at ``stage`` entries a stage (the module's docstring says
    how they are cut).  Built on the device from ``indptr``, a fact of the
    indptr tensor and the stage; the counts are read on the host once."""
    _check_stage(stage)
    return derived(staged_plan, (A.indptr,), lambda: _staged_plan(A, stage), (stage,))


def _staged_plan(A: CsrMatrix, stage: int) -> StagedPlan:
    m = A.shape[0]
    ip = A.indptr.long()
    dev = ip.device
    starts, lens = ip[:-1], ip[1:] - ip[:-1]
    long = lens > long_row_len(stage)
    bucket = torch.div(starts, stage - long_row_len(stage), rounding_mode="floor")
    r = torch.arange(m, device=dev)
    flag = long | (r == 0)
    flag[1:] |= (bucket[1:] != bucket[:-1]) | long[:-1]
    # and every BLOCK_ROWS rows from such a start
    flag |= (r - torch.cummax(torch.where(flag, r, 0), 0).values) % BLOCK_ROWS == 0
    chunk = CHUNK_STAGES * stage
    # units of the block each flagged row starts: a long row's chunks, else one
    chunks = torch.div(lens + chunk - 1, chunk, rounding_mode="floor")
    per_row = torch.where(flag, torch.where(long, chunks, 1), 0)
    nblocks, nunits, nhub = (int(v) for v in torch.stack(
        [flag.sum(), per_row.sum(), (per_row > 1).sum()]).tolist())
    first = torch.empty(nblocks + 1, dtype=torch.long, device=dev)
    first.scatter_(0, torch.where(flag, torch.cumsum(flag, 0) - 1, nblocks), torch.arange(m, device=dev))
    first[nblocks] = m
    count = per_row[first[:nblocks]]
    blk = torch.repeat_interleave(torch.arange(nblocks, device=dev), count, output_size=nunits)
    unit0 = torch.cumsum(count, 0) - count  # each block's first unit
    b0 = ip[first[blk]]
    e0 = b0 + (torch.arange(nunits, device=dev) - unit0[blk]) * chunk
    e1 = torch.minimum(e0 + chunk, ip[first[blk + 1]])
    units = torch.stack([first[blk], first[blk + 1], e0, e1], 1).to(torch.int32)
    hub = count > 1
    unit_hub = torch.where(hub, torch.cumsum(hub, 0) - 1, -1)[blk].to(torch.int32)
    hub_units = torch.stack([unit0[hub], count[hub]], 1).to(torch.int32).reshape(nhub, 2)
    scratch = hub_scratch(nunits, nhub, dev) if nhub else {}
    return StagedPlan(units, unit_hub, hub_units, nunits, nhub, stage, **scratch)


def _pieces(A: CsrMatrix, stage: int):
    """The (row, stage) pieces of the entry stream: each entry's piece id
    (pieces numbered in stream order), each piece's row (``m`` for pieces
    of padding), and the piece count bound (the capacity)."""
    m = A.shape[0]
    plan = staged_plan(A, stage)
    device = A.cols.device
    k = torch.arange(A.capacity, device=device)
    rows = A.row_ids.long()
    e0 = plan.units[:, 2].long()
    unit = (torch.searchsorted(e0, k, right=True) - 1).clamp(0, max(plan.nunits - 1, 0))
    first = e0[unit] if plan.nunits else torch.zeros_like(k)
    part = torch.div(k - first, stage, rounding_mode="floor")
    heads = torch.ones(A.capacity, dtype=torch.bool, device=device)
    heads[1:] = (rows[1:] != rows[:-1]) | (unit[1:] != unit[:-1]) | (part[1:] != part[:-1])
    piece = torch.cumsum(heads, 0) - 1
    piece_row = torch.full((A.capacity + 1,), m, dtype=torch.long, device=device)
    piece_row[piece] = rows
    return piece, piece_row[: A.capacity], A.capacity


def spmv_pull_staged_plain(A: CsrMatrix, x, op_mul, op_add, init, x_valid=None, row_sel=None,
                           swap=False, slots=None, stage=MAX_STAGE):
    """Plain PyTorch version: each (row, stage) piece of products folded,
    then each row's pieces in stage order, for any semiring whose add has
    an identity.  Returns ``(out, has)``."""
    resolve_slots(slots)
    m, n = A.shape
    if op_add.identity is None:
        raise ValueError(f"spmv_pull_staged: {op_add.key} has no identity to fold pieces from")
    init = torch.as_tensor(init, dtype=A.values.dtype, device=A.values.device)
    piece, piece_row, npieces = _pieces(A, stage)
    cols = A.cols.long().clamp(0, max(n - 1, 0))
    xg = x[cols]
    valid = A.valid_mask()
    if x_valid is not None:
        valid = valid & x_valid[cols]
    prod = op_mul(xg, A.values) if swap else op_mul(A.values, xg)
    partial, any_p = segment_fold(prod, piece, valid, npieces, op_add, op_add.identity)
    out, has = segment_fold(partial, piece_row, any_p, m, op_add, init)
    if row_sel is not None:
        out = torch.where(row_sel, out, init)
        has = has & row_sel
    return out, has


def spmv_pull_staged(A: CsrMatrix, x, op_mul, op_add, init, x_valid=None, row_sel=None,
                     want_has=False, swap=False, slots=None, stage=MAX_STAGE, out=None, generic=False):
    """Kernel 7.  Returns ``(out, has)``; ``has`` is None unless ``want_has``.
    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    a request it does not cover (not f32, or not one of the 36 f32
    semirings of ``staged_codes``) raises.
    ``out``, if given, is the contiguous tensor the result is written to
    (kernel 1's ``out``, which ``spmv_pull`` passes on under ``MANUAL_DMA``).
    ``init`` reaches the kernel as kernel 1's does, by value or by device
    pointer, so a call does not wait for the stream.  ``generic`` launches
    the generic family for a request a templated instance holds."""
    slots = resolve_slots(slots)
    if _on_cpu(A.values, x, x_valid, row_sel):
        res, has = spmv_pull_staged_plain(A, x, op_mul, op_add, init, x_valid, row_sel, swap,
                                          slots, stage)
        return _into(out, res), (has if want_has else None)
    what = "spmv_pull_staged"
    codes = _staged_codes(op_mul, op_add, A.values.dtype, swap)
    if codes is None:
        raise NotImplementedError(
            f"{what}: no kernel instance for mul={getattr(op_mul, 'key', op_mul)}, "
            f"add={getattr(op_add, 'key', op_add)}, dtype={A.values.dtype}")
    m, n = A.shape
    _require_cuda(what, A, {"x": x, "x_valid": _mask(x_valid, what, "x_valid"),
                            "row_sel": _mask(row_sel, what, "row_sel")},
                  {"x": n, "x_valid": n, "row_sel": m})
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: x is {x.dtype}, the matrix float32")
    out = _out_arg(out, m, x, what)
    plan = staged_plan(A, stage)
    init_t, init_bits = _init_arg(init, x)
    has = torch.empty(m, dtype=torch.bool, device=x.device) if want_has else None
    args = (slots, _check_stage(stage), *_plan_args(plan), _ptr(plan.part), _ptr(plan.part_any), _ptr(plan.done),
            A.indptr.data_ptr(), A.cols.data_ptr(), A.values.data_ptr(), x.data_ptr(), _ptr(x_valid),
            _ptr(row_sel), _ptr(init_t), init_bits, out.data_ptr(), _ptr(has),
            torch.cuda.current_stream(x.device).cuda_stream)
    mul, add, _ = codes
    if generic or not templated(*codes):
        rc, name = load_library().spla_spmv_staged_generic(mul, int(swap and mul in _ORDERED), add,
                                                           *args), "spmv_pull_staged_generic"
    else:
        rc, name = load_library().spla_spmv_staged(mul, add, *args), "spmv_pull_staged"
    check(rc, what)
    LAUNCHES[name] += 1
    return out, has


def _plan_args(plan: StagedPlan):
    """The plan's leading C arguments: the unit count, units, unit_hub and
    hub_units."""
    return plan.nunits, plan.units.data_ptr(), plan.unit_hub.data_ptr(), plan.hub_units.data_ptr()


def spmv_pull_staged_structural_plain(A: CsrMatrix, x_valid, row_sel=None, slots=None, stage=MAX_STAGE):
    """Plain version of the structural variant, piece by piece: hits[i] =
    row_sel[i] and some stored (i, j) has x_valid[j]."""
    resolve_slots(slots)
    m, n = A.shape
    piece, piece_row, npieces = _pieces(A, stage)
    cols = A.cols.long().clamp(0, max(n - 1, 0))
    hit = A.valid_mask() & x_valid[cols]
    piece_hit = torch.zeros(npieces + 1, dtype=torch.bool, device=x_valid.device)
    piece_hit[torch.where(hit, piece, npieces)] = True
    hits = torch.zeros(m + 1, dtype=torch.bool, device=x_valid.device)
    hits[torch.where(piece_hit[:npieces], piece_row, m)] = True
    hits = hits[:m]
    return hits & row_sel if row_sel is not None else hits


def spmv_pull_staged_structural(A: CsrMatrix, x_valid, row_sel=None, slots=None, stage=MAX_STAGE,
                                out=None):
    """Structural kernel 7 (reads no values); bool ``hits`` of length m,
    written to ``out`` if it is given."""
    slots = resolve_slots(slots)
    if _on_cpu(A.cols, x_valid, row_sel):
        return _into(out, spmv_pull_staged_structural_plain(A, x_valid, row_sel, slots, stage))
    what = "spmv_pull_staged_structural"
    m, n = A.shape
    _require_cuda(what, A, {"x_valid": _mask(x_valid, what, "x_valid"),
                            "row_sel": _mask(row_sel, what, "row_sel")},
                  {"x_valid": n, "row_sel": m})
    plan = staged_plan(A, stage)
    hits = _hits_arg(out, m, x_valid, plan.nhub, what)
    rc = load_library().spla_spmv_staged_structural(
        slots, _check_stage(stage), *_plan_args(plan)[:3], A.indptr.data_ptr(), A.cols.data_ptr(),
        x_valid.data_ptr(), _ptr(row_sel), hits.data_ptr(),
        torch.cuda.current_stream(x_valid.device).cuda_stream)
    check(rc, what)
    LAUNCHES["spmv_pull_staged"] += 1
    return hits
