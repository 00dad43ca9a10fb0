"""Kernel 7: the staged-stream pull SpMV (``csrc/spmv_staged.cu``) and its plain version.

Replaces ``spla_tpu/pallas/spmv.py`` ``fused_cell_spmv_apply_manual``
(:2140), the TPU SpMV that keeps its stream in HBM and fills ``slots``
VMEM buffers by hand one batch ahead of the compute.  It computes kernel
1's function (``kernels/spmv.py``) for f32, with the same arguments and
results, plus ``slots``; the column and value streams go through a ring of
``slots`` shared-memory stages of ``stage`` entries (the CUDA source's
header says how).

The switch is the reference's (``spla_tpu/pallas/spmv.py:2136-2137``):
``SPLA_MANUAL_DMA=1`` sets ``MANUAL_DMA``, under which kernel 1's wrappers
send f32 requests here (``kernels/spmv.py``); ``SPLA_MANUAL_SLOTS`` sets the
default slot count, raised to at least 2 as at :2154.  Both are read from
the environment when this module is imported; ``MANUAL_DMA`` is read again
at every call, so code may set it.

Rows are grouped into row blocks by ``staged_plan``, which the kernel and
the plain version share.  With ``half = stage // 2``, a row starts a new
block when its first entry lies in another ``half``-entry bucket than the
previous row's, when it or the previous row holds more than ``half``
entries, or every ``stage`` rows.  A block of several rows therefore holds
fewer than ``stage`` entries and is one stage; a block of one row is cut
into stages of ``stage`` entries.  The plain version folds each (row,
stage) piece of the entry stream, then each row's pieces in stage order.
"""

from __future__ import annotations

import os

import torch

from ..containers import CsrMatrix
from ..formats import WeakIdCache
from ..utils.segments import segment_fold
from . import LAUNCHES
from .build import check, load_library
from .spmv import _mask, _on_cpu, _ptr, _require_cuda, pull_codes

__all__ = [
    "MANUAL_DMA",
    "MANUAL_DMA_SLOTS",
    "SLOT_COUNTS",
    "MAX_STAGE",
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

_PLANS = WeakIdCache()  # row blocks per indptr tensor and stage


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
    """Kernel codes when ``MANUAL_DMA`` routes this request to kernel 7 (f32,
    a covered semiring), else None."""
    if not MANUAL_DMA or dtype != torch.float32:
        return None
    return pull_codes(op_mul, op_add, dtype, swap)


def staged_plan(A: CsrMatrix, stage: int = MAX_STAGE):
    """``(block_rows, nblocks)``: int32 ``block_rows`` [nblocks + 1] on A's
    device, block b holding rows ``[block_rows[b], block_rows[b + 1])``.
    Built on the device from ``indptr`` and cached per indptr tensor; the
    block count is read on the host once."""
    _check_stage(stage)
    hit = _PLANS.get(A.indptr, (stage,))
    if hit is not None:
        return hit
    m = A.shape[0]
    ip = A.indptr.long()
    starts, lens = ip[:-1], ip[1:] - ip[:-1]
    half = stage // 2
    bucket = torch.div(starts, half, rounding_mode="floor")
    heavy = lens > half
    flag = heavy | (torch.arange(m, device=ip.device) % stage == 0)
    flag[1:] |= (bucket[1:] != bucket[:-1]) | heavy[:-1]
    rows = torch.nonzero(flag).flatten()
    block_rows = torch.cat([rows, torch.tensor([m], device=ip.device)]).to(torch.int32)
    plan = (block_rows, int(rows.numel()))
    _PLANS.put(A.indptr, plan, (stage,))
    return plan


def _pieces(A: CsrMatrix, stage: int):
    """The (row, stage) pieces of the entry stream: each entry's piece id
    (pieces numbered in stream order), each piece's row (``m`` for pieces
    of padding), and the piece count bound (the capacity)."""
    m = A.shape[0]
    block_rows, nblocks = staged_plan(A, stage)
    device = A.cols.device
    k = torch.arange(A.capacity, device=device)
    rows = A.row_ids.long()
    br = block_rows.long()
    blk = (torch.searchsorted(br, rows, right=True) - 1).clamp(0, max(nblocks - 1, 0))
    first = A.indptr.long()[br[:-1]] if nblocks else torch.zeros(1, dtype=torch.long, device=device)
    part = torch.div(k - first[blk], stage, rounding_mode="floor")
    heads = torch.ones(A.capacity, dtype=torch.bool, device=device)
    heads[1:] = (rows[1:] != rows[:-1]) | (part[1:] != part[:-1])
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
                     want_has=False, swap=False, slots=None, stage=MAX_STAGE):
    """Kernel 7.  Returns ``(out, has)``; ``has`` is None unless ``want_has``.
    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    a request it does not cover (not f32, or an uncovered semiring) raises."""
    slots = resolve_slots(slots)
    if _on_cpu(A.values, x, x_valid, row_sel):
        out, has = spmv_pull_staged_plain(A, x, op_mul, op_add, init, x_valid, row_sel, swap,
                                          slots, stage)
        return out, (has if want_has else None)
    what = "spmv_pull_staged"
    codes = pull_codes(op_mul, op_add, A.values.dtype, swap)
    if codes is None or A.values.dtype != torch.float32:
        raise NotImplementedError(
            f"{what}: no kernel instance for mul={getattr(op_mul, 'key', op_mul)}, "
            f"add={getattr(op_add, 'key', op_add)}, dtype={A.values.dtype}")
    m, n = A.shape
    _require_cuda(what, A, {"x": x, "x_valid": _mask(x_valid, what, "x_valid"),
                            "row_sel": _mask(row_sel, what, "row_sel")},
                  {"x": n, "x_valid": n, "row_sel": m})
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: x is {x.dtype}, the matrix float32")
    block_rows, nblocks = staged_plan(A, stage)
    init_t = torch.as_tensor(init, dtype=x.dtype, device=x.device).reshape(1)
    out = torch.empty(m, dtype=x.dtype, device=x.device)
    has = torch.empty(m, dtype=torch.bool, device=x.device) if want_has else None
    rc = load_library().spla_spmv_staged(
        codes[0], codes[1], slots, _check_stage(stage), nblocks, block_rows.data_ptr(),
        A.indptr.data_ptr(), A.cols.data_ptr(), A.values.data_ptr(), x.data_ptr(), _ptr(x_valid),
        _ptr(row_sel), init_t.data_ptr(), out.data_ptr(), _ptr(has),
        torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, what)
    LAUNCHES["spmv_pull_staged"] += 1
    return out, has


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


def spmv_pull_staged_structural(A: CsrMatrix, x_valid, row_sel=None, slots=None, stage=MAX_STAGE):
    """Structural kernel 7 (reads no values); bool ``hits`` of length m."""
    slots = resolve_slots(slots)
    if _on_cpu(A.cols, x_valid, row_sel):
        return spmv_pull_staged_structural_plain(A, x_valid, row_sel, slots, stage)
    what = "spmv_pull_staged_structural"
    m, n = A.shape
    _require_cuda(what, A, {"x_valid": _mask(x_valid, what, "x_valid"),
                            "row_sel": _mask(row_sel, what, "row_sel")},
                  {"x_valid": n, "row_sel": m})
    block_rows, nblocks = staged_plan(A, stage)
    hits = torch.empty(m, dtype=torch.bool, device=x_valid.device)
    rc = load_library().spla_spmv_staged_structural(
        slots, _check_stage(stage), nblocks, block_rows.data_ptr(), A.indptr.data_ptr(),
        A.cols.data_ptr(), x_valid.data_ptr(), _ptr(row_sel), hits.data_ptr(),
        torch.cuda.current_stream(x_valid.device).cuda_stream)
    check(rc, what)
    LAUNCHES["spmv_pull_staged"] += 1
    return hits
