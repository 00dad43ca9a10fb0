"""Kernel 8: the phase probes of the pull SpMV (``csrc/spmv_probe.cu``) and their plain versions.

Replaces the Pallas probes of ``tools/probe_spmv.py`` ``main`` (pallas_call
:307, :385, :458, :527, :680, :738).  Each phase runs a part of kernel 1 as
first built (a warp per row; ``warp_row`` is that kernel whole, for
MULT/PLUS f32), a part of kernel 7's ring or its fold, or the entry stream with no rows
(``flat_*``: 16-byte loads, tiles of ``FLAT_TILE`` entries), and writes an output
that its plain version reproduces; the CUDA source's header lists the
phases.  ``spmv_probe(phase, A, x)`` returns ``(out_f, out_i)``, either None
where the phase writes no such output:

=============  ========================================  ========================
phase          out_f (f32)                               out_i (int32)
=============  ========================================  ========================
stream         per row: sum of values                    per row: XOR of cols
gather         per 8 rows (a CTA): sum of values * x     —
fullfix        per 8 rows: the same sum                  —
alu            per row: sum over lanes of the chain      —
xgather        per row: sum of x[h(k)]                   —
ring_copy      —                                         per unit: XOR of cols
                                                         and value bits
ring_alu       per unit: sum over threads of the chain   —
ring_copy_alu  per unit: as ring_alu                     per unit: XOR of cols
warp_row       per row: sum of values * x                —
flat_stream    per tile: sum of values                   per tile: XOR of cols
flat_gather    per tile: sum of values * x               —
ring_fold      per row: sum of values[k'] * x[cols[k']]  —
=============  ========================================  ========================

The chain is ``CHAIN`` pairs of a rounded ``s * 1.0001`` and a rounded
``+ 2``, applied once per entry slot a lane (or a ring thread) visits,
starting from the lane (thread) index; ``h(k)`` is ``(k * 2654435761 mod
2^32) mod n``.  Units are kernel 7's (``staged.staged_plan``).  Tile t
holds entries ``[FLAT_TILE * t, FLAT_TILE * (t + 1))`` below nnz.
``ring_fold`` is kernel 7's MULT/PLUS fold with the column and value words
of each stage taken from a slot that holds the matrix's first words: entry
k of a stage starting at entry s folds ``k' = s mod 4 + k - s`` in its
place.  The flat phases and ``ring_fold`` need 16-byte aligned ``cols`` and
``values``.

Phase ``mxmt_gather`` (``mxmt_gather(mask, B)``) is the floor of kernels 4
and 5 (``csrc/mxmt.cu``): their walk of the mask in windows and teams, and
their chunk CTAs for long B rows, with no probe of A.  For each stored mask
entry (i, j), ``out[e]`` (int32) is the XOR of B's row j: its columns, and
with ``values`` the 32 bits of its values; 0 past the stored entries.
With ``ordered`` it is the floor of kernel 4's ordered walk: the XOR of
the entries of B's row j whose column is below j, for the entries with
j < i, and 0 at the others.
"""

from __future__ import annotations

import torch

from ..containers import CsrMatrix
from . import LAUNCHES, PROBE_PHASES
from .build import check, load_library
from .mxmt import _launch
from .spmv import _on_cpu, _ptr, _require_cuda
from .staged import MAX_STAGE, _check_stage, _plan_args, resolve_slots, staged_plan

__all__ = ["PROBE_PHASES", "RING_PHASES", "FLAT_PHASES", "CHAIN", "FLAT_TILE", "spmv_probe",
           "spmv_probe_plain", "mxmt_gather", "mxmt_gather_plain"]

RING_PHASES = ("ring_copy", "ring_alu", "ring_copy_alu", "ring_fold")
FLAT_PHASES = ("flat_stream", "flat_gather")
CHAIN = 8  # kept equal to kChain in csrc/spmv_probe.cu
FLAT_TILE = 4096  # kept equal to kFlatTile in csrc/spmv_probe.cu
ROWS_PER_CTA = 8  # the warp-per-row CTA: 256 threads, a warp per row
RING_THREADS = 256
_MUL = 1.0001
_HASH = 2654435761


def _slot_words(stage):
    """Words of a ring slot; kept equal to slot_words in csrc/staged.cuh."""
    return (stage + 11) & ~3


def _aligned(A):
    return A.cols.data_ptr() % 16 == 0 and A.values.data_ptr() % 16 == 0


def _outputs(phase):
    """(writes out_f, writes out_i)."""
    return phase not in ("ring_copy",), phase in ("stream", "ring_copy", "ring_copy_alu", "flat_stream")


def _chain_table(max_count: int, seeds: torch.Tensor) -> torch.Tensor:
    """T[c, j] = the chain applied c times from ``seeds[j]``, in f32 with a
    rounding after each mul and each add, as the kernel's ``chain``."""
    mul = torch.tensor(_MUL, dtype=torch.float32, device=seeds.device)
    two = torch.tensor(2.0, dtype=torch.float32, device=seeds.device)
    rows = [seeds]
    s = seeds
    for _ in range(max_count):
        for _ in range(CHAIN):
            s = s * mul
            s = s + two
        rows.append(s)
    return torch.stack(rows)


def _xor_fold(words, seg, nseg):
    """Per segment, the XOR of the int32 ``words`` whose ``seg`` is below
    ``nseg`` (others are dropped), from per-bit parities."""
    w = words.long() & 0xFFFFFFFF
    out = torch.zeros(nseg + 1, dtype=torch.long, device=words.device)
    for b in range(32):
        cnt = torch.zeros(nseg + 1, dtype=torch.long, device=words.device)
        cnt.index_add_(0, seg, (w >> b) & 1)
        out |= (cnt & 1) << b
    out = out[:nseg]
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


def _counts(lens, width):
    """Entry slots each of ``width`` strided workers visits in ranges of
    ``lens`` entries: [len(lens), width]."""
    j = torch.arange(width, device=lens.device)
    return torch.div(lens[:, None] - j + (width - 1), width, rounding_mode="floor").clamp(min=0)


def _chains(counts, seeds):
    table = _chain_table(int(counts.max()) if counts.numel() else 0, seeds)
    return table[counts, torch.arange(seeds.numel(), device=seeds.device)].sum(1)


def spmv_probe_plain(phase: str, A: CsrMatrix, x, stage: int = MAX_STAGE):
    """Plain PyTorch version of a phase: ``(out_f, out_i)``."""
    if phase not in PROBE_PHASES:
        raise ValueError(f"unknown probe phase {phase!r}; phases: {PROBE_PHASES}")
    m, n = A.shape
    device = A.cols.device
    valid = A.valid_mask()
    rows = A.row_ids.long()
    k = torch.arange(A.capacity, device=device)
    ip = A.indptr.long()
    lens = ip[1:] - ip[:-1]
    if phase in RING_PHASES:
        plan = staged_plan(A, stage)
        if not plan.nunits:
            out = torch.zeros(0, device=device)
            return (torch.zeros(m, device=device), None) if phase == "ring_fold" else \
                (None if phase == "ring_copy" else out, None if phase == "ring_alu" else out.int())
        e0, e1 = plan.units[:, 2].long(), plan.units[:, 3].long()
        unit = (torch.searchsorted(e0, k, right=True) - 1).clamp(min=0)
        if phase == "ring_fold":
            start = e0[unit] + torch.div(k - e0[unit], stage, rounding_mode="floor") * stage
            src = (start % 4 + k - start).clamp(max=max(A.capacity - 1, 0))
            prod = A.values[src] * x[A.cols[src].long().clamp(0, max(n - 1, 0))]
            seg = torch.where(valid, rows, m)
            return torch.zeros(m + 1, dtype=torch.float32, device=device).index_add_(0, seg, prod)[:m], None
        seg = torch.where(valid, unit, plan.nunits)
        out_f = out_i = None
        if phase != "ring_copy":
            ulen = e1 - e0
            parts = torch.div(ulen + stage - 1, stage, rounding_mode="floor").clamp(min=1)
            last = ulen - (parts - 1) * stage
            full = _counts(torch.full_like(ulen, stage), RING_THREADS) * (parts - 1)[:, None]
            counts = full + _counts(last, RING_THREADS)
            out_f = _chains(counts, torch.arange(RING_THREADS, device=device, dtype=torch.float32))
        if phase != "ring_alu":
            words = A.cols if phase == "ring_copy_alu" else A.cols ^ A.values.view(torch.int32)
            out_i = _xor_fold(words, seg, plan.nunits)
        return out_f, out_i
    if phase in FLAT_PHASES:
        tiles = -(-A.capacity // FLAT_TILE)
        tseg = torch.where(valid, torch.div(k, FLAT_TILE, rounding_mode="floor"), tiles)
        if phase == "flat_stream":
            out = torch.zeros(tiles + 1, dtype=torch.float32, device=device).index_add_(0, tseg, A.values)
            return out[:tiles], _xor_fold(A.cols, tseg, tiles)
        prod = A.values * x[A.cols.long().clamp(0, max(n - 1, 0))]
        return torch.zeros(tiles + 1, dtype=torch.float32, device=device).index_add_(0, tseg, prod)[:tiles], None
    seg = torch.where(valid, rows, m)
    if phase == "stream":
        out_f = torch.zeros(m + 1, dtype=torch.float32, device=device).index_add_(0, seg, A.values)
        return out_f[:m], _xor_fold(A.cols, seg, m)
    if phase == "warp_row":
        prod = A.values * x[A.cols.long().clamp(0, max(n - 1, 0))]
        return torch.zeros(m + 1, dtype=torch.float32, device=device).index_add_(0, seg, prod)[:m], None
    if phase in ("gather", "fullfix"):
        ctas = (m + ROWS_PER_CTA - 1) // ROWS_PER_CTA
        cseg = torch.where(valid, torch.div(rows, ROWS_PER_CTA, rounding_mode="floor"), ctas)
        prod = A.values * x[A.cols.long().clamp(0, max(n - 1, 0))]
        out = torch.zeros(ctas + 1, dtype=torch.float32, device=device).index_add_(0, cseg, prod)
        return out[:ctas], None
    if phase == "alu":
        return _chains(_counts(lens, 32), torch.arange(32, device=device, dtype=torch.float32)), None
    idx = ((k * _HASH) & 0xFFFFFFFF) % max(n, 1)
    out = torch.zeros(m + 1, dtype=torch.float32, device=device).index_add_(0, seg, x[idx])
    return out[:m], None


def spmv_probe(phase: str, A: CsrMatrix, x, slots: int = 2, stage: int = MAX_STAGE):
    """Kernel 8's ``phase`` (``slots`` and ``stage`` are the ring phases'):
    ``(out_f, out_i)``.  CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise.  A probe of f32 ``A`` and ``x``."""
    if phase not in PROBE_PHASES:
        raise ValueError(f"unknown probe phase {phase!r}; phases: {PROBE_PHASES}")
    slots = resolve_slots(slots)
    if _on_cpu(A.values, x):
        return spmv_probe_plain(phase, A, x, stage)
    what = f"spmv_probe {phase}"
    m, n = A.shape
    _require_cuda(what, A, {"x": x}, {"x": n})
    if A.values.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"{what}: needs f32 values and x")
    device = x.device
    lib = load_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    writes_f, writes_i = _outputs(phase)
    if phase in RING_PHASES:
        plan = staged_plan(A, stage)
        resident = 0
        if phase == "ring_fold":
            if not _aligned(A):
                raise ValueError(f"{what}: needs 16-byte aligned cols and values")
            resident = min(_slot_words(stage), A.capacity)
        size = m if phase == "ring_fold" else plan.nunits
        out_f = torch.empty(size, dtype=torch.float32, device=device) if writes_f else None
        out_i = torch.empty(size, dtype=torch.int32, device=device) if writes_i else None
        rc = lib.spla_spmv_probe_ring(
            PROBE_PHASES.index(phase), slots, _check_stage(stage), *_plan_args(plan), _ptr(plan.part),
            _ptr(plan.part_any), _ptr(plan.done), A.indptr.data_ptr(), A.cols.data_ptr(),
            A.values.data_ptr(), x.data_ptr(), resident, _ptr(out_f), _ptr(out_i), stream)
    else:
        if phase in FLAT_PHASES:
            if not _aligned(A):
                raise ValueError(f"{what}: needs 16-byte aligned cols and values")
            size = -(-A.capacity // FLAT_TILE)
            n = A.capacity  # the C entry point's n is the capacity for these phases
        elif phase in ("gather", "fullfix"):
            size = (m + ROWS_PER_CTA - 1) // ROWS_PER_CTA
        else:
            size = m
        out_f = torch.empty(size, dtype=torch.float32, device=device)
        out_i = torch.empty(size, dtype=torch.int32, device=device) if writes_i else None
        rc = lib.spla_spmv_probe(
            PROBE_PHASES.index(phase), m, n, A.indptr.data_ptr(), A.cols.data_ptr(),
            A.values.data_ptr(), x.data_ptr(), out_f.data_ptr(), _ptr(out_i), stream)
    check(rc, what)
    LAUNCHES[f"spmv_probe_{phase}"] += 1
    return out_f, out_i


def mxmt_gather_plain(mask: CsrMatrix, B: CsrMatrix, values: bool = True, ordered: bool = False):
    """Plain version of ``mxmt_gather``: each B row's XOR (with ``ordered``,
    of its entries below the diagonal), then one per stored mask entry
    (with ``ordered``, per entry below the diagonal)."""
    mb = B.shape[0]
    words = B.cols ^ B.values.view(torch.int32) if values else B.cols
    walked = B.valid_mask() & (B.cols < B.row_ids) if ordered else B.valid_mask()
    row_xor = _xor_fold(words, torch.where(walked, B.row_ids.long(), mb), mb)
    j = mask.cols.long().clamp(0, max(mb - 1, 0))
    keep = mask.valid_mask() & (mask.cols < mask.row_ids) if ordered else mask.valid_mask()
    return torch.where(keep, row_xor[j], 0).to(torch.int32)


def mxmt_gather(mask: CsrMatrix, B: CsrMatrix, values: bool = True, ordered: bool = False):
    """The gather floor of kernels 4 and 5 (``mask`` against ``B``'s rows,
    B f32 or i32), or with ``ordered`` of kernel 4's ordered walk: int32
    ``out`` of length ``mask.capacity``.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if _on_cpu(B.values, mask.cols):
        return mxmt_gather_plain(mask, B, values, ordered)
    what = "mxmt_gather"
    _require_cuda(what, B, {"mask.indptr": mask.indptr, "mask.cols": mask.cols, "mask.row_ids": mask.row_ids},
                  {"mask.row_ids": mask.capacity})
    if any(t.dtype != torch.int32 for t in (mask.indptr, mask.cols, mask.row_ids)):
        raise TypeError(f"{what}: mask indices must be int32")
    if mask.indptr.shape != (mask.shape[0] + 1,) or mask.shape[1] != B.shape[0]:
        raise ValueError(f"{what}: mask {mask.shape} does not reach the rows of B {B.shape}")
    if B.values.element_size() != 4:
        raise TypeError(f"{what}: B's values must be 32-bit, got {B.values.dtype}")
    out = torch.zeros(mask.capacity, dtype=torch.int32, device=B.values.device)
    _launch(what, 2, (0, 0, 0, int(not values)), mask, B, B, None, out=out, ordered=ordered)
    return out
