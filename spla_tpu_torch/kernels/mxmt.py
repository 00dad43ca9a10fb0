"""Kernels 4 and 5: masked SpGEMM-T by sorted-row intersection
(``csrc/mxmt.cu``), each with its plain version.

For mask entries e = (i, j) = ``(mask.row_ids[e], mask.cols[e])`` with
``sel[e]`` (the caller's ``op_select(mask.values) & mask.valid_mask()``)::

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

Kernel 4 sums i32 products and hits in int64 and f32 products in float64;
its result is a 0-d tensor of that dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from ..containers import CsrMatrix
from ..utils.primitives import expand_schedule
from ..utils.search import bisect_steps, rowwise_find
from ..utils.segments import segment_fold
from . import LAUNCHES
from .build import check, load_library
from .spmv import DTYPE_CODES, PULL_ADDS, _mask, _on_cpu, _require_cuda

__all__ = [
    "PRODUCT_CHUNK",
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


def masked_codes(op_mul, op_add, dtype, struct_only=False):
    """``(mul, add, dtype)`` codes when kernel 5 covers the request, else None
    (mul is 0 and unused for ``struct_only``)."""
    add = getattr(op_add, "kernel_code", None)
    mul = 0 if struct_only else getattr(op_mul, "kernel_code", None)
    if mul is None or add not in PULL_ADDS or dtype not in DTYPE_CODES:
        return None
    return int(mul), int(add), DTYPE_CODES[dtype]


def reduce_codes(op_mul, dtype, struct_only=False):
    """``(mul, dtype)`` codes when kernel 4 covers the request, else None."""
    if struct_only:
        return 0, 0
    mul = getattr(op_mul, "kernel_code", None)
    if mul is None or dtype not in DTYPE_CODES:
        return None
    return int(mul), DTYPE_CODES[dtype]


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


def _ranges_and_steps(mask: CsrMatrix, A: CsrMatrix, B: CsrMatrix, products_cap):
    """The entry ranges to expand, each with its slot count, and the
    bisection steps that cover A's longest row (host reads)."""
    mcols = mask.cols.long().clamp(0, max(B.shape[0] - 1, 0))
    deg = torch.where(mask.valid_mask(), (B.indptr[1:] - B.indptr[:-1])[mcols].long(), 0)
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


def mxmt_masked_plain(mask: CsrMatrix, A: CsrMatrix, B: CsrMatrix, op_mul, op_add, init, sel,
                      struct_only=False, products_cap=None):
    """Plain PyTorch version of kernel 5 for any semiring: the expand / find /
    fold of ``spla_tpu/ops/spgemm.py`` ``_mxmT_numeric``.  Returns
    ``(out, has)`` of length ``mask.capacity``.  ``products_cap`` expands in
    one pass of that many slots (later slots drop, as in spla_tpu); by
    default the exact count, in ranges of at most PRODUCT_CHUNK."""
    init = torch.as_tensor(init, dtype=A.values.dtype, device=A.values.device)
    deg, ranges, steps = _ranges_and_steps(mask, A, B, products_cap)
    outs, hass = [], []
    for e0, e1, cap in ranges:
        src, a_pos, b_pos, valid = _intersect(mask, A, B, sel, deg, e0, e1, cap, steps)
        if struct_only:
            prod = torch.ones(valid.shape, dtype=init.dtype, device=init.device)
        else:
            prod = op_mul(A.values[a_pos], B.values[b_pos])
        out, has = segment_fold(prod, src, valid, e1 - e0, op_add, init, sorted_ids=True)
        outs.append(out)
        hass.append(has)
    return torch.cat(outs), torch.cat(hass)


def _acc_dtype(dtype, struct_only):
    return torch.float64 if dtype.is_floating_point and not struct_only else torch.int64


def mxmt_reduce_plain(mask: CsrMatrix, A: CsrMatrix, B: CsrMatrix, op_mul, sel,
                      struct_only=False):
    """Plain version of kernel 4: the same expansion, every product summed in
    int64 (integers, and hits when ``struct_only``) or float64 (floats)."""
    acc = _acc_dtype(A.values.dtype, struct_only)
    deg, ranges, steps = _ranges_and_steps(mask, A, B, None)
    total = torch.zeros((), dtype=acc, device=A.values.device)
    for e0, e1, cap in ranges:
        _, a_pos, b_pos, valid = _intersect(mask, A, B, sel, deg, e0, e1, cap, steps)
        if struct_only:
            total += valid.sum()
        else:
            prod = op_mul(A.values[a_pos], B.values[b_pos]).to(acc)
            total += torch.where(valid, prod, 0).sum()
    return total


# ---------------------------------------------------------------- kernels


def _check_operands(what, mask, A, B, sel, values):
    """Raise unless mask, A, B and sel lie on one CUDA device with int32
    indices, contiguous, in matching shapes (and, with ``values``, one value
    dtype)."""
    mcap = mask.capacity
    _require_cuda(what, A, {"mask.row_ids": mask.row_ids, "mask.cols": mask.cols,
                            "sel": _mask(sel, what, "sel")},
                  {"mask.row_ids": mcap, "mask.cols": mcap, "sel": mcap})
    _require_cuda(what, B, {}, {})
    if B.values.device != A.values.device:
        raise ValueError(f"{what}: B is on {B.values.device}, A on {A.values.device}")
    if mask.row_ids.dtype != torch.int32 or mask.cols.dtype != torch.int32:
        raise TypeError(f"{what}: mask indices must be int32")
    if mask.shape != (A.shape[0], B.shape[0]) or A.shape[1] != B.shape[1]:
        raise ValueError(f"{what}: shapes mask {mask.shape}, A {A.shape}, B {B.shape} "
                         "do not fit mask = A x B^T")
    if values and B.values.dtype != A.values.dtype:
        raise TypeError(f"{what}: B is {B.values.dtype}, A {A.values.dtype}")


def _operand_ptrs(mask, A, B, sel):
    return (mask.row_ids.data_ptr(), mask.cols.data_ptr(), sel.data_ptr(),
            A.indptr.data_ptr(), A.cols.data_ptr(), A.values.data_ptr(),
            B.indptr.data_ptr(), B.cols.data_ptr(), B.values.data_ptr())


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def mxmt_masked(mask: CsrMatrix, A: CsrMatrix, B: CsrMatrix, op_mul, op_add, init, sel,
                struct_only=False):
    """Kernel 5.  Returns ``(out, has)`` of length ``mask.capacity``.  CPU
    tensors take the plain version; CUDA tensors launch the kernel, and a
    request it does not cover raises."""
    if _on_cpu(A.values, B.values, mask.cols, sel):
        return mxmt_masked_plain(mask, A, B, op_mul, op_add, init, sel, struct_only)
    what = "mxmt_masked"
    codes = masked_codes(op_mul, op_add, A.values.dtype, struct_only)
    if codes is None:
        raise NotImplementedError(
            f"{what}: no kernel instance for mul={getattr(op_mul, 'key', op_mul)}, "
            f"add={getattr(op_add, 'key', op_add)}, dtype={A.values.dtype}")
    _check_operands(what, mask, A, B, sel, values=not struct_only)
    device = A.values.device
    init_t = torch.as_tensor(init, dtype=A.values.dtype, device=device).reshape(1)
    out = torch.empty(mask.capacity, dtype=A.values.dtype, device=device)
    has = torch.empty(mask.capacity, dtype=torch.bool, device=device)
    rc = load_library().spla_mxmt_masked(*codes, int(struct_only), mask.capacity,
                                         *_operand_ptrs(mask, A, B, sel), init_t.data_ptr(),
                                         out.data_ptr(), has.data_ptr(), _stream(out))
    check(rc, what)
    LAUNCHES["mxmt_masked"] += 1
    return out, has


def mxmt_reduce(mask: CsrMatrix, A: CsrMatrix, B: CsrMatrix, op_mul, sel, struct_only=False):
    """Kernel 4: the 0-d int64 (i32, hits) or float64 (f32) sum of all
    products.  CPU tensors take the plain version; CUDA tensors launch the
    kernel, and a request it does not cover raises."""
    if _on_cpu(A.values, B.values, mask.cols, sel):
        return mxmt_reduce_plain(mask, A, B, op_mul, sel, struct_only)
    what = "mxmt_reduce"
    codes = reduce_codes(op_mul, A.values.dtype, struct_only)
    if codes is None:
        raise NotImplementedError(
            f"{what}: no kernel instance for mul={getattr(op_mul, 'key', op_mul)}, "
            f"dtype={A.values.dtype}")
    _check_operands(what, mask, A, B, sel, values=not struct_only)
    total = torch.zeros(1, dtype=_acc_dtype(A.values.dtype, struct_only), device=A.values.device)
    rc = load_library().spla_mxmt_reduce(*codes, int(struct_only), mask.capacity,
                                         *_operand_ptrs(mask, A, B, sel), total.data_ptr(),
                                         _stream(total))
    check(rc, what)
    LAUNCHES["mxmt_reduce"] += 1
    return total.reshape(())
