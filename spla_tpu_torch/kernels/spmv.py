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
SECOND as FIRST.
"""

from __future__ import annotations

import torch

from ..containers import CsrMatrix
from ..op import KernelCode
from ..utils.segments import segment_fold
from . import LAUNCHES
from .build import check, load_library

__all__ = [
    "DTYPE_CODES",
    "pull_codes",
    "spmv_pull",
    "spmv_pull_plain",
    "spmv_pull_structural",
    "spmv_pull_structural_plain",
]

# kept equal to ``enum DtypeCode`` in csrc/semiring.cuh
DTYPE_CODES = {torch.float32: 0, torch.int32: 1}
PULL_ADDS = frozenset({KernelCode.PLUS, KernelCode.MIN, KernelCode.MAX})
_SWAPPED = {KernelCode.FIRST: KernelCode.SECOND, KernelCode.SECOND: KernelCode.FIRST}


def pull_codes(op_mul, op_add, dtype, swap=False):
    """``(mul, add, dtype)`` kernel codes when kernel 1 covers the request, else None."""
    mul = getattr(op_mul, "kernel_code", None)
    add = getattr(op_add, "kernel_code", None)
    if mul is None or add not in PULL_ADDS or dtype not in DTYPE_CODES:
        return None
    if swap:
        mul = _SWAPPED.get(mul, mul)
    return int(mul), int(add), DTYPE_CODES[dtype]


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
    xg = x[cols]
    valid = A.valid_mask()
    if x_valid is not None:
        valid = valid & x_valid[cols]
    prod = op_mul(xg, A.values) if swap else op_mul(A.values, xg)
    out, has = segment_fold(prod, A.row_ids, valid, m, op_add, init, sorted_ids=True)
    if row_sel is not None:
        out = torch.where(row_sel, out, init)
        has = has & row_sel
    return out, has


def spmv_pull(A: CsrMatrix, x, op_mul, op_add, init, x_valid=None, row_sel=None,
              want_has=False, swap=False, out=None):
    """Kernel 1.  Returns ``(out, has)``; ``has`` is None unless ``want_has``.
    CPU tensors take the plain version; CUDA tensors launch the kernel, and
    a request the kernel does not cover raises.  ``out``, if given, is the
    contiguous tensor the result is written to.

    Under ``staged.MANUAL_DMA`` an f32 request that the kernels cover goes
    to kernel 7 (``staged.spmv_pull_staged``, its plain version on CPU
    tensors) with the default slot count; other requests stay here."""
    from . import staged  # imported here: staged imports this module

    if staged.staged_codes(op_mul, op_add, A.values.dtype, swap) is not None:
        res, has = staged.spmv_pull_staged(A, x, op_mul, op_add, init, x_valid, row_sel, want_has,
                                           swap)
        return _into(out, res), has
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
    init_t = torch.as_tensor(init, dtype=x.dtype, device=x.device).reshape(1)
    if out is None:
        out = torch.empty(m, dtype=x.dtype, device=x.device)
    elif out.shape != (m,) or out.dtype != x.dtype or out.device != x.device or not out.is_contiguous():
        raise ValueError(f"{what}: out must be a contiguous {x.dtype} [{m}] tensor on {x.device}")
    has = torch.empty(m, dtype=torch.bool, device=x.device) if want_has else None
    lib = load_library()
    rc = lib.spla_spmv_pull(*codes, m, A.indptr.data_ptr(), A.cols.data_ptr(),
                            A.values.data_ptr(), x.data_ptr(), _ptr(x_valid), _ptr(row_sel),
                            init_t.data_ptr(), out.data_ptr(), _ptr(has),
                            torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, what)
    LAUNCHES["spmv_pull"] += 1
    return out, has


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


def spmv_pull_structural(A: CsrMatrix, x_valid, row_sel=None):
    """Structural kernel 1 (reads no values); bool ``hits`` of length m.
    Under ``staged.MANUAL_DMA`` it is kernel 7's structural variant."""
    from . import staged

    if staged.MANUAL_DMA:
        return staged.spmv_pull_staged_structural(A, x_valid, row_sel)
    if _on_cpu(A.cols, x_valid, row_sel):
        return spmv_pull_structural_plain(A, x_valid, row_sel)
    what = "spmv_pull_structural"
    m, n = A.shape
    _require_cuda(what, A, {"x_valid": _mask(x_valid, what, "x_valid"),
                            "row_sel": _mask(row_sel, what, "row_sel")},
                  {"x_valid": n, "row_sel": m})
    hits = torch.empty(m, dtype=torch.bool, device=x_valid.device)
    lib = load_library()
    rc = lib.spla_spmv_pull_structural(m, A.indptr.data_ptr(), A.cols.data_ptr(),
                                       x_valid.data_ptr(), _ptr(row_sel), hits.data_ptr(),
                                       torch.cuda.current_stream(x_valid.device).cuda_stream)
    check(rc, what)
    LAUNCHES["spmv_pull"] += 1
    return hits
