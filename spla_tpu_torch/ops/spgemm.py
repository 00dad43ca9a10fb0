"""SpGEMM (counterpart of ``spla_tpu/ops/spgemm.py``): ``mxm`` and the
masked ``mxmT_masked``.

``mxm(A, B, ...)`` computes ``C = A (+).(x) B``: ``C[i, j] = init (+)
fold_(+) mul(A[i, p], B[p, j])`` over the p that row i of A and column j of
B share; results equal to ``init`` are not stored (reference
``cpu_mxm.hpp:109-113``).  For CUDA tensors a (mul, add, dtype) that kernel
9 covers launches it, unless ``products_cap`` or ``block_products`` asks
for the plain path's truncation or windows; everything else takes the plain
torch path (``kernels.spgemm.mxm_plain``).

``mxmT_masked(mask, A, B, ...)`` computes, for each stored mask entry
(i, j) that ``op_select`` keeps, ``R[i,j] = init (+) fold_(+) mul(A[i,k],
B[j,k])`` over the columns k that row i of A and row j of B share;
entries with no product, and entries equal to ``init``, are not stored
(reference exec_mxmT_masked, ``include/spla/exec.hpp:104-131``).  Rows of
A and B must be sorted by column, as the port's builders make them.

Dispatch is the static semiring gate of ``ops.spmv``: for CUDA tensors a
(mul, add, dtype) that kernel 5 (9 for ``mxm``) covers launches it;
anything else takes the plain torch path.  ``DISPATCH_STATS`` counts each.
Results are compacted on the device with no host read.
"""

from __future__ import annotations

import torch

from ..containers import CooMatrix, CsrMatrix
from ..formats import compact, coo_to_csr
from ..kernels import mxmt as K, spgemm as K9
from ..utils.bits import bits
from ..utils.segments import scalar_on
from .spmv import DISPATCH_STATS

__all__ = [
    "mxm",
    "count_mxm_products",
    "count_mxmT_products",
    "mxmT_masked",
    "mxmT_masked_plain",
    "mxmT_masked_reduce",
]


def _row_degrees(M: CsrMatrix) -> torch.Tensor:
    return M.indptr[1:] - M.indptr[:-1]


def count_mxm_products(A: CsrMatrix, B: CsrMatrix) -> int:
    """Exact product count of ``mxm(A, B)`` (the symbolic phase; one host read)."""
    nnz = int(A.nnz)
    return int(_row_degrees(B)[A.cols[:nnz].long()].sum())


def mxm(A: CsrMatrix, B: CsrMatrix, op_mul, op_add, init, products_cap: int | None = None,
        out_capacity: int | None = None, block_products: int | None = None,
        check_init_sparsify: bool = True) -> CsrMatrix:
    """``C = A (+).(x) B``, results equal to ``init`` not stored, rows sorted
    by column; result fill ``init``.  The signature of ``spla_tpu.ops.mxm``.

    ``products_cap`` keeps the first that many products in expansion order
    (A's entries in order, each over B's row) and ``block_products`` folds
    windows of about that many products; either takes the plain path, as
    spla_tpu routes an explicit cap to its XLA path.  ``check_init_sparsify``
    is accepted and has no effect: init-valued results are always dropped,
    on the device and with no host read (spla_tpu's opt-out skips the read
    its kernel path needs to find them).  The result's capacity is
    ``out_capacity``, or else the number of distinct (i, j) the products
    reach (spla_tpu's XLA path pads to ``products_cap``); with more entries
    than ``out_capacity`` the first ones in (row, column) order are stored
    and ``nnz`` is the capacity (spla_tpu reports the uncut count)."""
    init_t = scalar_on(init, A.values.dtype, A.values.device)
    if (A.values.device.type != "cuda" or products_cap is not None or block_products is not None
            or K9.mxm_codes(op_mul, op_add, A.values.dtype) is None):
        DISPATCH_STATS["mxm_torch"] += 1
        return K9.mxm_plain(A, B, op_mul, op_add, init_t, products_cap, out_capacity, block_products)
    DISPATCH_STATS["mxm_kernel"] += 1
    return K9.mxm(A, B, op_mul, op_add, init_t, out_capacity)


def count_mxmT_products(mask: CsrMatrix, B: CsrMatrix) -> int:
    """Exact product-slot count of ``mxmT_masked``: one per (mask entry,
    element of B's row) pair (one host read)."""
    nnz = int(mask.nnz)
    return int(_row_degrees(B)[mask.cols[:nnz].long()].sum())


def _selection(mask: CsrMatrix, op_select, struct_only: bool, kernel: bool = False):
    """The mask entries that take part: stored ones, kept by ``op_select``
    unless ``struct_only`` (then None: every stored entry).  The kernels
    read entries below ``mask.indptr[m]`` only, so theirs skips the
    stored-ness test."""
    if struct_only:
        return None
    keep = op_select(mask.values)
    return keep if kernel else keep & mask.valid_mask()


def _to_csr(mask: CsrMatrix, out, has, init_t, out_capacity) -> CsrMatrix:
    """CSR of the entries with ``has`` and a value other than ``init``, in
    mask order; at most ``out_capacity`` (default: the mask's capacity)."""
    m, n = mask.shape
    cap = out_capacity if out_capacity is not None else mask.capacity
    kept = compact(out, has & (bits(out) != bits(init_t)), cap, init_t)
    ok = kept.indices < mask.capacity
    idx = kept.indices.clamp(max=mask.capacity - 1).long()
    return coo_to_csr(CooMatrix(
        shape=(m, n),
        rows=torch.where(ok, mask.row_ids[idx], m).to(torch.int32),
        cols=torch.where(ok, mask.cols[idx], 0).to(torch.int32),
        values=kept.values,
        nnz=kept.nnz,
        fill=init_t,
    ))


def mxmT_masked_plain(mask: CsrMatrix, A: CsrMatrix, B: CsrMatrix, op_mul, op_add, op_select,
                      init, products_cap: int | None = None, out_capacity: int | None = None,
                      struct_only: bool = False) -> CsrMatrix:
    """The plain torch path for any semiring (kernel 5's plain version and
    the same compaction); ``products_cap`` as in spla_tpu: one expansion of
    that many slots, later ones dropped."""
    init_t = scalar_on(init, A.values.dtype, A.values.device)
    out, has = K.mxmt_masked_plain(mask, A, B, op_mul, op_add, init_t,
                                   _selection(mask, op_select, struct_only), struct_only,
                                   products_cap)
    return _to_csr(mask, out, has, init_t, out_capacity)


def mxmT_masked(mask: CsrMatrix, A: CsrMatrix, B: CsrMatrix, op_mul, op_add, op_select, init,
                products_cap: int | None = None, out_capacity: int | None = None,
                struct_only: bool = False) -> CsrMatrix:
    """``R = (A x Bᵀ) masked by mask``; see the module docstring.

    ``struct_only`` treats every stored value as 1 and every stored mask
    entry as selected (``op_select`` is not applied).  ``products_cap``
    sizes the plain path's expansion (default: the exact count); the
    kernel needs none.  With more kept entries than ``out_capacity``, the
    first ones are stored and ``nnz`` is the capacity (spla_tpu reports the
    uncut count)."""
    if (A.values.device.type != "cuda"
            or K.masked_codes(op_mul, op_add, A.values.dtype, struct_only) is None):
        DISPATCH_STATS["mxmT_torch"] += 1
        return mxmT_masked_plain(mask, A, B, op_mul, op_add, op_select, init, products_cap,
                                 out_capacity, struct_only)
    DISPATCH_STATS["mxmT_kernel"] += 1
    init_t = scalar_on(init, A.values.dtype, A.values.device)
    out, has = K.mxmt_masked(mask, A, B, op_mul, op_add, init_t,
                             _selection(mask, op_select, struct_only, kernel=True), struct_only)
    return _to_csr(mask, out, has, init_t, out_capacity)


def mxmT_masked_reduce(mask: CsrMatrix, A: CsrMatrix, B: CsrMatrix, op_mul, op_select,
                       struct_only: bool = False) -> torch.Tensor:
    """Sum of every product of ``mxmT_masked(mask, A, B, op_mul, PLUS, ...)``
    as a 0-d tensor on the device: int64 for integers and for
    ``struct_only`` (the hit count), float64 for floats.  The fused
    mxmT + m_reduce of triangle counting; kernel 4 on CUDA tensors when it
    covers ``op_mul``."""
    if (A.values.device.type == "cuda"
            and K.reduce_codes(op_mul, A.values.dtype, struct_only) is not None):
        DISPATCH_STATS["mxmT_kernel"] += 1
        return K.mxmt_reduce(mask, A, B, op_mul, _selection(mask, op_select, struct_only, kernel=True),
                             struct_only)
    DISPATCH_STATS["mxmT_torch"] += 1
    return K.mxmt_reduce_plain(mask, A, B, op_mul, _selection(mask, op_select, struct_only), struct_only)
