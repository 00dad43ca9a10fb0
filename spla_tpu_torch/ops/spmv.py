"""Masked generalized SpMV (counterpart of ``spla_tpu/ops/spmv.py``).

* ``mxv_masked`` — pull SpMV with mask select and init;
* ``vxm_masked`` / ``vxm_masked_dense`` — push SpMV ``r = v x M``, computed
  as pull over ``M_t`` (CSR of Mᵀ) with the operands swapped and a validity
  mask on v's stored entries.

Semantics: ``r[i] = select(mask[i]) ? fold(add, init, mul(M[i,j], v[j])) :
init``; a result slot is stored iff the mask selects it and at least one
product lands there; a stored value may equal ``init``.

Dispatch is a static semiring gate: for CUDA tensors, a (mul, add, dtype)
that kernel 1 covers launches it (and a failed launch raises); anything
else takes the plain torch path.  ``DISPATCH_STATS`` counts each.
"""

from __future__ import annotations

import torch

from ..containers import CsrMatrix, DenseVec, SparseVec
from ..formats import compact, index_set
from ..kernels import spmv as K
from ..utils.bits import where
from ..utils.segments import scalar_on

__all__ = [
    "DISPATCH_STATS",
    "masked_spmv",
    "masked_spmv_structural",
    "mxv_masked",
    "vxm_masked",
    "vxm_masked_dense",
    "best_spmv_fn",
]

# the op layer's dispatch counts; ops.spgemm counts mxmT_masked and mxm here too
DISPATCH_STATS = {"mxv_kernel": 0, "mxv_torch": 0, "vxm_kernel": 0, "vxm_torch": 0,
                  "mxmT_kernel": 0, "mxmT_torch": 0, "mxm_kernel": 0, "mxm_dense": 0, "mxm_torch": 0}


def _kernel_covers(M: CsrMatrix, op_mul, op_add) -> bool:
    return M.values.device.type == "cuda" and K.pull_codes(op_mul, op_add, M.values.dtype) is not None


def masked_spmv(A: CsrMatrix, x_vals, op_mul, op_add, init, x_valid=None, mask_vals=None,
                op_select=None):
    """The plain torch path for any semiring: returns ``(vals [m], has [m])``."""
    sel = op_select(mask_vals) if mask_vals is not None and op_select is not None else None
    return K.spmv_pull_plain(A, x_vals, op_mul, op_add, scalar_on(init, A.values.dtype, A.values.device),
                             x_valid=x_valid, row_sel=sel)


def masked_spmv_structural(A: CsrMatrix, x_active, mask_sel=None):
    """Structure-only traversal step: ``out[i] = mask_sel[i] and any j in
    row i with x_active[j]``; values are ignored."""
    return K.spmv_pull_structural(A, x_active, mask_sel)


def mxv_masked(mask: DenseVec, M: CsrMatrix, v: DenseVec, op_mul, op_add, op_select, init,
               desc=None) -> DenseVec:
    """Pull SpMV with a dense result; the mask select is fused into the kernel."""
    init_t = scalar_on(init, M.values.dtype, M.values.device)
    sel = op_select(mask.values)
    if _kernel_covers(M, op_mul, op_add):
        DISPATCH_STATS["mxv_kernel"] += 1
        out, _ = K.spmv_pull(M, v.values, op_mul, op_add, init_t, row_sel=sel)
    else:
        DISPATCH_STATS["mxv_torch"] += 1
        out, _ = K.spmv_pull_plain(M, v.values, op_mul, op_add, init_t, row_sel=sel)
    return DenseVec(out, init_t)


def _dense_x(v, n_in: int, init_t):
    """Dense ``(x, x_valid)`` of a SparseVec or DenseVec; the stored entries are valid."""
    if isinstance(v, SparseVec):
        valid = v.valid_mask()
        idx = v.indices.long()
        x = index_set(init_t.expand(n_in + 1).clone(), idx, where(valid, v.values.to(init_t.dtype), init_t))
        x_valid = torch.zeros(n_in + 1, dtype=torch.bool, device=idx.device)
        x_valid[idx] = valid
        return x[:n_in], x_valid[:n_in]
    return v.values, v.stored_mask()


def _vxm(mask, v, M_t, op_mul, op_add, op_select, init_t, want_has):
    x, x_valid = _dense_x(v, M_t.shape[1], init_t)
    sel = op_select(mask.values)
    if _kernel_covers(M_t, op_mul, op_add):
        DISPATCH_STATS["vxm_kernel"] += 1
        return K.spmv_pull(M_t, x, op_mul, op_add, init_t, x_valid=x_valid, row_sel=sel,
                           want_has=want_has, swap=True)
    DISPATCH_STATS["vxm_torch"] += 1
    return K.spmv_pull_plain(M_t, x, op_mul, op_add, init_t, x_valid=x_valid, row_sel=sel,
                             swap=True)


def vxm_masked(mask: DenseVec, v, M_t: CsrMatrix, op_mul, op_add, op_select, init, desc=None,
               out_capacity: int | None = None) -> SparseVec:
    """Push SpMV ``r = v x M`` with a sparse result, over ``M_t`` = CSR of Mᵀ.
    ``v`` is a SparseVec or a DenseVec (stored = != fill); the product order
    is ``mul(v[i], M[i,j])``.  The kernel writes the stored-ness ``has`` in
    the same pass as the values."""
    init_t = scalar_on(init, M_t.values.dtype, M_t.values.device)
    out, has = _vxm(mask, v, M_t, op_mul, op_add, op_select, init_t, want_has=True)
    cap = out_capacity if out_capacity is not None else M_t.shape[0]
    return compact(out, has, cap, init_t)


def vxm_masked_dense(mask: DenseVec, v, M_t: CsrMatrix, op_mul, op_add, op_select, init,
                     desc=None) -> DenseVec:
    """Dense-result push SpMV, value-equal to ``dense(vxm_masked(...))``:
    unstored slots hold ``init``."""
    init_t = scalar_on(init, M_t.values.dtype, M_t.values.device)
    out, _ = _vxm(mask, v, M_t, op_mul, op_add, op_select, init_t, want_has=False)
    return DenseVec(out, init_t)


def best_spmv_fn(A: CsrMatrix, op_mul, op_add, init):
    """Unmasked SpMV callable ``f(A, x) -> vals``: kernel 1 when it covers
    the semiring on A's CUDA device, else the plain torch path."""
    use_kernel = _kernel_covers(A, op_mul, op_add)

    def fn(A, x):
        init_t = scalar_on(init, A.values.dtype, A.values.device)
        if use_kernel:
            return K.spmv_pull(A, x, op_mul, op_add, init_t)[0]
        return K.spmv_pull_plain(A, x, op_mul, op_add, init_t)[0]

    return fn
