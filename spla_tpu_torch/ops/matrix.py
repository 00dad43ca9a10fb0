"""Matrix ops (counterpart of ``spla_tpu/ops/matrix.py``): element-wise
union and intersection, reductions, transpose, row and column extraction
and the Kronecker product (reference ``src/cpu/cpu_m_*.hpp``,
``cpu_kron.hpp``).

Every op runs where its tensors live, with no host read.  Results are
sorted row-major.  With more entries than ``out_capacity``, the first ones
in (row, column) order are stored and ``nnz`` is the capacity (spla_tpu
reports the uncut count), as the port's ``mxm`` and ``mxmT_masked`` do.
"""

from __future__ import annotations

import torch

from ..containers import CooMatrix, CsrMatrix, DenseVec, Scalar, SparseVec
from ..formats import coo_to_csr, csr_to_coo, kept_positions
from ..utils.primitives import lex_order
from ..utils.search import rowwise_find
from ..utils.segments import scalar_on, segment_fold

__all__ = [
    "m_eadd",
    "m_emult",
    "m_reduce",
    "m_reduce_by_row",
    "m_reduce_by_column",
    "m_transpose",
    "m_extract_row",
    "m_extract_column",
    "kron",
]


def _as_coo(x) -> CooMatrix:
    return csr_to_coo(x) if isinstance(x, CsrMatrix) else x


def _compact_coo(shape, rows, cols, vals, keep, fill, out_capacity=None) -> CsrMatrix:
    """CSR of the kept entries (already sorted row-major), capacity
    ``out_capacity`` or ``len(keep)``."""
    m, _ = shape
    cap = out_capacity if out_capacity is not None else keep.shape[0]
    pos, ok = kept_positions(keep, cap)
    return coo_to_csr(CooMatrix(
        shape=shape,
        rows=torch.where(ok, rows[pos], m).to(torch.int32),
        cols=torch.where(ok, cols[pos], 0).to(torch.int32),
        values=torch.where(ok, vals[pos], fill),
        nnz=keep.sum().clamp(max=cap).to(torch.int32),
        fill=fill,
    ))


def _merge_ewise(a, b, op, union: bool, out_capacity=None) -> CsrMatrix:
    """Merge two matrices' entries by one sort on (row, column, source).

    ``union`` (eadd, ``cpu_m_eadd.hpp``): an unmatched entry appears as it
    is; else (emult, ``cpu_m_emult.hpp``) only matched entries.  Both drop
    results equal to the result's fill ``op(a.fill, b.fill)``."""
    a, b = _as_coo(a), _as_coo(b)
    m, n = a.shape
    device = a.rows.device
    valid = torch.cat([a.valid_mask(), b.valid_mask()])
    rows = torch.where(valid, torch.cat([a.rows, b.rows]).long(), m)
    cols = torch.where(valid, torch.cat([a.cols, b.cols]).long(), n)
    src = torch.cat([torch.zeros(a.capacity, dtype=torch.int64, device=device),
                     torch.ones(b.capacity, dtype=torch.int64, device=device)])
    vals = torch.cat([a.values, b.values])
    order = lex_order((rows, cols, src), (m + 1, n + 1, 2))
    rows, cols, src, vals = rows[order], cols[order], src[order], vals[order]
    same = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
    nxt_same = torch.cat([same, same.new_zeros(1)])
    prv_same = torch.cat([same.new_zeros(1), same])
    nxt_val = torch.cat([vals[1:], vals[:1]])
    is_valid = rows < m
    pair = nxt_same & (src == 0) & is_valid
    fill = op(a.fill, b.fill)
    if union:
        combined = torch.where(pair, op(vals, nxt_val), vals)
        keep = is_valid & ~prv_same
    else:
        combined = op(vals, nxt_val)
        keep = pair
    return _compact_coo((m, n), rows, cols, combined, keep & (combined != fill), fill, out_capacity)


def m_eadd(a, b, op, out_capacity=None) -> CsrMatrix:
    """R = A (+) B, the union (reference exec_m_eadd).  Unlike ``v_eadd``,
    an unmatched entry is emitted unchanged, and results equal to the fill
    are dropped (``cpu_m_eadd.hpp:88-150``)."""
    return _merge_ewise(a, b, op, union=True, out_capacity=out_capacity)


def m_emult(a, b, op, out_capacity=None) -> CsrMatrix:
    """R = A (*) B, the intersection (reference exec_m_emult)."""
    return _merge_ewise(a, b, op, union=False, out_capacity=out_capacity)


def m_reduce(init, M: CsrMatrix, op_reduce) -> Scalar:
    """Scalar fold of ``op_reduce`` over the stored values, starting at
    ``init`` (reference exec_m_reduce, ``cpu_m_reduce.hpp``).  Runs where
    M lives; the result stays on the device."""
    seg = torch.zeros(M.values.shape, dtype=torch.int32, device=M.values.device)
    out, _ = segment_fold(M.values, seg, M.valid_mask(), 1, op_reduce, init)
    return Scalar(out[0])


def m_reduce_by_row(M, op_reduce, init) -> DenseVec:
    """r[i] = fold over row i, onto ``init`` (reference exec_m_reduce_by_row)."""
    coo = _as_coo(M)
    init_t = scalar_on(init, M.values.dtype, M.values.device)
    out, _ = segment_fold(coo.values, coo.rows, coo.valid_mask(), M.shape[0], op_reduce, init_t)
    return DenseVec(out, init_t)


def m_reduce_by_column(M, op_reduce, init) -> DenseVec:
    """r[j] = fold over column j, onto ``init`` (reference
    exec_m_reduce_by_column); column ids are unsorted in CSR order."""
    n = M.shape[1]
    coo = _as_coo(M)
    init_t = scalar_on(init, M.values.dtype, M.values.device)
    valid = coo.valid_mask()
    cols = torch.where(valid, coo.cols, n)
    out, _ = segment_fold(coo.values, cols, valid, n, op_reduce, init_t, sorted_ids=False)
    return DenseVec(out, init_t)


def m_transpose(M, op_apply) -> CsrMatrix:
    """R = op_apply(Mᵀ) (reference exec_m_transpose, ``cpu_m_transpose.hpp``):
    the entries sorted by (column, row)."""
    coo = _as_coo(M)
    m, n = coo.shape
    valid = coo.valid_mask()
    rows = torch.where(valid, coo.rows, m)
    cols = torch.where(valid, coo.cols, n)
    order = lex_order((cols, rows), (n + 1, m + 1))
    c, r, v = cols[order], rows[order], coo.values[order]
    ok = c < n
    return coo_to_csr(CooMatrix(
        shape=(n, m),
        rows=c.to(torch.int32),
        cols=torch.where(ok, r, 0).to(torch.int32),
        values=torch.where(ok, op_apply(v), coo.fill),
        nnz=coo.nnz,
        fill=coo.fill,
    ))


def _row_bounds(M: CsrMatrix, index):
    """``(lo, hi)`` of row ``index`` (an int, or a 0-d tensor on M's device)."""
    if isinstance(index, torch.Tensor):
        i = index.long().reshape(1)
        ends = M.indptr[torch.cat([i, i + 1])]
        return ends[0], ends[1]
    return M.indptr[index], M.indptr[index + 1]


def m_extract_row(M: CsrMatrix, index, op_apply, out_capacity: int | None = None) -> SparseVec:
    """r = op_apply(M[index, :]) as a sparse vector of capacity
    ``out_capacity`` or n (reference exec_m_extract_row,
    ``cpu_m_extract_row.hpp``)."""
    n = M.shape[1]
    cap = out_capacity if out_capacity is not None else n
    lo, hi = _row_bounds(M, index)
    at = lo + torch.arange(cap, dtype=torch.int32, device=M.cols.device)
    pos = at.clamp(0, M.capacity - 1).long()
    ok = at < hi
    return SparseVec(n=n, indices=torch.where(ok, M.cols[pos], n).to(torch.int32),
                     values=torch.where(ok, op_apply(M.values[pos]), M.fill),
                     nnz=(hi - lo).clamp(max=cap).to(torch.int32), fill=M.fill)


def m_extract_column(M: CsrMatrix, index, op_apply, out_capacity: int | None = None) -> SparseVec:
    """r = op_apply(M[:, index]) as a sparse vector of capacity
    ``out_capacity`` or m (reference exec_m_extract_column: a lower bound
    in each row, ``cpu_m_extract_column.hpp``).  Rows must be sorted by
    column."""
    m = M.shape[0]
    cap = out_capacity if out_capacity is not None else m
    if isinstance(index, torch.Tensor):
        keys = index.to(torch.int32).reshape(1).expand(m)
    else:
        keys = torch.full((m,), index, dtype=torch.int32, device=M.cols.device)
    pos, found = rowwise_find(M.cols, M.indptr[:-1], M.indptr[1:], keys)
    found = found & (pos < M.nnz)
    ridx, ok = kept_positions(found, cap)
    at = pos[ridx].clamp(0, M.capacity - 1).long()
    return SparseVec(n=m, indices=torch.where(ok, ridx, m).to(torch.int32),
                     values=torch.where(ok, op_apply(M.values[at]), M.fill),
                     nnz=found.sum().clamp(max=cap).to(torch.int32), fill=M.fill)


def kron(A, B, op_mul, out_capacity: int | None = None) -> CsrMatrix:
    """R = A (x) B, the Kronecker product (reference exec_kron,
    ``cpu_kron.hpp:70-108``): slot p * B.capacity + q pairs A's slot p with
    B's slot q, then the products are sorted row-major."""
    a, b = _as_coo(A), _as_coo(B)
    (am, an), (bm, bn) = a.shape, b.shape
    m, n = am * bm, an * bn
    ac, bc = a.capacity, b.capacity
    valid = (a.valid_mask()[:, None] & b.valid_mask()[None, :]).reshape(-1)
    rows = (a.rows.long()[:, None] * bm + b.rows.long()[None, :]).reshape(-1)
    cols = (a.cols.long()[:, None] * bn + b.cols.long()[None, :]).reshape(-1)
    rows = torch.where(valid, rows, m)
    cols = torch.where(valid, cols, n)
    vals = op_mul(a.values[:, None].expand(ac, bc), b.values[None, :].expand(ac, bc)).reshape(-1)
    order = lex_order((rows, cols), (m + 1, n + 1))
    rows, cols, vals = rows[order], cols[order], vals[order]
    return _compact_coo((m, n), rows, cols, vals, rows < m, op_mul(a.fill, b.fill), out_capacity)
