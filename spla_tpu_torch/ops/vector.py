"""Element-wise, map, reduce and assign vector ops (counterpart of
``spla_tpu/ops/vector.py``): v_eadd, v_emult, v_map, v_reduce, v_count_mf,
v_assign_masked and v_eadd_fdb.

Sparse paths merge by one sort of both inputs' entries, as the reference
does (``cpu_v_eadd.hpp``): an unmatched entry of ``v_eadd`` combines with
the other operand's fill.  Every op runs where its tensors live, with no
host read; a dense operand of a sparse op is converted with
``formats.dense_to_sparse_vec`` (capacity n).
"""

from __future__ import annotations

import torch

from ..containers import DenseVec, Scalar, SparseVec
from ..formats import dense_to_sparse_vec, index_set, kept_positions
from ..utils.primitives import lex_order
from ..utils.segments import scalar_on, segment_fold

__all__ = [
    "v_eadd",
    "v_emult",
    "v_map",
    "v_reduce",
    "v_count_mf",
    "v_assign_masked",
    "v_eadd_fdb",
]


def _as_sparse(x) -> SparseVec:
    return x if isinstance(x, SparseVec) else dense_to_sparse_vec(x)


def _sorted_union(u: SparseVec, v: SparseVec):
    """Both inputs' entries sorted by (index, source), padding (index n)
    last: ``(idx, src, val, valid, nxt_val, nxt_same)``, where the last two
    are the next entry's value and whether it has the same index."""
    n = u.n
    idx = torch.cat([u.indices, v.indices]).long()
    val = torch.cat([u.values, v.values])
    src = torch.cat([torch.zeros(u.capacity, dtype=torch.int64, device=idx.device),
                     torch.ones(v.capacity, dtype=torch.int64, device=idx.device)])
    valid = torch.cat([u.valid_mask(), v.valid_mask()])
    idx = torch.where(valid, idx, n)
    order = lex_order((idx, src), (n + 1, 2))
    idx, src, val, valid = idx[order], src[order], val[order], valid[order]
    same = idx[1:] == idx[:-1]
    nxt_same = torch.cat([same, same.new_zeros(1)])
    nxt_val = torch.cat([val[1:], val[:1]])
    return idx, src, val, valid, nxt_val, nxt_same


def _merge_union(u: SparseVec, v: SparseVec, op):
    """Union merge (reference ``cpu_v_eadd.hpp:88-140``): a matched index
    combines op(u_x, v_x), an unmatched one combines with the other
    operand's fill.  Returns ``(idx, combined, keep)``."""
    idx, src, val, valid, nxt_val, nxt_same = _sorted_union(u, v)
    pair = nxt_same & (src == 0) & (idx < u.n)
    combined = torch.where(pair, op(val, nxt_val),
                           torch.where(src == 0, op(val, v.fill), op(u.fill, val)))
    prv_same = torch.cat([nxt_same.new_zeros(1), nxt_same[:-1]])
    return idx, combined, valid & (idx < u.n) & ~prv_same


def _compact(idx, vals, keep, n: int, fill) -> SparseVec:
    """SparseVec of the kept entries, in order, capacity ``len(keep)``."""
    pos, ok = kept_positions(keep, keep.shape[0])
    return SparseVec(n=n, indices=torch.where(ok, idx[pos], n).to(torch.int32),
                     values=torch.where(ok, vals[pos], fill),
                     nnz=keep.sum().to(torch.int32), fill=fill)


def v_eadd(u, v, op):
    """r = u (+) v, the element-wise union (reference exec_v_eadd,
    ``include/spla/exec.hpp:381-401``).  Two dense inputs: op on every slot."""
    if isinstance(u, DenseVec) and isinstance(v, DenseVec):
        return DenseVec(op(u.values, v.values), op(u.fill, v.fill))
    u, v = _as_sparse(u), _as_sparse(v)
    idx, combined, keep = _merge_union(u, v, op)
    return _compact(idx, combined, keep, u.n, op(u.fill, v.fill))


def v_emult(u, v, op):
    """r = u (*) v, the element-wise intersection (reference exec_v_emult,
    ``cpu_v_emult.hpp``): only matched indices are kept."""
    if isinstance(u, DenseVec) and isinstance(v, DenseVec):
        return DenseVec(op(u.values, v.values), op(u.fill, v.fill))
    u, v = _as_sparse(u), _as_sparse(v)
    idx, src, val, _, nxt_val, nxt_same = _sorted_union(u, v)
    pair = nxt_same & (src == 0) & (idx < u.n)
    return _compact(idx, op(val, nxt_val), pair, u.n, op(u.fill, v.fill))


def v_map(v, op):
    """r = op(v) on every stored entry (reference exec_v_map)."""
    if isinstance(v, DenseVec):
        return DenseVec(op(v.values), v.fill)
    return SparseVec(n=v.n, indices=v.indices, values=op(v.values), nnz=v.nnz, fill=v.fill)


def v_reduce(init, v, op_reduce, stored_only: bool = False) -> Scalar:
    """r = fold(op_reduce, init, values of v) (reference exec_v_reduce).

    A dense v folds all n slots, as the reference's dense kernel does
    (``cpu_v_reduce.hpp`` execute_dn): fill slots contribute.
    ``stored_only=True`` folds only the slots != fill (the sparse path's
    semantics)."""
    if isinstance(v, DenseVec):
        valid = v.stored_mask() if stored_only else torch.ones_like(v.values, dtype=torch.bool)
    else:
        valid = v.valid_mask()
    seg = torch.zeros(v.values.shape, dtype=torch.int32, device=v.values.device)
    out, _ = segment_fold(v.values, seg, valid, 1, op_reduce,
                          scalar_on(init, v.values.dtype, v.values.device))
    return Scalar(out[0])


def v_count_mf(v) -> Scalar:
    """The count of stored entries as a uint32 Scalar (reference
    exec_v_count_mf, ``include/spla/exec.hpp:497-519``; a dense v counts its
    slots != fill)."""
    if isinstance(v, DenseVec):
        return Scalar(v.stored_mask().sum().to(torch.uint32))
    return Scalar(v.nnz.to(torch.uint32))


def _scatter_flags(n: int, indices, flags):
    """[n] bool: ``flags`` at ``indices``; padding index n is dropped."""
    out = torch.zeros(n + 1, dtype=torch.bool, device=flags.device)
    return out.index_put_((indices.long(),), flags)[:n]


def v_assign_masked(r: DenseVec, mask, value, op_assign, op_select) -> DenseVec:
    """r[i] = op_assign(r[i], value) where op_select(mask[i]) (reference
    exec_v_assign_masked, ``cpu_v_assign.hpp``).  A sparse mask tests its
    stored entries only; a dense one every slot."""
    val = scalar_on(value, r.values.dtype, r.values.device)
    if isinstance(mask, SparseVec):
        sel = _scatter_flags(r.n, mask.indices, op_select(mask.values) & mask.valid_mask())
    else:
        sel = op_select(mask.values)
    return DenseVec(torch.where(sel, op_assign(r.values, val), r.values), r.fill)


def v_eadd_fdb(r: DenseVec, v, op):
    """r' = op(r, v) with feedback (reference exec_v_eadd_fdb,
    ``cpu_v_eadd_fdb.hpp``, which drives SSSP's convergence).

    Returns ``(r', fdb)``: fdb holds the entries whose value changed; it is
    sparse (capacity v's) when v is sparse, else dense with v's fill at the
    unchanged slots."""
    if isinstance(v, SparseVec):
        valid = v.valid_mask()
        sel = _scatter_flags(r.n, v.indices, valid)
        base = v.fill.to(r.values.dtype).expand(r.n + 1).clone()
        vv = index_set(base, v.indices.long(), torch.where(valid, v.values, v.fill))[: r.n]
        new_vals = torch.where(sel, op(r.values, vv), r.values)
        changed = sel & (new_vals != r.values)
        pos, ok = kept_positions(changed, v.capacity)
        fdb = SparseVec(n=r.n, indices=torch.where(ok, pos, r.n).to(torch.int32),
                        values=torch.where(ok, new_vals[pos], v.fill),
                        nnz=changed.sum().clamp(max=v.capacity).to(torch.int32), fill=v.fill)
        return DenseVec(new_vals, r.fill), fdb
    new_vals = op(r.values, v.values)
    changed = new_vals != r.values
    return DenseVec(new_vals, r.fill), DenseVec(torch.where(changed, new_vals, v.fill), v.fill)
