"""Format builders and conversions (counterpart of ``spla_tpu/formats.py``).

Host-side numpy builders (with duplicate-reduce) put a container on an
explicit ``device``; the vector converters run where their tensors live.
Every fact the port derives from a matrix (a transpose, a verdict, a
kernel's launch plan) lives in one store, ``derived``, keyed on the
tensors the fact reads.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from .containers import BsrMatrix, CooMatrix, CsrMatrix, DenseVec, SparseVec
from .utils.bits import gather, where

__all__ = [
    "WeakIdCache",
    "derived",
    "host_coo",
    "skew_stats",
    "is_skewed",
    "sparse_vec_from_entries",
    "dense_vec_from_entries",
    "coo_from_entries",
    "csr_from_entries",
    "csr_from_scipy",
    "csr_transpose_host",
    "transpose_of",
    "sparse_to_dense_vec",
    "dense_to_sparse_vec",
    "csr_to_coo",
    "coo_to_csr",
    "csr_to_dense",
    "coo_to_dense",
    "bsr_from_csr_host",
    "kept_positions",
    "split_rows",
    "stored_finite",
    "round_up",
]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class WeakIdCache:
    """id-keyed cache whose entries die with the key object (a plain
    id-keyed dict would alias recycled ids after GC).  A value must not
    hold a strong reference to its key, or the entry never dies.  spla_tpu's
    helper; the port keeps what it derives from a matrix in ``derived``."""

    def __init__(self):
        self._alive = weakref.WeakValueDictionary()
        self._data = {}

    def _gc(self, oid):
        if self._alive.get(oid) is None:
            for k in [k for k in self._data if k[0] == oid]:
                self._data.pop(k, None)

    def get(self, obj, extra=()):
        key = (id(obj), *extra)
        if self._alive.get(id(obj)) is not obj:
            self._data.pop(key, None)
            return None
        return self._data.get(key)

    def contains(self, obj, extra=()) -> bool:
        return self._alive.get(id(obj)) is obj and (id(obj), *extra) in self._data

    def put(self, obj, value, extra=()):
        key = (id(obj), *extra)
        if self._alive.get(id(obj)) is not obj:
            self._alive[id(obj)] = obj
            weakref.finalize(obj, self._gc, id(obj))
        self._data[key] = value


# (owner, id of each keyed tensor, *extra) -> (weak references to the tensors, fact)
_FACTS = {}


def derived(owner, tensors: tuple, build, extra: tuple = ()):
    """The fact ``owner`` (the function that derives it) holds of ``tensors``
    and the plain key ``extra``: ``build()``'s result, built at the first
    call and kept while every one of ``tensors`` lives.  A hit needs each
    tensor to be the same live object, so a recycled id never aliases; the
    entry dies with the first of them to be collected.  Key a fact on every
    tensor it reads; an entry whose fact holds every one of its tensors
    never dies."""
    key = (owner, *map(id, tensors), *extra)
    hit = _FACTS.get(key)
    if hit is not None:
        refs, fact = hit
        for ref, t in zip(refs, tensors):
            if ref() is not t:
                break
        else:
            return fact
    fact = build()

    def drop(_ref):
        _FACTS.pop(key, None)

    _FACTS[key] = (tuple(weakref.ref(t, drop) for t in tensors), fact)
    return fact


def stored_finite(A: CsrMatrix) -> bool:
    """Every stored value of A is finite (one host read, a fact of ``values``
    and ``nnz``)."""
    return derived(stored_finite, (A.values, A.nnz), lambda: bool(
        torch.all(torch.where(A.valid_mask(), torch.isfinite(A.values), True))))


def host_coo(A: CsrMatrix, nnz=None, pattern=False):
    """Host ``(rows, cols, vals)`` numpy arrays of A's first ``nnz`` entries
    (its stored ones by default); with ``pattern`` the values are f32 ones."""
    if nnz is None:
        nnz = int(A.nnz)
    rows, cols, vals = (t[:nnz].cpu().numpy() for t in (A.row_ids, A.cols, A.values))
    if pattern:
        vals = np.ones(nnz, np.float32)
    return rows, cols, vals


def _dedup_host(keys: np.ndarray, values: np.ndarray, reduce_fn):
    """Sort by key and combine duplicates left to right with ``reduce_fn``
    (``None`` keeps the last duplicate)."""
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    values = values[order]
    if keys.size == 0:
        return keys, values
    heads = np.empty(keys.size, dtype=bool)
    heads[0] = True
    heads[1:] = keys[1:] != keys[:-1]
    if reduce_fn is None:
        last = np.nonzero(np.append(heads[1:], True))[0]
        return keys[heads], values[last]
    out_idx = np.cumsum(heads) - 1
    uk = keys[heads]
    uv = values[heads].copy()
    for p in np.nonzero(~heads)[0]:
        o = out_idx[p]
        uv[o] = reduce_fn(uv[o], values[p])
    return uk, uv


def _csr_from_sorted_host(shape, r, c, v, fillv, capacity, device) -> CsrMatrix:
    m, n = shape
    nnz = int(r.size)
    cap = capacity if capacity is not None else max(nnz, 1)
    if cap < nnz:
        raise ValueError(f"capacity {cap} < nnz {nnz}")
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=m), out=indptr[1:])
    pc = np.zeros(cap, np.int32)
    pv = np.full(cap, fillv, fillv.dtype)
    pr = np.full(cap, m, np.int32)
    pc[:nnz], pv[:nnz], pr[:nnz] = c, v, r
    return CsrMatrix(
        shape=(m, n),
        indptr=_on(indptr.astype(np.int32), device),
        cols=_on(pc, device),
        values=_on(pv, device),
        row_ids=_on(pr, device),
        nnz=torch.tensor(nnz, dtype=torch.int32, device=device),
        fill=_on(np.asarray(fillv), device),
    )


def _on(a, device) -> torch.Tensor:
    # np.asarray keeps a 0-d fill 0-d (np.ascontiguousarray makes it [1])
    return torch.from_numpy(np.asarray(a, order="C")).to(device)


def sparse_vec_from_entries(n: int, indices, values, fill=0, dtype=None, reduce_fn=None,
                            capacity: int | None = None, *, device) -> SparseVec:
    """SparseVec from (index, value) pairs; duplicates fold left to right
    with ``reduce_fn`` (default: keep the last)."""
    indices = np.asarray(indices, dtype=np.int64)
    fillv = np.asarray(fill, dtype=dtype)
    idx, val = _dedup_host(indices, np.asarray(values, dtype=fillv.dtype), reduce_fn)
    nnz = int(idx.size)
    cap = capacity if capacity is not None else max(nnz, 1)
    if cap < nnz:
        raise ValueError(f"capacity {cap} < nnz {nnz}")
    pidx = np.full(cap, n, np.int32)
    pval = np.full(cap, fillv, fillv.dtype)
    pidx[:nnz], pval[:nnz] = idx, val
    return SparseVec(n=n, indices=_on(pidx, device), values=_on(pval, device),
                     nnz=torch.tensor(nnz, dtype=torch.int32, device=device), fill=_on(fillv, device))


def dense_vec_from_entries(n: int, indices, values, fill=0, dtype=None, reduce_fn=None, *,
                           device) -> DenseVec:
    return sparse_to_dense_vec(sparse_vec_from_entries(n, indices, values, fill, dtype, reduce_fn,
                                                       device=device))


def _matrix_entries_host(shape, rows, cols, values, fill, dtype, reduce_fn):
    """Host ``(rows, cols, values, fill)`` sorted row-major, duplicates folded."""
    m, n = shape
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    fillv = np.asarray(fill, dtype=dtype)
    k, v = _dedup_host(rows * n + cols, np.asarray(values, dtype=fillv.dtype), reduce_fn)
    return (k // n).astype(np.int32), (k % n).astype(np.int32), v, fillv


def coo_from_entries(shape, rows, cols, values, fill=0, dtype=None, reduce_fn=None, capacity=None, *,
                     device) -> CooMatrix:
    """COO from (row, col, value) triples, sorted row-major; duplicates as
    in ``csr_from_entries``."""
    m, n = shape
    r, c, v, fillv = _matrix_entries_host(shape, rows, cols, values, fill, dtype, reduce_fn)
    nnz = int(r.size)
    cap = capacity if capacity is not None else max(nnz, 1)
    if cap < nnz:
        raise ValueError(f"capacity {cap} < nnz {nnz}")
    pr = np.full(cap, m, np.int32)
    pc = np.zeros(cap, np.int32)
    pv = np.full(cap, fillv, fillv.dtype)
    pr[:nnz], pc[:nnz], pv[:nnz] = r, c, v
    return CooMatrix(shape=(m, n), rows=_on(pr, device), cols=_on(pc, device), values=_on(pv, device),
                     nnz=torch.tensor(nnz, dtype=torch.int32, device=device), fill=_on(fillv, device))


def csr_from_entries(shape, rows, cols, values, fill=0, dtype=None, reduce_fn=None,
                     capacity=None, *, device) -> CsrMatrix:
    """CSR from (row, col, value) triples; duplicates fold left to right
    with ``reduce_fn`` (default: keep the last)."""
    r, c, v, fillv = _matrix_entries_host(shape, rows, cols, values, fill, dtype, reduce_fn)
    return _csr_from_sorted_host(shape, r, c, v, fillv, capacity, device)


def csr_from_scipy(sp, fill=0, dtype=None, capacity=None, *, device) -> CsrMatrix:
    """CSR from a scipy.sparse matrix; stored entries, duplicates included,
    are kept as they are."""
    sp = sp.tocsr()
    sp.sort_indices()
    fillv = np.asarray(fill, dtype=dtype if dtype is not None else sp.dtype)
    coo = sp.tocoo()
    return _csr_from_sorted_host(sp.shape, coo.row.astype(np.int32), coo.col.astype(np.int32),
                                 coo.data.astype(fillv.dtype), fillv, capacity, device)


def csr_transpose_host(a: CsrMatrix, capacity=None) -> CsrMatrix:
    """Transpose on the host, rows sorted by (row, col); the result lives
    on ``a``'s device."""
    m, n = a.shape
    r, c, v = host_coo(a)
    order = np.lexsort((r, c))
    return _csr_from_sorted_host((n, m), c[order], r[order], v[order],
                                 a.fill.cpu().numpy(), capacity, a.device)


def transpose_of(a: CsrMatrix) -> CsrMatrix:
    """CSR of ``a``'s transpose, a fact of the tensors and the shape that
    ``csr_transpose_host`` reads.  The push kernel walks CSR(A), the
    transpose of the ``At`` that pull traverses."""
    return derived(transpose_of, (a.row_ids, a.cols, a.values, a.nnz, a.fill),
                   lambda: csr_transpose_host(a), a.shape)


def skew_stats(a: CsrMatrix):
    """``(max row degree, max column degree, mean row degree)`` of ``a``'s
    stored entries (``spla_tpu/pallas/spmv.py`` ``_skew_stats`` :3088);
    one host read, a fact of ``row_ids``, ``cols``, ``nnz`` and the shape."""
    return derived(skew_stats, (a.row_ids, a.cols, a.nnz), lambda: _skew_stats(a), a.shape)


def _skew_stats(a: CsrMatrix):
    rows, cols, _ = host_coo(a)
    m, n = a.shape
    return (int(np.bincount(rows, minlength=m).max(initial=0)),
            int(np.bincount(cols, minlength=n).max(initial=0)),
            rows.shape[0] / max(m, 1))


def is_skewed(a: CsrMatrix) -> bool:
    """The JAX package's hub-graph rule (``spla_tpu/pallas/spmv.py:3102``):
    the heaviest row or column is far above the mean.  Uniform graphs stay
    well under it; BFS and SSSP keep their level loop on graphs above it."""
    rmax, cmax, avg = skew_stats(a)
    return max(rmax, cmax) > 4 * avg + 128


def index_set(base, idx, vals):
    """``base[idx] = vals``, returning base; torch has no uint32 index_put,
    so uint32 goes through int64."""
    if base.dtype == torch.uint32:
        wide = base.to(torch.int64)
        wide[idx] = vals.to(torch.int64)
        return wide.to(torch.uint32)
    base[idx] = vals
    return base


def sparse_to_dense_vec(sv: SparseVec) -> DenseVec:
    """SparseVec -> DenseVec (padding indices land in the dump slot)."""
    vals = torch.where(sv.valid_mask(), sv.values, sv.fill)
    dense = index_set(sv.fill.expand(sv.n + 1).clone(), sv.indices.long(), vals)
    return DenseVec(dense[: sv.n], sv.fill)


def kept_positions(keep, size: int):
    """``(pos, ok)``: the positions of the first ``size`` True entries of
    ``keep``, in order, and which of the ``size`` slots hold one (``pos`` is
    0 at the others): ``jnp.nonzero(keep, size=size)`` with no host read."""
    k = keep.shape[0]
    rank = torch.cumsum(keep, 0) - 1
    target = torch.where(keep & (rank < size), rank, size)
    pos = torch.full((size + 1,), k, dtype=torch.int64, device=keep.device)
    pos.scatter_(0, target, torch.arange(k, device=keep.device))
    ok = pos[:size] < k
    return torch.where(ok, pos[:size], 0), ok


def compact(values, keep, capacity: int, fill) -> SparseVec:
    """SparseVec of the entries where ``keep``, in index order, without a
    host sync: at most ``capacity`` entries, padding index ``n``."""
    n = keep.shape[0]
    pos, ok = kept_positions(keep, capacity)
    nnz = torch.clamp(keep.sum(), max=capacity).to(torch.int32)
    return SparseVec(n=n, indices=torch.where(ok, pos, n).to(torch.int32),
                     values=where(ok, gather(values, pos), fill), nnz=nnz, fill=fill)


def dense_to_sparse_vec(dv: DenseVec, capacity: int | None = None) -> SparseVec:
    """DenseVec -> SparseVec of the entries != fill (capacity defaults to n)."""
    cap = capacity if capacity is not None else dv.n
    return compact(dv.values, dv.stored_mask(), cap, dv.fill)


def split_rows(a: CsrMatrix, parts: int) -> list:
    """Cut ``a`` at row boundaries into at most ``parts`` row ranges of about
    equal stored-entry counts (``spla_tpu/pallas/spmv.py``
    ``split_fused_format`` :3032 cuts tile batches instead).  Part ``p``
    covers the rows after those of parts ``0..p-1``: its output is that
    slice of the whole SpMV's output.  ``cols`` and ``values`` are views
    of ``a``'s; ``indptr`` and ``row_ids`` are rebased copies.  Ranges of
    no rows are dropped."""
    m, n = a.shape
    if parts < 1:
        raise ValueError(f"split_rows: parts must be >= 1, got {parts}")
    ip = a.indptr.long()
    targets = torch.div(ip[m] * torch.arange(1, parts, device=ip.device), parts,
                        rounding_mode="floor")
    cuts = [0, *torch.searchsorted(ip, targets).clamp(max=m).tolist(), m]
    out = []
    for r0, r1 in zip(cuts[:-1], cuts[1:]):
        if r1 <= r0:
            continue
        e0, e1 = int(ip[r0]), int(ip[r1])
        out.append(CsrMatrix(shape=(r1 - r0, n), indptr=(a.indptr[r0:r1 + 1] - e0).contiguous(),
                             cols=a.cols[e0:e1], values=a.values[e0:e1],
                             row_ids=a.row_ids[e0:e1] - r0,
                             nnz=torch.tensor(e1 - e0, dtype=torch.int32, device=a.cols.device),
                             fill=a.fill))
    return out


def csr_to_coo(a: CsrMatrix) -> CooMatrix:
    return CooMatrix(shape=a.shape, rows=a.row_ids, cols=a.cols, values=a.values, nnz=a.nnz,
                     fill=a.fill)


def coo_to_csr(a: CooMatrix) -> CsrMatrix:
    """COO (entries sorted row-major, pads last with row m) -> CSR: indptr by
    searchsorted of the rows, clamped to nnz, on the device."""
    m, _ = a.shape
    bounds = torch.arange(m + 1, dtype=a.rows.dtype, device=a.rows.device)
    indptr = torch.minimum(torch.searchsorted(a.rows, bounds, side="left"), a.nnz.long())
    return CsrMatrix(shape=a.shape, indptr=indptr.to(torch.int32), cols=a.cols, values=a.values,
                     row_ids=a.rows, nnz=a.nnz, fill=a.fill)


def csr_to_dense(a: CsrMatrix) -> torch.Tensor:
    """Dense [m, n] tensor of A; unstored slots hold the fill."""
    m, n = a.shape
    valid = a.valid_mask()
    vals = torch.where(valid, a.values, a.fill)
    flat = a.row_ids.long() * (n + 1) + torch.where(valid, a.cols.long(), n)
    dense = index_set(a.fill.expand((m + 1) * (n + 1)).clone(), flat, vals)
    return dense.reshape(m + 1, n + 1)[:m, :n]


def coo_to_dense(a: CooMatrix) -> torch.Tensor:
    return csr_to_dense(coo_to_csr(a))


def bsr_from_csr_host(a: CsrMatrix, block: int = 128, capacity=None) -> BsrMatrix:
    """BSR of ``a`` in ``block x block`` tiles, built on the host; the result
    lives on ``a``'s device.  Stored blocks are ordered by (block row, block
    column); their unstored elements hold ``a.fill``."""
    m, n = a.shape
    mb, nb = -(-m // block), -(-n // block)
    r, c, v = host_coo(a)
    r, c = r.astype(np.int64), c.astype(np.int64)
    bkey = (r // block) * nb + c // block
    order = np.argsort(bkey, kind="stable")
    bkey_s = bkey[order]
    heads = np.ones(bkey_s.size, dtype=bool)
    heads[1:] = bkey_s[1:] != bkey_s[:-1]
    ukeys = bkey_s[heads]
    nnzb = int(ukeys.size)
    cap = capacity if capacity is not None else max(nnzb, 1)
    if cap < nnzb:
        raise ValueError(f"capacity {cap} < stored blocks {nnzb}")
    fill = a.fill.cpu().numpy()
    blocks = np.full((cap, block, block), fill, dtype=v.dtype)
    blocks[np.cumsum(heads) - 1, r[order] % block, c[order] % block] = v[order]
    bcols = np.zeros(cap, np.int32)
    brows = np.full(cap, mb, np.int32)
    bcols[:nnzb] = ukeys % nb
    brows[:nnzb] = ukeys // nb
    indptr = np.zeros(mb + 1, np.int64)
    np.cumsum(np.bincount(brows[:nnzb], minlength=mb), out=indptr[1:])
    dev = a.device
    return BsrMatrix(shape=(m, n), block=block, indptr=_on(indptr.astype(np.int32), dev),
                     cols=_on(bcols, dev), blocks=_on(blocks, dev), row_ids=_on(brows, dev),
                     nnzb=torch.tensor(nnzb, dtype=torch.int32, device=dev), fill=_on(fill, dev))
