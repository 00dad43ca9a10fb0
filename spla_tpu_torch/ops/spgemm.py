"""SpGEMM (counterpart of ``spla_tpu/ops/spgemm.py``): ``mxm`` and the
masked ``mxmT_masked``.

``mxm(A, B, ...)`` computes ``C = A (+).(x) B``: ``C[i, j] = init (+)
fold_(+) mul(A[i, p], B[p, j])`` over the p that row i of A and column j of
B share; results equal to ``init`` are not stored (reference
``cpu_mxm.hpp:109-113``).  For CUDA tensors with no ``products_cap`` or
``block_products`` (which ask for the plain path's truncation or windows),
a MULT/PLUS f32 request with init 0 that ``mxm_dense_gate`` admits takes
the dense route (``_mxm_dense``: densify, one full-f32 ``torch.matmul``,
compact; spla_tpu's ``_mxm_dense_try``), any other (mul, add, dtype) that
kernel 9 covers launches it; everything else takes the plain torch path
(``kernels.spgemm.mxm_plain``).

``mxmT_masked(mask, A, B, ...)`` computes, for each stored mask entry
(i, j) that ``op_select`` keeps, ``R[i,j] = init (+) fold_(+) mul(A[i,k],
B[j,k])`` over the columns k that row i of A and row j of B share;
entries with no product, and entries equal to ``init``, are not stored
(reference exec_mxmT_masked, ``include/spla/exec.hpp:104-131``).  Rows of
A and B must be sorted by column, as the port's builders make them.

Dispatch is the static semiring gate of ``ops.spmv``: for CUDA tensors a
(mul, add, dtype) that kernel 5 (9 for ``mxm``, or the dense route)
covers launches it; anything else takes the plain torch path.
``DISPATCH_STATS`` counts each.
Results are compacted on the device with no host read.
"""

from __future__ import annotations

import torch

from ..containers import CooMatrix, CsrMatrix
from ..formats import compact, coo_to_csr, stored_finite
from ..kernels import mxmt as K, spgemm as K9
from ..utils.bits import bits
from ..utils.segments import scalar_on
from .spmv import DISPATCH_STATS

__all__ = [
    "MXM_DENSE_CAP",
    "MXM_DENSE_MIN_PRODUCTS",
    "MXM_DENSE_PER_MKN",
    "mxm",
    "mxm_dense_gate",
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
    and ``nnz`` is the capacity (spla_tpu reports the uncut count).

    On CUDA tensors, a request that ``mxm_dense_gate`` admits (MULT/PLUS
    f32, init 0, dense enough, operands within ``MXM_DENSE_CAP``, finite
    stored values) takes the dense route, ``_mxm_dense``, with the same
    result as kernel 9's (f32 PLUS sums in another order); a failure there
    raises.  ``DISPATCH_STATS`` counts ``mxm_dense``, ``mxm_kernel`` and
    ``mxm_torch``."""
    init_t = scalar_on(init, A.values.dtype, A.values.device)
    if (A.values.device.type != "cuda" or products_cap is not None or block_products is not None
            or K9.mxm_codes(op_mul, op_add, A.values.dtype) is None):
        DISPATCH_STATS["mxm_torch"] += 1
        return K9.mxm_plain(A, B, op_mul, op_add, init_t, products_cap, out_capacity, block_products)
    (m, k), n = A.shape, B.shape[1]
    if mxm_dense_gate(op_mul, op_add, (A.values.dtype, B.values.dtype), init, m, k, n,
                      K9.mxm_plan(A, B).products, lambda: stored_finite(A) and stored_finite(B)):
        DISPATCH_STATS["mxm_dense"] += 1
        return _mxm_dense(A, B, out_capacity)
    DISPATCH_STATS["mxm_kernel"] += 1
    return K9.mxm(A, B, op_mul, op_add, init_t, out_capacity)


# spla_tpu/ops/spgemm.py:434,438: the dense route's largest operand or result
# (elements), and the fewest products it takes
MXM_DENSE_CAP = 1 << 27
MXM_DENSE_MIN_PRODUCTS = 1 << 22
# The port's density gate: the route's matmul costs O(m k n), kernel 9
# O(products), so the dense route is taken from MXM_DENSE_PER_MKN * m * k * n
# products on: the geometric mean of products / n^3 where the two routes
# took the same time on an H100 at n = 4096, 8192 and 11,585
# (tools/mxm_times.py --dense; PERF.md §6)
MXM_DENSE_PER_MKN = 6.14e-4


def _init_is_zero(init) -> bool:
    """``init`` (a number, or a ``Scalar``'s ``.value``) equals 0; a tensor
    off the CPU is not read (that would wait for its stream) and counts as
    no."""
    value = init.value if hasattr(init, "value") else init
    if isinstance(value, torch.Tensor):
        if value.device.type != "cpu" or value.numel() != 1:
            return False
        value = value.item()
    try:
        return float(value) == 0.0
    except (TypeError, ValueError):
        return False


def mxm_dense_gate(op_mul, op_add, dtypes, init, m: int, k: int, n: int, products: int, finite) -> bool:
    """Whether ``mxm`` takes the dense route for A (m x k) times B (k x n):
    MULT/PLUS by name, both ``dtypes`` f32, ``init`` 0 (``_init_is_zero``),
    no operand or result over ``MXM_DENSE_CAP`` elements, and at least
    ``MXM_DENSE_MIN_PRODUCTS`` products and ``MXM_DENSE_PER_MKN * m * k *
    n`` of them (spla_tpu's ``_mxm_dense_try``, ``spla_tpu/ops/spgemm.py:441-463``,
    with the port's density gate); last, ``finite()`` (which may read the
    host) must hold: a stored inf or NaN times an absent entry's 0 would
    make NaN at slots that no product reaches."""
    return ((getattr(op_mul, "name", None), getattr(op_add, "name", None)) == ("MULT", "PLUS")
            and all(d == torch.float32 for d in dtypes)
            and _init_is_zero(init)
            and max(m * k, k * n, m * n) <= MXM_DENSE_CAP
            and products >= max(MXM_DENSE_MIN_PRODUCTS, MXM_DENSE_PER_MKN * m * k * n)
            and finite())


def _dense0(M: CsrMatrix, rows: int, cols: int, dtype=torch.float32, pattern: bool = False) -> torch.Tensor:
    """M as a dense ``rows x cols`` matrix (at least M's shape) of ``dtype``
    with an explicit zero fill (whatever M's fill), duplicates added, or
    with ``pattern`` 1 at each stored (i, j); padding entries go to a dump
    slot past the end (``dense0``'s dump row and column,
    ``spla_tpu/ops/spgemm.py:471-476``), so nothing reads ``nnz`` on the
    host."""
    valid = M.valid_mask()
    size = rows * cols
    at = torch.where(valid, M.row_ids.long() * cols + M.cols.long(), size)
    out = torch.zeros(size + 1, dtype=dtype, device=M.values.device)
    if pattern:
        out.index_fill_(0, at, 1)
    else:
        out.index_add_(0, at, torch.where(valid, M.values, 0).to(dtype))
    return out[:size].view(rows, cols)


def _reached(A: CsrMatrix, B: CsrMatrix) -> int:
    """The number of distinct (i, j) that products reach: the nonzeros of
    A's 0/1 pattern times B's, a bf16 matmul on the tensor cores (sums of
    ones stay above 0 in any order or precision), its inner and column
    dimensions padded with zeros to a multiple of 8 (cuBLAS takes the
    tensor cores' fast path only for 16-byte aligned rows).  One host read."""
    (m, k), n = A.shape, B.shape[1]
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    reach = torch.matmul(_dense0(A, m, kp, torch.bfloat16, True), _dense0(B, kp, np_, torch.bfloat16, True))
    return int(torch.count_nonzero(reach))


def _dense_matmul(Ad: torch.Tensor, Bd: torch.Tensor) -> torch.Tensor:
    """``Ad @ Bd`` in full IEEE f32 (``precision=HIGHEST``), whatever the
    caller's TF32 setting, which is restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(Ad, Bd)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _compact_dense(R: torch.Tensor, capacity: int) -> CsrMatrix:
    """CSR of R's nonzeros in row-major order, at most ``capacity`` (the
    first ones, ``nnz`` then the capacity), padding row m, column 0, value
    0; compacted on the device (``formats.compact``), indptr from each
    row's kept count."""
    m, n = R.shape
    keep = R != 0
    zero = torch.zeros((), dtype=R.dtype, device=R.device)
    kept = compact(R.reshape(-1), keep.reshape(-1), capacity, zero)
    ptr = torch.zeros(m + 1, dtype=torch.long, device=R.device)
    torch.cumsum(keep.sum(1), 0, out=ptr[1:])
    at = kept.indices  # int32 (m n <= MXM_DENSE_CAP); the padding's m n gives row m, column 0
    return CsrMatrix(shape=(m, n), indptr=ptr.clamp(max=capacity).to(torch.int32), cols=at % n,
                     values=kept.values, row_ids=torch.div(at, n, rounding_mode="floor"), nnz=kept.nnz, fill=zero)


def _mxm_dense(A: CsrMatrix, B: CsrMatrix, out_capacity: int | None = None) -> CsrMatrix:
    """``mxm``'s dense route for MULT/PLUS f32 with init 0, on any device
    (spla_tpu's ``_mxm_dense``, ``spla_tpu/ops/spgemm.py:466-494``): A and B
    densified with zero fill, one full-f32 matmul, the nonzeros compacted
    in row-major order.  The same CSR as kernel 9's for the request: the
    capacity is ``out_capacity`` or else the number of distinct (i, j) that
    products reach (``_reached``, the one host read; none with
    ``out_capacity``), not the kept count.  Stored values must be finite
    (``mxm_dense_gate``)."""
    K9._check_shapes(A, B)
    (m, k), n = A.shape, B.shape[1]
    capacity = int(out_capacity) if out_capacity is not None else _reached(A, B)
    return _compact_dense(_dense_matmul(_dense0(A, m, k), _dense0(B, k, n)), capacity)


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
