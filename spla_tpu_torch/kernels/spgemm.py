"""Kernel 9: the row-wise Gustavson SpGEMM (``csrc/spgemm.cu``) and its plain version.

``mxm`` computes, for A of shape (m, k) and B of shape (k, n)::

    C[i, j] = init (+) fold_(+) { mul(A[i, p], B[p, j]) : p stored in row i of A and row p of B }

over the pairs (i, j) that some product reaches; entries equal to ``init``
are not stored (the reference's ``R_tmp[j] != I``, ``cpu_mxm.hpp:109-113``).
C's rows are sorted by column.  Kernel 9 replaces the Pallas ESC path of
``spla_tpu/ops/spgemm.py`` (``_mxm_pallas_try`` :213 and
``_mxm_esc_numeric`` :196: three ``balanced_fused_apply`` passes into
``spla_tpu/pallas/spmv.py`` ``fused_cell_spmv_apply`` :2055); its plain
version, ``mxm_plain``, is the expand / sort / fold of ``_mxm_numeric``
(:584) with its product windows (``_mxm_blocked`` :550).

The kernel runs in three steps, each one C call: a symbolic phase counts
each row's distinct columns; their prefix sum is C's layout, whose total
is read on the host once to allocate C; a numeric phase folds each row's
products and writes its entries in column order, those equal to ``init``
left out, at the row's place in that layout; a compaction closes the gaps
the left-out entries leave, on the device (it moves nothing when no entry
was left out).  Both phases take each row in one of three bins of
``mxm_plan``, by its product count: up to ``SMALL_MAX`` products a warp
with a hash table in shared memory, its entries ranked; up to
``MEDIUM_MAX`` a CTA (512 threads in the numeric phase) with a larger
one (a launch for each table size in ``MEDIUM_SLOTS``), its kept entries
radix-sorted by column straight into C; more, in the numeric
phase, a thread-block cluster of ``CLUSTER`` CTAs that holds the row's
values for a window of columns in their shared memory and folds into it
through distributed shared memory (``cluster_shape``; with a NaN
``init`` each product also marks its column in a bitmap there, since NaN
(+) identity is not equal to NaN), and in the
symbolic phase a CTA with an occupancy bitmap of ``LARGE_WORDS`` words at
most.  Nothing but C and the compaction's scratch is allocated.  The CUDA
source's header says what bounds the kernel and how it is laid out.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..containers import CooMatrix, CsrMatrix
from ..formats import compact, coo_to_csr, derived
from ..utils.primitives import expand_schedule
from ..utils.segments import scalar_on, segmented_scan_fold
from . import LAUNCHES
from .build import check, load_library
from .spmv import PULL_ADDS, TEMPLATED_MULS, _init_arg, _on_cpu, _ptr, _require_cuda, semiring_codes

__all__ = [
    "MXM_BLOCK_THRESHOLD",
    "MXM_BLOCK_P",
    "SMALL_MAX",
    "MEDIUM_MAX",
    "CLUSTER",
    "MxmPlan",
    "mxm_plan",
    "mxm_codes",
    "cluster_shape",
    "radix_passes",
    "mxm",
    "mxm_plain",
]

# spla_tpu/ops/spgemm.py:368-369: past this many products the plain version
# folds windows of MXM_BLOCK_P products and merges them, so its memory is
# O(window + output)
MXM_BLOCK_THRESHOLD = 1 << 24
MXM_BLOCK_P = 1 << 22

SMALL_MAX = 512  # products of a small row: a warp, a table of at most 2 * SMALL_MAX slots (kSmallMax)
MEDIUM_MAX = 8192  # of a medium row: a CTA, a table of at most 2 * MEDIUM_MAX slots (kMediumMax)
MEDIUM_SLOTS = (2048, 4096, 8192, 16384)  # the medium tables, a launch each (kMediumLog2Min, kMediumClasses)
LARGE_WORDS = 48 * 1024  # the symbolic phase's bitmap of a large row, 32-bit words: a window of 1,572,864 columns
CLUSTER = 16  # CTAs of a large row's cluster (numeric phase); 16, non-portable, beat 8 on the skewed graph
LARGE_SHARED_BYTES = 227 * 1024  # shared memory a CTA may have (H100: 232,448 bytes)
LARGE_STATIC_BYTES = 9 * 1024  # a numeric large CTA's own shared memory besides its values and bitmap


def mxm_codes(op_mul, op_add, dtype):
    """``(mul, add, dtype)`` codes when kernel 9 covers the request, else None:
    every built-in mul in f32 with add in {PLUS, MIN, MAX} (spla_tpu's
    Pallas ESC gate, ``_mxm_pallas_try``, ``spla_tpu/ops/spgemm.py:213``),
    and in i32 PLUS, MULT, FIRST, SECOND, MIN and MAX (the JAX path has no
    i32 kernel; the port had these before it took every f32 mul)."""
    if dtype not in (torch.float32, torch.int32):
        return None
    codes = semiring_codes(op_mul, op_add, dtype, int_adds=PULL_ADDS)
    if codes is None or (dtype == torch.int32 and codes[0] not in TEMPLATED_MULS):
        return None
    return codes


def _check_shapes(A: CsrMatrix, B: CsrMatrix):
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"mxm: shapes A {A.shape} and B {B.shape} do not fit A x B")


def _entry_products(A: CsrMatrix, B: CsrMatrix) -> torch.Tensor:
    """int64 products of each of A's entries: the length of B's row at its
    column (0 past the stored entries)."""
    k = A.shape[1]
    deg_b = (B.indptr[1:] - B.indptr[:-1]).long()
    cols = A.cols.long().clamp(0, max(k - 1, 0))
    return torch.where(A.valid_mask(), deg_b[cols], 0) if k else torch.zeros_like(cols)


# ---------------------------------------------------------------- the plain version


def _windows(ends: torch.Tensor, blk: int):
    """``[(e0, e1, products)]``: consecutive ranges of whole A entries of at
    most ``blk`` products each (more only for a single entry), from the
    inclusive prefix sum ``ends`` of the entries' products."""
    ends = ends.cpu().numpy()
    out, e0, base = [], 0, 0
    while e0 < ends.size and base < ends[-1]:
        e1 = max(int(np.searchsorted(ends, base + blk, side="right")), e0 + 1)
        if ends[e1 - 1] > base:
            out.append((e0, e1, int(ends[e1 - 1]) - base))
        e0, base = e1, int(ends[e1 - 1])
    return out


def _fold_runs(keys, values, op_add):
    """Fold the runs of equal ``keys`` (sorted, in order) with ``op_add``:
    each run's key and its left-to-right fold."""
    if keys.numel() == 0:
        return keys, values
    heads = torch.ones_like(keys, dtype=torch.bool)
    heads[1:] = keys[1:] != keys[:-1]
    folded, _ = segmented_scan_fold(values, torch.ones_like(heads), heads, op_add)
    tails = torch.ones_like(heads)
    tails[:-1] = heads[1:]
    return keys[tails], folded[tails]


def _window_runs(A, B, op_mul, op_add, deg, e0, e1, count):
    """Expand A entries [e0, e1) (``deg`` products each, in order) into
    their ``count`` products, sort them stably by ``i * n + j`` and fold each
    (i, j)'s run: returns the runs' keys and folds."""
    n = B.shape[1]
    src, local, _ = expand_schedule(deg[e0:e1], deg[e0:e1] > 0, count)
    e = e0 + src.long()
    kk = A.cols[e].long().clamp(0, max(B.shape[0] - 1, 0))
    b_pos = (B.indptr[kk].long() + local).clamp(0, max(B.capacity - 1, 0))
    keys = A.row_ids[e].long() * n + B.cols[b_pos].long()
    prod = op_mul(A.values[e], B.values[b_pos])
    keys, order = torch.sort(keys, stable=True)
    return _fold_runs(keys, prod[order], op_add)


def mxm_plain(A: CsrMatrix, B: CsrMatrix, op_mul, op_add, init, products_cap: int | None = None,
              out_capacity: int | None = None, block_products: int | None = None) -> CsrMatrix:
    """Plain PyTorch version of kernel 9 for any semiring: the expand / sort /
    fold of ``spla_tpu/ops/spgemm.py`` ``_mxm_numeric`` (an ``index_select``
    where it has ``_monotone_gather``) and ``_run_fold_compact``.

    Products past ``products_cap``, in expansion order (A's entries in
    order, each over B's row), are dropped.  Past ``MXM_BLOCK_THRESHOLD``
    products, or with ``block_products``, the products are folded in
    windows of whole A entries of about that many products (default
    ``MXM_BLOCK_P``) and the windows' runs merged (``_mxm_blocked``,
    ``_mxm_merge``), so memory stays O(window + output).  ``init`` is
    folded in once, in every case.  The result's capacity is
    ``out_capacity`` or else the number of distinct (i, j) that the kept
    products reach; with more entries than ``out_capacity`` the first ones
    in (row, column) order are stored and ``nnz`` is the capacity."""
    _check_shapes(A, B)
    m, n = A.shape[0], B.shape[1]
    device = A.values.device
    init_t = torch.as_tensor(init.value if hasattr(init, "value") else init, dtype=A.values.dtype,
                             device=device)
    deg = _entry_products(A, B)
    ends = torch.cumsum(deg, 0)
    if products_cap is not None:
        cap = int(products_cap)
        deg = ends.clamp(max=cap) - (ends - deg).clamp(max=cap)
        ends = torch.cumsum(deg, 0)
    total = int(ends[-1]) if ends.numel() else 0
    blk = block_products
    if blk is None and total > MXM_BLOCK_THRESHOLD:
        blk = MXM_BLOCK_P
    if blk is None or total <= blk:
        windows = [(0, deg.shape[0], total)] if total else []
    else:
        windows = _windows(ends, int(blk))
    runs = [_window_runs(A, B, op_mul, op_add, deg, *w) for w in windows]
    keys = torch.cat([r[0] for r in runs]) if runs else torch.zeros(0, dtype=torch.long, device=device)
    vals = torch.cat([r[1] for r in runs]) if runs else torch.zeros(0, dtype=A.values.dtype, device=device)
    if len(runs) > 1:  # a row's products may span windows: merge their runs in window order
        keys, order = torch.sort(keys, stable=True)
        keys, vals = _fold_runs(keys, vals[order], op_add)
    out_cap = int(out_capacity) if out_capacity is not None else keys.numel()
    if keys.numel() == 0:  # no product
        pad = torch.zeros(out_cap, dtype=torch.int32, device=device)
        return coo_to_csr(CooMatrix(shape=(m, n), rows=pad + m, cols=pad, values=init_t.expand(out_cap).clone(),
                                    nnz=torch.zeros((), dtype=torch.int32, device=device), fill=init_t))
    folded = op_add(init_t.expand(vals.shape), vals)
    kept = compact(folded, folded != init_t, out_cap, init_t)
    ok = kept.indices < keys.numel()
    key = keys[kept.indices.clamp(max=keys.numel() - 1).long()]
    return coo_to_csr(CooMatrix(
        shape=(m, n),
        rows=torch.where(ok, torch.div(key, n, rounding_mode="floor"), m).to(torch.int32),
        cols=torch.where(ok, key % n, 0).to(torch.int32),
        values=kept.values,
        nnz=kept.nnz,
        fill=init_t,
    ))


# ---------------------------------------------------------------- the plan


@dataclass(frozen=True)
class MxmPlan:
    """Kernel 9's bins for one A against one B, on their device: ``rows``
    lists A's rows, the ``nsmall`` rows of at most ``SMALL_MAX`` products
    first, then the rows of at most ``MEDIUM_MAX`` by the size of their
    table (``medium_counts[c]`` rows of ``MEDIUM_SLOTS[c]`` slots, the
    least at or above twice their products), then the ``nlarge`` others,
    each group in row order.  ``row_products`` (int64 [m]) is each row's
    product count, ``products`` their sum."""

    rows: torch.Tensor  # int32 [m]
    row_products: torch.Tensor  # int64 [m]
    nsmall: int
    medium_counts: tuple
    nlarge: int
    products: int

    @property
    def nmedium(self) -> int:
        return sum(self.medium_counts)


def mxm_plan(A: CsrMatrix, B: CsrMatrix) -> MxmPlan:
    """The plan of A against B, built on their device, a fact of A.indptr,
    A.cols, A.nnz and B.indptr; the groups' row counts and the product total
    are read on the host once, at the first build."""
    _check_shapes(A, B)
    return derived(mxm_plan, (A.indptr, A.cols, A.nnz, B.indptr), lambda: _mxm_plan(A, B))


def _mxm_plan(A: CsrMatrix, B: CsrMatrix) -> MxmPlan:
    m = A.shape[0]
    device = A.cols.device
    ends = torch.zeros(A.capacity + 1, dtype=torch.long, device=device)
    torch.cumsum(_entry_products(A, B), 0, out=ends[1:])
    ip = A.indptr.long()
    row_products = ends[ip[1:]] - ends[ip[:-1]]
    # 0 small, 1 + c medium with tables of MEDIUM_SLOTS[c] slots, 5 large
    table = sum((2 * row_products > slots).long() for slots in MEDIUM_SLOTS[:-1])
    group = torch.where(row_products <= SMALL_MAX, 0,
                        torch.where(row_products <= MEDIUM_MAX, 1 + table, 1 + len(MEDIUM_SLOTS)))
    counts = torch.cat([torch.bincount(group, minlength=2 + len(MEDIUM_SLOTS)), ends[-1:]]).tolist()
    rows = torch.argsort(group, stable=True).to(torch.int32)
    return MxmPlan(rows, row_products, counts[0], tuple(counts[1:-2]), counts[-2], counts[-1])


def cluster_shape(n: int, sms: int, shared_bytes: int, cluster: int | None = None) -> tuple:
    """``(C, W, windows)`` of the numeric phase's large rows for B of ``n``
    columns on a card of ``sms`` SMs whose CTAs may have ``shared_bytes``
    of shared memory: a cluster of C CTAs (``cluster``, default
    ``CLUSTER``, at most the SMs, a power of two), each holding W values
    and W bits (the least power of two, at least 32, that lets C of them
    cover n, and at most what its shared memory holds besides
    ``LARGE_STATIC_BYTES``: 33 bits a column), so a row is walked once for
    each of ``windows`` windows of C x W columns."""
    c = 1 << (max(1, min(CLUSTER if cluster is None else cluster, sms)).bit_length() - 1)
    fit = (shared_bytes - LARGE_STATIC_BYTES) * 8 // 33
    if fit < 32:
        raise ValueError(f"cluster_shape: {shared_bytes} bytes of shared memory hold no 32 columns")
    w = min(max(32, 1 << max(-(-n // c) - 1, 0).bit_length()), 1 << (fit.bit_length() - 1))
    return c, w, max(1, -(-n // (c * w)))


def radix_passes(n: int) -> int:
    """8-bit digits of the medium rows' radix sort: the bytes of column n - 1, at least 1."""
    return max(1, -(-max(n - 1, 0).bit_length() // 8))


# ---------------------------------------------------------------- the kernel


def mxm(A: CsrMatrix, B: CsrMatrix, op_mul, op_add, init, out_capacity: int | None = None) -> CsrMatrix:
    """Kernel 9: C = A (+).(x) B with init-valued results dropped, rows
    sorted by column.  CPU tensors take the plain version; CUDA tensors
    launch the kernel, and a request it does not cover raises.  Reads the
    host once (the size of C's layout) besides the plan's first build.
    Capacity and ``nnz`` as in ``mxm_plain``: ``out_capacity``, or else the
    number of distinct (i, j) that products reach."""
    if _on_cpu(A.values, B.values):
        return mxm_plain(A, B, op_mul, op_add, init, out_capacity=out_capacity)
    what = "spgemm_mxm"
    codes = mxm_codes(op_mul, op_add, A.values.dtype)
    if codes is None:
        raise NotImplementedError(
            f"{what}: no kernel instance for mul={getattr(op_mul, 'key', op_mul)}, "
            f"add={getattr(op_add, 'key', op_add)}, dtype={A.values.dtype}")
    _require_cuda(what, A, {}, {})
    _require_cuda(what, B, {}, {})
    if B.values.device != A.values.device:
        raise ValueError(f"{what}: B is on {B.values.device}, A on {A.values.device}")
    if B.values.dtype != A.values.dtype:
        raise TypeError(f"{what}: B is {B.values.dtype}, A {A.values.dtype}")
    _check_shapes(A, B)
    m, n = A.shape[0], B.shape[1]
    device = A.values.device
    fill = scalar_on(init, A.values.dtype, A.values.device)
    init_t, init_bits = _init_arg(fill, A.values)
    plan = mxm_plan(A, B)
    cluster, width = 1, 32  # the large bin's shape, asked for only when it has rows
    if plan.nlarge:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        cluster, width, _ = cluster_shape(n, sms, LARGE_SHARED_BYTES)
    lib = load_library()
    stream = torch.cuda.current_stream(device).cuda_stream
    bins = (plan.rows.data_ptr(), plan.nsmall, *plan.medium_counts, plan.nlarge, plan.row_products.data_ptr())
    operands = (A.indptr.data_ptr(), A.cols.data_ptr(), B.indptr.data_ptr(), B.cols.data_ptr())
    row_nnz = torch.empty(m, dtype=torch.int32, device=device)
    check(lib.spla_mxm_symbolic(m, n, *operands, *bins, min((n + 31) // 32, LARGE_WORDS), row_nnz.data_ptr(),
                                stream), what)
    sym = torch.zeros(m + 1, dtype=torch.long, device=device)
    torch.cumsum(row_nnz, 0, out=sym[1:])
    total = int(sym[m])  # C's layout: the one host read
    if total >= 1 << 31:
        raise ValueError(f"{what}: C would hold {total} entries; the CSR's int32 indices hold < 2^31")
    size = max(total, out_capacity or 0)
    cols = torch.empty(size, dtype=torch.int32, device=device)
    vals = torch.empty(size, dtype=A.values.dtype, device=device)
    rows = torch.empty(size, dtype=torch.int32, device=device)
    kept = torch.empty(m, dtype=torch.int32, device=device)
    check(lib.spla_mxm_numeric(*codes, m, n, A.indptr.data_ptr(), A.cols.data_ptr(),
                               A.values.data_ptr(), B.indptr.data_ptr(), B.cols.data_ptr(), B.values.data_ptr(),
                               *bins, cluster, width.bit_length() - 1, radix_passes(n), sym.data_ptr(),
                               _ptr(init_t), init_bits, cols.data_ptr(), vals.data_ptr(), rows.data_ptr(),
                               kept.data_ptr(), stream), what)
    ptr = torch.zeros(m + 1, dtype=torch.long, device=device)
    torch.cumsum(kept, 0, out=ptr[1:])
    tmp_cols = torch.empty(total, dtype=torch.int32, device=device)
    tmp_vals = torch.empty(total, dtype=A.values.dtype, device=device)
    check(lib.spla_mxm_compact(m, size, sym.data_ptr(), ptr.data_ptr(), kept.data_ptr(), cols.data_ptr(),
                               vals.data_ptr(), rows.data_ptr(), tmp_cols.data_ptr(), tmp_vals.data_ptr(),
                               _ptr(init_t), init_bits, stream), what)
    LAUNCHES[what] += 1
    cap = out_capacity if out_capacity is not None else total
    if cap < size:  # more entries than out_capacity: the first ones
        cols, vals, rows = cols[:cap].clone(), vals[:cap].clone(), rows[:cap].clone()
    return CsrMatrix(shape=(m, n), indptr=ptr.clamp(max=cap).to(torch.int32), cols=cols, values=vals,
                     row_ids=rows, nnz=ptr[m].clamp(max=cap).to(torch.int32), fill=fill)
