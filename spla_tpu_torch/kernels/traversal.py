"""Kernel 2: the frontier push (``csrc/spmv_push.cu``) and its plain versions.

Replaces the sparse-frontier grid of ``spla_tpu/pallas/spmv.py``
``fused_spmv2d_adaptive`` (:2346).  For ``A`` of shape (n, m), a frontier
list ``front`` of row ids and ``x`` of length n::

    out[j] = init (+) fold_(+) { mul(A[i,j], x[i]) : i in front }

with (+) MIN or MAX; the structural variant sets ``hits[j]`` for every
column j of a frontier row.  ``A`` is CSR(A), the transpose of the ``At``
that the pull kernel walks (``formats.transpose_of``), so a pushed level
equals a pulled one.

The level loop's push levels fuse the push with kernel 3's update
(``bfs_push_level``, one launch; ``sssp_push_level``, the push and kernel
3's update of the vertices it touched, two launches).  They work on a run's
``frontier.LevelState`` and leave its depths or distances, its dense
frontier or changed set, the next list and its size exactly as
``spmv_push_structural`` / ``spmv_push`` followed by ``bfs_level_update`` /
``sssp_level_update`` leave them, which is their plain version; no pass
over n, no allocation and no host copy.  The kernels walk a list's edges in
equal pieces, by the degree prefix of the list (``frontier.degree_offsets``
is its plain version); the public entries compute that prefix on the
device.
"""

from __future__ import annotations

import torch

from .. import op as OP
from ..containers import CsrMatrix
from ..formats import derived
from ..op import KernelCode
from ..utils.segments import segment_fold
from . import LAUNCHES
from .build import check, load_library
from .frontier import LevelState, write_next_plain
from .level_update import bfs_update_plain, sssp_update_plain
from .spmv import DTYPE_CODES, TEMPLATED_MULS, _on_cpu, _require_cuda

__all__ = ["push_codes", "spmv_push", "spmv_push_plain", "spmv_push_structural",
           "spmv_push_structural_plain", "push_degrees", "bfs_push_level", "bfs_push_level_plain",
           "sssp_push_level", "sssp_push_level_plain"]

PUSH_ADDS = frozenset({KernelCode.MIN, KernelCode.MAX})


def push_codes(op_mul, op_add, dtype):
    """``(mul, add, dtype)`` kernel codes when kernel 2 covers the request
    (mul in ``TEMPLATED_MULS``, add MIN or MAX, f32 or i32), else None."""
    mul = getattr(op_mul, "kernel_code", None)
    add = getattr(op_add, "kernel_code", None)
    if mul not in TEMPLATED_MULS or add not in PUSH_ADDS or dtype not in (torch.float32, torch.int32):
        return None
    return int(mul), int(add), DTYPE_CODES[dtype]


def _frontier_entries(A: CsrMatrix, front):
    """(source row, entry index) of every stored entry in the frontier rows."""
    f = front.long()
    starts = A.indptr.long()[f]
    counts = A.indptr.long()[f + 1] - starts
    src = torch.repeat_interleave(f, counts)
    first = torch.repeat_interleave(starts - (torch.cumsum(counts, 0) - counts), counts)
    return src, first + torch.arange(src.shape[0], device=f.device)


def spmv_push_plain(A: CsrMatrix, front, x, op_mul, op_add, init):
    """Plain PyTorch version (frontier expansion + segment fold)."""
    src, e = _frontier_entries(A, front)
    prod = op_mul(A.values[e], x[src])
    valid = torch.ones(e.shape[0], dtype=torch.bool, device=e.device)
    out, _ = segment_fold(prod, A.cols[e], valid, A.shape[1], op_add, init, sorted_ids=False)
    return out


def spmv_push(A: CsrMatrix, front, x, op_mul, op_add, init):
    """Kernel 2 (value push).  ``front`` is an int32 list of row ids."""
    if _on_cpu(A.values, front, x):
        return spmv_push_plain(A, front, x, op_mul, op_add, init)
    what = "spmv_push"
    codes = push_codes(op_mul, op_add, A.values.dtype)
    if codes is None:
        raise NotImplementedError(
            f"{what}: no kernel instance for mul={getattr(op_mul, 'key', op_mul)}, "
            f"add={getattr(op_add, 'key', op_add)}, dtype={A.values.dtype}")
    n, m = A.shape
    _require_cuda(what, A, {"front": front, "x": x}, {"x": n})
    if front.dtype != torch.int32 or front.dim() != 1:
        raise TypeError(f"{what}: front must be a 1-d int32 tensor")
    if x.dtype != A.values.dtype:
        raise TypeError(f"{what}: x is {x.dtype}, the matrix {A.values.dtype}")
    # filled on the device: a host copy of init would wait for the stream
    if isinstance(init, torch.Tensor) and init.device.type == "cuda":
        out = torch.empty(m, dtype=x.dtype, device=x.device).copy_(init.expand(m))
    else:
        value = init.item() if isinstance(init, torch.Tensor) else init
        out = torch.full((m,), value, dtype=x.dtype, device=x.device)
    k = front.shape[0]
    if k == 0:
        return out
    eoff, csum, edges = _device_offsets(A, front)
    rc = load_library().spla_spmv_push(
        *codes, k, edges, front.data_ptr(), eoff.data_ptr(), csum[k - 1:].data_ptr(),
        A.indptr.data_ptr(), A.cols.data_ptr(), A.values.data_ptr(), x.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, what)
    LAUNCHES["spmv_push"] += 1
    return out


def push_degrees(A: CsrMatrix):
    """``(deg, longest)``: the out-degrees of CSR(A)'s rows (int32, on A's
    device) and the longest, which bounds a list's edges by its length;
    a fact of the indptr tensor, one host read at the first call."""
    return derived(push_degrees, (A.indptr,), lambda: _degrees(A.indptr))


def _degrees(indptr):
    deg = indptr[1:] - indptr[:-1]
    return deg, int(deg.max()) if deg.numel() else 0


def _device_offsets(A: CsrMatrix, front):
    """A frontier list's degree offsets, their running sum (its last entry
    is the list's edge count, on the device) and a bound of that count."""
    deg_all, longest = push_degrees(A)
    deg = torch.index_select(deg_all, 0, front)
    csum = torch.cumsum(deg, 0, dtype=torch.int32)
    return csum - deg, csum, min(A.cols.shape[0], front.shape[0] * longest)


def spmv_push_structural_plain(A: CsrMatrix, front):
    _, e = _frontier_entries(A, front)
    hits = torch.zeros(A.shape[1], dtype=torch.bool, device=front.device)
    hits[A.cols[e].long()] = True
    return hits


def spmv_push_structural(A: CsrMatrix, front):
    """Structural kernel 2: bool ``hits`` of length m, set at every column
    of a frontier row."""
    if _on_cpu(A.cols, front):
        return spmv_push_structural_plain(A, front)
    what = "spmv_push_structural"
    _require_cuda(what, A, {"front": front}, {})
    if front.dtype != torch.int32 or front.dim() != 1:
        raise TypeError(f"{what}: front must be a 1-d int32 tensor")
    hits = torch.zeros(A.shape[1], dtype=torch.bool, device=front.device)
    k = front.shape[0]
    if k == 0:
        return hits
    eoff, csum, edges = _device_offsets(A, front)
    rc = load_library().spla_spmv_push_structural(
        k, edges, front.data_ptr(), eoff.data_ptr(), csum[k - 1:].data_ptr(),
        A.indptr.data_ptr(), A.cols.data_ptr(), hits.data_ptr(),
        torch.cuda.current_stream(front.device).cuda_stream)
    check(rc, what)
    LAUNCHES["spmv_push"] += 1
    return hits


# ---------------------------------------------------------------- the fused push levels


def _level_args(S: LevelState):
    """The current list (k, E, slots, offsets, size word) and the next one
    (slots, offsets, size word, and the word to clear) as C arguments."""
    L, P, row = S.level, S.ptr, 4 * S.n
    lists, eoff, words = P["lists"], P["eoff"], P["words"]
    cur, nxt = L % 2, (L + 1) % 2
    # the low 32 bits of the little-endian size word: the list's edge count
    return ((S.k, S.edges, lists + cur * row, eoff + cur * row, words + 8 * (L % 3)),
            (lists + nxt * row, eoff + nxt * row, words + 8 * ((L + 1) % 3), words + 8 * ((L + 2) % 3)))


def bfs_push_level_plain(S: LevelState) -> None:
    """spmv_push_structural followed by bfs_level_update's plain version."""
    hits = spmv_push_structural_plain(S.A, S.lists[S.level % 2, :S.k])
    write_next_plain(S, bfs_update_plain(hits, S.v, S.mask, S.level + 1))


def bfs_push_level(S: LevelState) -> None:
    """A BFS push level at depth ``S.level + 1``, in one launch."""
    if S.v.device.type == "cpu":
        return bfs_push_level_plain(S)
    (k, edges, *cur), nxt = _level_args(S)
    P = S.ptr
    rc = load_library().spla_bfs_push_level(
        k, edges, *cur, P["indptr"], P["cols"], P["v"], P["mask"], P["vis"], S.level + 1, *nxt,
        torch.cuda.current_stream(S.v.device).cuda_stream)
    check(rc, "bfs_push_level")
    LAUNCHES["bfs_push_level"] += 1
    S.level += 1


def sssp_push_level_plain(S: LevelState) -> None:
    """spmv_push (PLUS, MIN) followed by sssp_level_update's plain version."""
    inf = float("inf")
    hits = spmv_push_plain(S.A, S.lists[S.level % 2, :S.k], S.v, OP.PLUS_FLOAT, OP.MIN_FLOAT, inf)
    write_next_plain(S, sssp_update_plain(hits, S.v, S.mask))


def sssp_push_level(S: LevelState) -> None:
    """An SSSP push level (f32 PLUS / MIN), in two launches: the push, and
    kernel 3's update of the vertices it touched."""
    if S.v.device.type == "cpu":
        return sssp_push_level_plain(S)
    (k, edges, *cur), nxt = _level_args(S)
    P, pushes = S.ptr, S.pushes
    rc = load_library().spla_sssp_push_level(
        k, edges, S.n, *cur, P["indptr"], P["cols"], P["values"], P["v"], P["hits"], P["mask"],
        P["touched"], P["tcount"] + 4 * (pushes % 2), P["tcount"] + 4 * ((pushes + 1) % 2), *nxt,
        torch.cuda.current_stream(S.v.device).cuda_stream)
    check(rc, "sssp_push_level")
    LAUNCHES["sssp_push_level"] += 2
    S.level += 1
    S.pushes = pushes + 1
