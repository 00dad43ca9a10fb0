"""Distributed SpGEMM (counterpart of ``spla_tpu/parallel/dist_spgemm.py``).

A and B are block-row sharded; the result keeps A's row partition, so
each rank merges the products of its own rows.  The rows of B that a
rank needs live on the others: B's blocks rotate around the ring
(``comm.ppermute``), and at step s rank p holds block ``(p + s) % S`` and
expands exactly the products whose inner index falls in that block.
After S steps (S - 1 rotations) every product has been made once, and each
rank has received all of B once.

* ``dist_mxm`` is plain PyTorch, as the JAX package's is plain XLA: each
  step expands its products into slots sized by the symbolic phase, then
  one sort by (row, column) and a fold of each run; ``init`` is folded in
  once and results equal to it are dropped.
* ``dist_mxmT_masked_reduce`` (and ``dist_tc`` over it) splits this rank's
  selected mask entries by the block that owns their column, once, before
  the ring.  At each step the entries of the held block, their columns
  rebased to its rows, are intersected with A's local rows: kernel 4
  (``kernels.mxmt.mxmt_reduce``) on CUDA tensors when it covers the
  product, which sums in int64 (float64 for f32); otherwise the plain
  version, which sums in the value dtype (int32 wraps), as the JAX
  package's does.  The rank's partial sums meet in one ``psum``.
* The symbolic phase (``count_dist_mxm_cap``) needs every block's row
  lengths of B: one gather of B's ``indptr``, then a ``pmax`` of the
  ranks' largest step.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import op as OP
from ..containers import CooMatrix, CsrMatrix
from ..formats import compact, coo_to_csr
from ..kernels import mxmt as K4
from ..kernels.spgemm import _fold_runs
from ..ops.spmv import DISPATCH_STATS
from ..types import type_from_dtype
from ..utils.primitives import expand_schedule
from ..utils.segments import scalar_on
from .comm import all_gather, pmax, ppermute, psum
from .dist_matrix import ShardedCsr
from .mesh import Mesh

__all__ = ["dist_mxm", "dist_mxmT_masked_reduce", "dist_tc", "count_dist_mxm_cap", "count_dist_mxmT_cap"]


def _expansion_cap(mesh: Mesh, left: ShardedCsr, B: ShardedCsr) -> int:
    """The symbolic phase: the most product slots any (rank, ring step)
    expands, one per (entry of ``left``, element of the B row its column
    names); exact, from the row lengths of every block of B."""
    deg_b = np.diff(all_gather(mesh, B.indptr).cpu().numpy().astype(np.int64).reshape(B.n_shards, -1), axis=1)
    cols = left.cols[:int(left.nnz)].cpu().numpy().astype(np.int64)
    owner = np.clip(cols // B.mloc, 0, B.n_shards - 1)
    counts = np.bincount(owner, weights=deg_b[owner, cols - owner * B.mloc], minlength=B.n_shards)
    local = max(int(counts.max(initial=0)), 1)
    return int(pmax(mesh, torch.tensor([local], dtype=torch.int64, device=B.device)).item())


def count_dist_mxm_cap(mesh: Mesh, A: ShardedCsr, B: ShardedCsr) -> int:
    """Product slots a ring step of ``dist_mxm(mesh, A, B)`` needs (the largest over ranks and steps)."""
    return _expansion_cap(mesh, A, B)


def count_dist_mxmT_cap(mesh: Mesh, mask: ShardedCsr, B: ShardedCsr) -> int:
    """Product slots a ring step of ``dist_mxmT_masked_reduce(mesh, mask, _, B)`` needs."""
    return _expansion_cap(mesh, mask, B)


def _held(B: ShardedCsr):
    return [B.indptr, B.cols, B.values, B.row_ids]


def _block(held, mloc: int, n_cols: int, fill) -> CsrMatrix:
    indptr, cols, values, row_ids = held
    return CsrMatrix(shape=(mloc, n_cols), indptr=indptr, cols=cols, values=values, row_ids=row_ids,
                     nnz=indptr[mloc], fill=fill)


def dist_mxm(mesh: Mesh, A: ShardedCsr, B: ShardedCsr, op_mul, op_add, init, products_cap: int | None = None,
             out_capacity: int | None = None, axis: str = "d") -> ShardedCsr:
    """This rank's rows of ``R = A (+).(x) B``, row-sharded like A; results
    equal to ``init`` are not stored (``spla_tpu.ops.mxm``'s semantics).

    ``products_cap`` is the slots a ring step expands (default: the exact
    largest, ``count_dist_mxm_cap``); later products of a step are dropped.
    The result's capacity is ``out_capacity``, or else the largest rank's
    count of distinct (i, j) that products reach, so every rank's block has
    one capacity; with more entries than the capacity the first ones in
    (row, column) order are stored and ``nnz`` is the capacity (the JAX
    package reports the uncut count)."""
    m, k = A.shape
    k2, n = B.shape
    if k != k2:
        raise ValueError(f"dist_mxm: shapes A {A.shape} and B {B.shape} do not fit A x B")
    cap = max(int(products_cap if products_cap is not None else count_dist_mxm_cap(mesh, A, B)), 1)
    device = A.device
    init_t = scalar_on(init, A.values.dtype, device)
    a_valid = torch.arange(A.capacity, device=device) < A.nnz
    a_cols = A.cols.long()
    dump = A.mloc * n  # the key past every (row, column) of this rank
    held, keys, vals = _held(B), [], []
    for s in range(mesh.size):
        lo = ((mesh.rank + s) % mesh.size) * B.mloc
        bi, bc, bv, _ = held
        in_range = a_valid & (a_cols >= lo) & (a_cols < lo + B.mloc)
        bl = (a_cols - lo).clamp(0, B.mloc - 1)
        src, local, slot_ok = expand_schedule(bi[bl + 1] - bi[bl], in_range, cap)
        src = src.long()
        b_pos = (bi[bl[src]].long() + local).clamp(0, B.capacity - 1)
        keys.append(torch.where(slot_ok, A.row_ids[src].long() * n + bc[b_pos].long(), dump))
        vals.append(op_mul(A.values[src], bv[b_pos]))
        if s < mesh.size - 1:
            held = ppermute(mesh, held)
    keys, order = torch.sort(torch.cat(keys), stable=True)
    run_keys, run_vals = _fold_runs(keys, torch.cat(vals)[order], op_add)
    reached = run_keys < dump
    if out_capacity is None:
        out_capacity = int(pmax(mesh, reached.sum().reshape(1)).item())
    folded = op_add(init_t.expand(run_vals.shape), run_vals)
    kept = compact(folded, reached & (folded != init_t), max(int(out_capacity), 1), init_t)
    ok = kept.indices < run_keys.numel()
    key = run_keys[kept.indices.clamp(max=max(run_keys.numel() - 1, 0)).long()]
    R = coo_to_csr(CooMatrix(shape=(A.mloc, n),
                             rows=torch.where(ok, torch.div(key, n, rounding_mode="floor"), A.mloc).to(torch.int32),
                             cols=torch.where(ok, key % n, 0).to(torch.int32), values=kept.values,
                             nnz=kept.nnz, fill=init_t))
    return ShardedCsr(shape=(m, n), n_shards=A.n_shards, mloc=A.mloc, rank=A.rank, indptr=R.indptr,
                      cols=R.cols, values=R.values, row_ids=R.row_ids, nnz=R.nnz, fill=init_t)


def _split_mask(mask: ShardedCsr, keep, owner, n_shards: int, mloc_b: int) -> list:
    """Per owner t, the CSR (``mask.mloc`` x ``mloc_b``) of the kept entries
    whose column block is t, columns rebased to its rows, in mask order."""
    device = mask.device
    counts = torch.bincount(owner[keep], minlength=n_shards).tolist()
    out = []
    for t in range(n_shards):
        idx = torch.nonzero(keep & (owner == t)).flatten()
        cap = max(counts[t], 1)
        rows = torch.full((cap,), mask.mloc, dtype=torch.int32, device=device)
        cols = torch.zeros(cap, dtype=torch.int32, device=device)
        vals = torch.full((cap,), 0, dtype=mask.values.dtype, device=device)
        rows[:counts[t]] = mask.row_ids[idx]
        cols[:counts[t]] = mask.cols[idx] - t * mloc_b
        vals[:counts[t]] = mask.values[idx]
        nnz = torch.tensor(counts[t], dtype=torch.int32, device=device)
        out.append(coo_to_csr(CooMatrix(shape=(mask.mloc, mloc_b), rows=rows, cols=cols, values=vals, nnz=nnz,
                                        fill=mask.fill)))
    return out


def dist_mxmT_masked_reduce(mesh: Mesh, mask: ShardedCsr, A: ShardedCsr, B: ShardedCsr, op_mul, op_add,
                            op_select, init, products_cap: int | None = None, axis: str = "d"):
    """``init`` plus the sum of every product of ``R = (A x Bᵀ) masked by mask``
    over the mask entries ``op_select`` keeps, without forming R; every
    rank gets the same numpy scalar.  The mask and A share a row partition.

    On CUDA tensors, with no ``products_cap``, kernel 4 covers the product
    and sums in int64 (float64 for f32); otherwise the plain version sums
    in the value dtype, as the JAX package does (int32 wraps past 2^31),
    expanding ``products_cap`` slots a step if given (later products
    dropped).  PLUS is the only ``op_add``: the sum is fused into the ring."""
    if getattr(op_add, "name", None) not in (None, "PLUS"):
        raise NotImplementedError("dist_mxmT_masked_reduce folds with PLUS only (the reduction is fused "
                                  f"into the ring); got op_add={op_add.name}.")
    if mask.mloc != A.mloc:
        raise ValueError("the mask and A must share a row partition")
    device = A.device
    dtype = A.values.dtype
    kernel = (device.type == "cuda" and products_cap is None
              and K4.reduce_codes(op_mul, dtype) is not None)
    stored = torch.arange(mask.capacity, device=device) < mask.nnz
    owner = (mask.cols.long() // B.mloc).clamp(0, B.n_shards - 1)
    subs = _split_mask(mask, stored & op_select(mask.values), owner, B.n_shards, B.mloc)
    a_block = A.local_block(A.shape[1])
    acc, held = None, _held(B)
    for s in range(mesh.size):
        sub = subs[(mesh.rank + s) % mesh.size]
        b_block = _block(held, B.mloc, B.shape[1], B.fill)
        if kernel:
            DISPATCH_STATS["mxmT_kernel"] += 1
            part = K4.mxmt_reduce(sub, a_block, b_block, op_mul)
        else:
            DISPATCH_STATS["mxmT_torch"] += 1
            part = _reduce_plain(sub, a_block, b_block, op_mul, products_cap)
        acc = part if acc is None else acc + part  # the value dtype's add wraps, as JAX's
        if s < mesh.size - 1:
            held = ppermute(mesh, held)
    total = psum(mesh, acc.reshape(1)).cpu().numpy()[0]
    return total + np.asarray(init, total.dtype)


def _reduce_plain(sub: CsrMatrix, A: CsrMatrix, B: CsrMatrix, op_mul, products_cap):
    """One step's sum in the value dtype (wrapping, as the JAX package's)."""
    dtype = A.values.dtype
    if products_cap is None:
        return K4.mxmt_reduce_plain(sub, A, B, op_mul).to(dtype)
    out, has = K4.mxmt_masked_plain(sub, A, B, op_mul, OP.lookup("PLUS", type_from_dtype(dtype)), 0,
                                    products_cap=int(products_cap))
    return torch.where(has, out, 0).sum().to(dtype)


def dist_tc(mesh: Mesh, A: ShardedCsr, axis: str = "d") -> int:
    """Triangle count: the PLUS sum of ``(A x Aᵀ) masked by A`` (MULT, the
    GTZERO select), each triangle 6 times on a symmetric adjacency, as in
    the reference (``src/algorithm.cpp:380-414``).  Kernel 4 on CUDA
    tensors (summed in int64); on the CPU the value dtype's sum, as the JAX
    package's (an int32 sum wraps past 2^31)."""
    t = type_from_dtype(A.values.dtype)
    return int(dist_mxmT_masked_reduce(mesh, A, A, A, OP.lookup("MULT", t), OP.lookup("PLUS", t),
                                       OP.lookup("GTZERO", t), 0, axis=axis))
