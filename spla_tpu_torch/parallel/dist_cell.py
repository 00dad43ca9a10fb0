"""The sharded kernel SpMV (counterpart of ``spla_tpu/parallel/dist_cell.py``).

The JAX package packs each rank's row block into its TPU cell format and
runs ``fused_cell_spmv_apply`` (``spla_tpu/pallas/spmv.py:2055``) on it
under ``shard_map``.  Here each rank's block is ``dist_matrix``'s CSR
block, which kernel 1 (``kernels/csrc/spmv_pull.cu``) walks.  The cell
packing, its window width ``cw`` and its layouts are not carried over:
they serve the TPU's lack of a gather (ROADMAP.md, "Not carried over").
``cw`` is accepted and ignored.  The value of a block is f32, as the cell
format's is, and ``values=`` overrides A's values as in the JAX package
(1.0 for a structural BFS).

The loops are ``dist_ops``'s: the same exchange and the same exit read.
The ``_overlap`` functions take the diagonal / off-diagonal split
(``shard_cell_spmv_split``): each step starts the gather of the frontier
or vector, runs kernel 1 on the diagonal block (this rank's own vector)
on the current stream while it is in flight, waits, then runs kernel 1 on
the off-diagonal block over the gathered vector.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import op as OP
from ..containers import CsrMatrix
from .comm import all_gather
from .dist_matrix import ShardedCsr, shard_csr_by_rows, shard_csr_split_diag
from .dist_ops import bfs_loop, min_plus, overlapped, pagerank_loop, spmv, spmv_structural, sssp_loop
from .mesh import Mesh

__all__ = [
    "ShardedCellSpmv",
    "shard_cell_spmv",
    "shard_cell_spmv_split",
    "dist_pagerank_pallas",
    "dist_bfs_pallas",
    "dist_sssp_pallas",
    "dist_pagerank_pallas_overlap",
    "dist_bfs_pallas_overlap",
    "dist_sssp_pallas_overlap",
]


@dataclass(frozen=True)
class ShardedCellSpmv:
    """One rank's row block for kernel 1: ``block`` holds ``mloc`` local rows
    and ``n_frame`` columns (``n_shards * mloc``, the gathered frame; or
    ``mloc`` for a diagonal block), f32 values, every stored entry of A's
    rows kept.  It is ``dist_matrix``'s block; kernel 1 builds its pull plan
    once, at the first launch on the card (``kernels.spmv.pull_plan``)."""

    m: int  # global rows
    n: int  # global columns
    mloc: int
    n_shards: int
    rank: int
    block: CsrMatrix
    cw: int | None = None  # the TPU cell format's window width: accepted, unused

    @property
    def n_frame(self) -> int:
        return self.block.shape[1]


def _f32(A: CsrMatrix, values) -> CsrMatrix:
    """A with f32 values and fill 0 on its device; ``values`` broadcast over
    the stored entries when given."""
    if values is None:
        vals = A.values.to(torch.float32)
    else:
        vals = torch.from_numpy(np.broadcast_to(values, (int(A.nnz),)).astype(np.float32)).to(A.values.device)
    return replace(A, values=vals, fill=torch.zeros((), dtype=torch.float32, device=A.values.device))


def _cells(A: CsrMatrix, sharded, n_frame: int | None, cw):
    """The ``ShardedCellSpmv`` of one ``ShardedCsr`` (or of each in a list)."""
    def cell(sh: ShardedCsr):
        return ShardedCellSpmv(A.shape[0], A.shape[1], sh.mloc, sh.n_shards, sh.rank, sh.local_block(n_frame), cw)

    return [cell(sh) for sh in sharded] if isinstance(sharded, list) else cell(sharded)


def shard_cell_spmv(A: CsrMatrix, n_shards: int, mesh: Mesh | None = None, cw: int | None = 16384,
                    axis: str = "d", values=None):
    """Block-row partition of A for kernel 1 (``shard_csr_by_rows``): this
    rank's ``ShardedCellSpmv`` (or, with no mesh, every rank's).  ``values``
    overrides A's values (e.g. 1.0 for a structural BFS); ``cw`` is the TPU
    format's and unused."""
    return _cells(A, shard_csr_by_rows(_f32(A, values), n_shards, mesh), None, cw)


def shard_cell_spmv_split(A: CsrMatrix, n_shards: int, mesh: Mesh | None = None, cw: int | None = 16384,
                          axis: str = "d", values=None):
    """The diagonal / off-diagonal split for the ``_overlap`` loops
    (``shard_csr_split_diag``): per rank, the DIAGONAL block (columns in the
    rank's own row range, rebased to local ids, frame ``mloc``) and the
    OFF-DIAGONAL block (the other columns, global, over the gathered
    frame); duplicate stored entries fold as that partitioner folds them
    (the last kept).  Returns ``(diag, off)``."""
    diag, off = shard_csr_split_diag(_f32(A, values), n_shards, mesh)
    mloc = (A.shape[0] + n_shards - 1) // n_shards
    return _cells(A, diag, mloc, cw), _cells(A, off, None, cw)


def _default_cap(frontier_cap, mloc) -> tuple:
    """The JAX ``_pallas`` loops' one tier: None = mloc/16 (at least 32), 0 = dense."""
    cap = max(mloc // 16, 32) if frontier_cap is None else int(frontier_cap)
    return (cap,) if cap > 0 else ()


def dist_pagerank_pallas(mesh: Mesh, sc: ShardedCellSpmv, alpha, eps, axis="d"):
    """This rank's rows of PageRank, kernel 1 on the rank's block each step."""
    return pagerank_loop(mesh, sc.m, sc.mloc, alpha, eps,
                         lambda p: spmv(sc.block, all_gather(mesh, p), OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0))


def dist_bfs_pallas(mesh: Mesh, sc: ShardedCellSpmv, source, axis="d", frontier_cap: int | None = None):
    """This rank's BFS depths, kernel 1's structural variant on the rank's
    block each level; the frontier goes by the capped index gather (None:
    mloc/16, 0: always dense)."""
    v, _ = bfs_loop(mesh, sc.mloc, int(source), _default_cap(frontier_cap, sc.mloc),
                    lambda front, wait, row_sel: spmv_structural(sc.block, wait(), row_sel), sc.m + 1)
    return v


def dist_sssp_pallas(mesh: Mesh, sc: ShardedCellSpmv, source, axis="d", frontier_cap: int | None = None):
    """This rank's SSSP distances, kernel 1's (PLUS, MIN) on the rank's block
    each round; the changed entries go by the capped (index, value) gather
    (None: mloc/16, 0: dense)."""
    v, _ = sssp_loop(mesh, sc.mloc, int(source), _default_cap(frontier_cap, sc.mloc),
                     lambda v, changed, wait: min_plus(sc.block, *wait()), 0, 4 * sc.m + 1)
    return v


def dist_pagerank_pallas_overlap(mesh: Mesh, diag: ShardedCellSpmv, off: ShardedCellSpmv, alpha, eps,
                                 axis="d"):
    """PageRank with each step's gather overlapped by kernel 1 on the diagonal
    block (build the pair with ``shard_cell_spmv_split``)."""
    def product(p):
        local, remote = overlapped(mesh, p, lambda x: spmv(diag.block, x, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0),
                                   lambda x: spmv(off.block, x, OP.MULT_FLOAT, OP.PLUS_FLOAT, 0.0))
        return local + remote

    return pagerank_loop(mesh, diag.m, diag.mloc, alpha, eps, product)


def dist_bfs_pallas_overlap(mesh: Mesh, diag: ShardedCellSpmv, off: ShardedCellSpmv, source, axis="d",
                            frontier_cap: int | None = None):
    """BFS with the diagonal block's traversal overlapping the frontier exchange."""
    def level(front, wait, row_sel):
        local = spmv_structural(diag.block, front, row_sel)
        return local | spmv_structural(off.block, wait(), row_sel)

    v, _ = bfs_loop(mesh, diag.mloc, int(source), _default_cap(frontier_cap, diag.mloc), level, diag.m + 1)
    return v


def dist_sssp_pallas_overlap(mesh: Mesh, diag: ShardedCellSpmv, off: ShardedCellSpmv, source, axis="d",
                             frontier_cap: int | None = None):
    """SSSP with the diagonal block's relaxation overlapping the exchange of
    the changed entries."""
    def relax(v, changed, wait):
        local = min_plus(diag.block, v, changed)
        return torch.minimum(local, min_plus(off.block, *wait()))

    v, _ = sssp_loop(mesh, diag.mloc, int(source), _default_cap(frontier_cap, diag.mloc), relax, 0,
                     4 * diag.m + 1)
    return v
