"""Block-row sharded CSR (counterpart of ``spla_tpu/parallel/dist_matrix.py``).

The partition: contiguous row blocks of ``mloc = ceil(m / S)`` rows, block
s on rank s.  Rows are local to the block (padding row id ``mloc``) and
columns stay global, so the padded global index of vertex i is i itself:
the tiled all-gather of the ranks' ``[mloc]`` vectors (``S * mloc`` slots)
is indexed by the columns directly.  Every block is padded to the largest
block's stored count, as the JAX package pads its stacked shards: the
ring of ``dist_spgemm`` receives blocks of one size.

The partitioners run on the host and give the JAX package's partition.
With a ``mesh`` they return this rank's block on ``mesh.device``; with
none, the list of every rank's block on the input's device, which is how
the tests hold them against the JAX package's stacked arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..containers import CsrMatrix
from ..formats import csr_from_entries, host_coo
from ..reorder import relabel_degree_sorted
from .mesh import Mesh

__all__ = [
    "ShardedCsr",
    "shard_csr_by_rows",
    "shard_csr_by_rows_balanced",
    "shard_csr_split_diag",
    "shard_vector_by_rows",
]


@dataclass(frozen=True)
class ShardedCsr:
    """One rank's row block of a block-row sharded CSR matrix of global
    ``shape``: local rows (padding ``mloc``), global columns, ``capacity``
    equal on every rank."""

    shape: tuple  # global (m, n)
    n_shards: int
    mloc: int
    rank: int
    indptr: torch.Tensor  # [mloc + 1] int32
    cols: torch.Tensor  # [cap] int32
    values: torch.Tensor  # [cap]
    row_ids: torch.Tensor  # [cap] int32, padding mloc
    nnz: torch.Tensor  # 0-d int32
    fill: torch.Tensor  # 0-d

    @property
    def capacity(self) -> int:
        return self.cols.shape[0]

    @property
    def device(self) -> torch.device:
        return self.values.device

    def local_block(self, n_cols: int | None = None) -> CsrMatrix:
        """The block as a CsrMatrix of ``mloc`` rows and ``n_cols`` columns
        (default the gathered frame, ``n_shards * mloc``)."""
        n_cols = self.n_shards * self.mloc if n_cols is None else n_cols
        return CsrMatrix(shape=(self.mloc, n_cols), indptr=self.indptr, cols=self.cols,
                         values=self.values, row_ids=self.row_ids, nnz=self.nnz, fill=self.fill)


def _host(a: CsrMatrix):
    """A's ``(indptr, cols, values)`` on the host, indptr as int64."""
    return a.indptr.cpu().numpy().astype(np.int64), a.cols.cpu().numpy(), a.values.cpu().numpy()


def shard_arrays(m: int, n_shards: int, indptr, cols, vals, fill) -> dict:
    """The JAX package's stacked shard arrays (``[S, mloc + 1]`` indptr,
    ``[S, cap]`` cols / values / row_ids, ``[S]`` nnz) of the CSR matrix
    ``(indptr, cols, vals)`` with ``m`` rows, cut in ``n_shards`` uniform
    contiguous row blocks and padded to the largest block's stored count."""
    mloc = (m + n_shards - 1) // n_shards
    starts = [min(s * mloc, m) for s in range(n_shards + 1)]
    shard_nnz = [int(indptr[starts[s + 1]] - indptr[starts[s]]) for s in range(n_shards)]
    cap = max(max(shard_nnz), 1)
    out = {"indptr": np.zeros((n_shards, mloc + 1), np.int32),
           "cols": np.zeros((n_shards, cap), np.int32),
           "values": np.full((n_shards, cap), fill, vals.dtype),
           "row_ids": np.full((n_shards, cap), mloc, np.int32),
           "nnz": np.asarray(shard_nnz, np.int32)}
    for s in range(n_shards):
        r0, r1 = starts[s], starts[s + 1]
        e0, e1 = int(indptr[r0]), int(indptr[r1])
        local_ptr = (indptr[r0:r1 + 1] - e0).astype(np.int32)
        out["indptr"][s, :r1 - r0 + 1] = local_ptr
        out["indptr"][s, r1 - r0 + 1:] = local_ptr[-1]  # padded empty rows
        out["cols"][s, :e1 - e0] = cols[e0:e1]
        out["values"][s, :e1 - e0] = vals[e0:e1]
        out["row_ids"][s, :e1 - e0] = np.repeat(np.arange(r1 - r0, dtype=np.int32), np.diff(local_ptr))
    return out


def shard_of(shape, n_shards: int, arrays: dict, fill, rank: int, device) -> ShardedCsr:
    """Rank ``rank``'s ``ShardedCsr`` from stacked shard arrays, on ``device``."""
    def on(a):
        return torch.from_numpy(np.array(a)).to(device)

    return ShardedCsr(shape=tuple(int(s) for s in shape), n_shards=n_shards,
                      mloc=int(arrays["indptr"].shape[1]) - 1, rank=rank,
                      indptr=on(arrays["indptr"][rank]), cols=on(arrays["cols"][rank]),
                      values=on(arrays["values"][rank]), row_ids=on(arrays["row_ids"][rank]),
                      nnz=on(np.asarray(arrays["nnz"][rank], np.int32)),
                      fill=on(np.asarray(fill, np.asarray(arrays["values"]).dtype)))


def _place(shape, n_shards, arrays, fill, mesh: Mesh | None, device):
    if mesh is None:
        return [shard_of(shape, n_shards, arrays, fill, s, device) for s in range(n_shards)]
    if mesh.size != n_shards:
        raise ValueError(f"{n_shards} shards on a mesh of {mesh.size} ranks")
    return shard_of(shape, n_shards, arrays, fill, mesh.rank, mesh.device)


def shard_csr_by_rows(a: CsrMatrix, n_shards: int, mesh: Mesh | None = None, axis: str = "d"):
    """Uniform contiguous row blocks, padded to the largest block's stored
    count: this rank's ``ShardedCsr`` (or, with no mesh, every rank's)."""
    fill = a.fill.cpu().numpy()
    arrays = shard_arrays(a.shape[0], n_shards, *_host(a), fill)
    return _place(a.shape, n_shards, arrays, fill, mesh, a.values.device)


def shard_csr_by_rows_balanced(a: CsrMatrix, n_shards: int, mesh: Mesh | None = None, axis: str = "d"):
    """Degree-balanced sharding of a square graph: the vertices are
    relabelled by the heavy-first shard deal (``reorder.relabel_degree_sorted``),
    the same permutation on rows and columns, then block-row sharded.
    Returns ``(sharded, old_of_new, new_of_old)``; translate a source with
    ``new_of_old[src]`` and read a result back with
    ``v_old[i] = v_new_flat[new_of_old[i]]``."""
    m, n = a.shape
    if m != n:
        raise ValueError("balanced sharding relabels vertices: square graphs only")
    rows, cols, vals = host_coo(a)
    mloc = (m + n_shards - 1) // n_shards
    old_of_new, new_of_old = relabel_degree_sorted(rows, cols, m, n_shards, mloc)
    fill = a.fill.cpu().numpy()
    ap = csr_from_entries((m, n), new_of_old[rows], new_of_old[cols], vals, fill=fill, dtype=vals.dtype,
                          device="cpu")
    arrays = shard_arrays(m, n_shards, *_host(ap), fill)
    return _place(a.shape, n_shards, arrays, fill, mesh, a.values.device), old_of_new, new_of_old


def shard_csr_split_diag(a: CsrMatrix, n_shards: int, mesh: Mesh | None = None, axis: str = "d"):
    """The diagonal / off-diagonal split for overlapping the exchange with
    compute.  Block s's DIAGONAL part holds its entries whose columns lie
    in ``[s * mloc, (s + 1) * mloc)``, rebased to local ids (shape
    ``(m, mloc)``): its SpMV needs only the rank's own vector.  The
    OFF-DIAGONAL part keeps global columns and takes the gathered vector.
    Returns ``(diag, off)``."""
    m, n = a.shape
    mloc = (m + n_shards - 1) // n_shards
    rows, cols, vals = host_coo(a)
    shard_of_row = np.minimum(rows // mloc, n_shards - 1)
    is_diag = (cols // mloc) == shard_of_row
    fill = a.fill.cpu().numpy()

    def build(sel, local_cols):
        r, c, v = rows[sel], cols[sel], vals[sel]
        if local_cols:
            c = c - np.minimum(r // mloc, n_shards - 1) * mloc
        shape = (m, mloc if local_cols else n)
        part = csr_from_entries(shape, r, c, v, fill=fill, dtype=vals.dtype, device="cpu")
        arrays = shard_arrays(m, n_shards, *_host(part), fill)
        return _place(shape, n_shards, arrays, fill, mesh, a.values.device)

    return build(is_diag, True), build(~is_diag, False)


def shard_vector_by_rows(x, n_shards: int, mloc: int, mesh: Mesh | None = None, axis: str = "d"):
    """The global dense vector ``x`` padded to ``n_shards * mloc`` slots:
    this rank's ``[mloc]`` block on ``mesh.device``, or with no mesh the
    ``[n_shards, mloc]`` tensor of every block."""
    x = np.asarray(x)
    padded = np.zeros((n_shards * mloc,), x.dtype)
    padded[:x.shape[0]] = x
    blocks = torch.from_numpy(padded.reshape(n_shards, mloc))
    if mesh is None:
        return blocks
    return blocks[mesh.rank].clone().to(mesh.device)
