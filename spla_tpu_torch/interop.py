"""Carry container and facade state between the JAX package and this one,
through numpy.

``from_spla_tpu`` reads the fields of a ``spla_tpu`` container with
``np.asarray``, so this package never imports jax; ``to_numpy`` is the
way back.  ``matrix_from_numpy`` and ``vector_from_numpy`` make facade
objects from what a ``spla_tpu.facade`` Matrix or Vector's ``read()`` and
``fill_value`` give.  ``sharded_csr_from_numpy`` makes one rank's shard of
``parallel`` from a ``spla_tpu.parallel`` shard's arrays.  The tests use
these to give both packages the same inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import containers as C
from .types import Type, type_from_dtype

__all__ = [
    "csr_from_numpy",
    "dense_from_numpy",
    "sparse_vec_from_numpy",
    "from_spla_tpu",
    "to_numpy",
    "matrix_from_numpy",
    "vector_from_numpy",
    "sharded_csr_from_numpy",
]

# fields that are static Python values, not arrays
_STATIC = {"shape", "n", "block"}


def _tensor(a, device) -> torch.Tensor:
    # np.array copies: numpy views of JAX arrays are read-only
    return torch.from_numpy(np.array(a)).to(device)


def csr_from_numpy(shape, indptr, cols, values, row_ids, nnz, fill, device) -> C.CsrMatrix:
    return C.CsrMatrix(
        shape=tuple(int(s) for s in shape),
        indptr=_tensor(np.asarray(indptr, np.int32), device),
        cols=_tensor(np.asarray(cols, np.int32), device),
        values=_tensor(values, device),
        row_ids=_tensor(np.asarray(row_ids, np.int32), device),
        nnz=_tensor(np.asarray(nnz, np.int32), device),
        fill=_tensor(np.asarray(fill, np.asarray(values).dtype), device),
    )


def dense_from_numpy(values, fill, device) -> C.DenseVec:
    values = np.asarray(values)
    return C.DenseVec(_tensor(values, device), _tensor(np.asarray(fill, values.dtype), device))


def sparse_vec_from_numpy(n, indices, values, nnz, fill, device) -> C.SparseVec:
    values = np.asarray(values)
    return C.SparseVec(
        n=int(n),
        indices=_tensor(np.asarray(indices, np.int32), device),
        values=_tensor(values, device),
        nnz=_tensor(np.asarray(nnz, np.int32), device),
        fill=_tensor(np.asarray(fill, values.dtype), device),
    )


def from_spla_tpu(obj, device):
    """The port's container of the same class name and fields as ``obj``
    (a ``spla_tpu`` Scalar, DenseVec, SparseVec, CooMatrix, CsrMatrix or
    BsrMatrix)."""
    cls = getattr(C, type(obj).__name__, None)
    if cls is None or not dataclasses.is_dataclass(cls):
        raise TypeError(f"no port container for {type(obj).__name__}")
    kw = {}
    for f in dataclasses.fields(cls):
        val = getattr(obj, f.name)
        if f.name in _STATIC:
            kw[f.name] = tuple(int(s) for s in val) if f.name == "shape" else int(val)
        else:
            kw[f.name] = _tensor(np.asarray(val), device)
    return cls(**kw)


def to_numpy(obj):
    """numpy array of a tensor; dict of numpy fields of a container."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj):
        return {f.name: to_numpy(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    return obj


def _type(dtype) -> Type:
    return dtype if isinstance(dtype, Type) else type_from_dtype(dtype)


def matrix_from_numpy(shape, dtype, rows, cols, vals, fill, device):
    """A facade Matrix of ``shape`` and element type ``dtype`` (a Type or a
    dtype) holding the entries ``(rows, cols, vals)``, whose unstored
    slots read ``fill``, on ``device``."""
    from .facade import Matrix

    t = _type(dtype)
    m = Matrix.from_lists(np.asarray(rows), np.asarray(cols), np.asarray(vals), shape, t, device=device)
    m.set_fill_value(t.np_dtype.type(fill))
    return m


def vector_from_numpy(n, dtype, idx, vals, fill, device):
    """A facade Vector of ``n`` slots holding the entries ``(idx, vals)``,
    whose unstored slots read ``fill``, on ``device``."""
    from .facade import Vector

    t = _type(dtype)
    return Vector.from_lists(np.asarray(idx), np.asarray(vals), n, t, fill_value=fill, device=device)


def sharded_csr_from_numpy(fields: dict, rank: int, device):
    """Rank ``rank``'s shard of the port's ``parallel`` layer from a
    ``spla_tpu.parallel`` source, as numpy: the fields of a ``ShardedCsr``
    (``shape``, ``n_shards``, the stacked ``indptr``, ``cols``, ``values``,
    ``row_ids``, ``nnz`` and ``fill``; ``np.asarray`` of each) give a
    ``ShardedCsr``.  The TPU cell format of a ``ShardedCellSpmv`` has no
    counterpart, so it comes as the host COO of the matrix it was packed
    from (``shape``, ``n_shards``, ``rows``, ``cols``, ``values``, and
    ``split`` True for the diagonal / off-diagonal pair) and gives the
    port's ``ShardedCellSpmv`` (or its ``(diag, off)`` pair)."""
    from .parallel import dist_cell, dist_matrix

    shape, n_shards = tuple(int(s) for s in fields["shape"]), int(fields["n_shards"])
    if "indptr" in fields:
        return dist_matrix.shard_of(shape, n_shards, fields, fields["fill"], rank, device)
    values = np.asarray(fields["values"], np.float32)
    rows = np.asarray(fields["rows"], np.int32)
    indptr = np.zeros(shape[0] + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=shape[0]), out=indptr[1:])
    a = csr_from_numpy(shape, indptr, fields["cols"], values, rows, values.size, 0.0, device)
    if fields.get("split"):
        diag, off = dist_cell.shard_cell_spmv_split(a, n_shards)
        return diag[rank], off[rank]
    return dist_cell.shard_cell_spmv(a, n_shards)[rank]
