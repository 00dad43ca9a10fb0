"""Frozen containers of tensors: Scalar, DenseVec, SparseVec, CooMatrix, CsrMatrix, BsrMatrix.

Counterpart of ``spla_tpu/containers.py``, with the same fields and the
same conventions:

* every sparse container has a static capacity (array length) and a 0-d
  ``nnz`` tensor;
* index arrays at positions ``>= nnz`` are padding: row and vector indices
  there equal the dimension (a dump slot one past the end); padding
  columns lie in ``[0, n]``;
* ``fill`` is an explicit 0-d tensor and is not always 0 (SSSP uses +inf).

A container lives on the device of its tensors; ops run there.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .types import Type, type_from_dtype
from .utils.bits import bits

__all__ = ["Scalar", "DenseVec", "SparseVec", "CooMatrix", "CsrMatrix", "BsrMatrix"]

# with no dtype given, a value takes the 32-bit type that jnp.asarray gives it
_CANONICAL = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32,
              np.dtype(np.float64): np.float32}


def _value_on(v, dtype, device) -> torch.Tensor:
    """``v`` as a 0-d tensor of the numpy ``dtype`` (or ``v``'s own, cut to
    32 bits) on ``device``."""
    a = np.asarray(v, dtype=dtype)
    if dtype is None:
        a = a.astype(_CANONICAL.get(a.dtype, a.dtype))
    return torch.from_numpy(a).to(device)


@dataclass(frozen=True)
class Scalar:
    """Typed 0-d value."""

    value: torch.Tensor

    @staticmethod
    def of(v, dtype=None, *, device) -> "Scalar":
        return Scalar(_value_on(v, dtype, device))

    @property
    def dtype(self) -> torch.dtype:
        return self.value.dtype

    @property
    def type(self) -> Type:
        return type_from_dtype(self.dtype)

    def item(self):
        """The value as a numpy scalar (a host read)."""
        return self.value.cpu().numpy()[()]


@dataclass(frozen=True)
class DenseVec:
    """Dense n-vector with an explicit fill; its stored entries are those != fill."""

    values: torch.Tensor  # [n]
    fill: torch.Tensor  # 0-d

    @property
    def n(self) -> int:
        return self.values.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @staticmethod
    def full(n: int, fill, dtype=None, *, device) -> "DenseVec":
        """n slots of ``fill`` (a numpy ``dtype``, as the builders take) on ``device``."""
        fill_t = _value_on(fill, dtype, device)
        return DenseVec(fill_t.expand(n).clone(), fill_t)

    def stored_mask(self) -> torch.Tensor:
        return bits(self.values) != bits(self.fill)


@dataclass(frozen=True)
class SparseVec:
    """Sorted-COO sparse n-vector; padding positions hold index ``n``."""

    n: int
    indices: torch.Tensor  # [cap] int32
    values: torch.Tensor  # [cap]
    nnz: torch.Tensor  # 0-d int32
    fill: torch.Tensor  # 0-d

    @property
    def capacity(self) -> int:
        return self.indices.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.indices.device) < self.nnz

    @staticmethod
    def empty(n: int, capacity: int, fill, dtype=None, *, device) -> "SparseVec":
        """No stored entries: ``capacity`` padding slots (index ``n``, value ``fill``)."""
        fill_t = _value_on(fill, dtype, device)
        return SparseVec(n=n, indices=torch.full((capacity,), n, dtype=torch.int32, device=device),
                         values=fill_t.expand(capacity).clone(),
                         nnz=torch.zeros((), dtype=torch.int32, device=device), fill=fill_t)


@dataclass(frozen=True)
class CooMatrix:
    """COO matrix sorted row-major; padding rows = m."""

    shape: tuple
    rows: torch.Tensor  # [cap] int32
    cols: torch.Tensor  # [cap] int32
    values: torch.Tensor  # [cap]
    nnz: torch.Tensor  # 0-d int32
    fill: torch.Tensor  # 0-d

    @property
    def capacity(self) -> int:
        return self.rows.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.rows.device) < self.nnz


@dataclass(frozen=True)
class CsrMatrix:
    """CSR matrix plus the per-entry row ids (padding = m).

    ``indptr[m]`` equals ``nnz``, so the kernels, which walk ``indptr``,
    never read padding; the plain torch path uses ``row_ids`` and the
    validity mask instead."""

    shape: tuple
    indptr: torch.Tensor  # [m+1] int32
    cols: torch.Tensor  # [cap] int32
    values: torch.Tensor  # [cap]
    row_ids: torch.Tensor  # [cap] int32
    nnz: torch.Tensor  # 0-d int32
    fill: torch.Tensor  # 0-d

    @property
    def capacity(self) -> int:
        return self.cols.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.cols.device) < self.nnz


@dataclass(frozen=True)
class BsrMatrix:
    """Block-sparse rows of dense ``block x block`` tiles; padding block rows
    = ``mb``.  A stored block's unstored elements hold the fill."""

    shape: tuple  # (m, n) in elements
    block: int
    indptr: torch.Tensor  # [mb+1] int32 block-row pointers
    cols: torch.Tensor  # [bcap] int32 block columns
    blocks: torch.Tensor  # [bcap, block, block]
    row_ids: torch.Tensor  # [bcap] int32 block rows
    nnzb: torch.Tensor  # 0-d int32
    fill: torch.Tensor  # 0-d

    @property
    def block_shape(self) -> tuple:
        bs = self.block
        return ((self.shape[0] + bs - 1) // bs, (self.shape[1] + bs - 1) // bs)

    @property
    def capacity(self) -> int:
        return self.cols.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.dtype

    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.cols.device) < self.nnzb
