"""Runtime element types (BOOL / INT / UINT / FLOAT) mapped to torch dtypes.

Counterpart of ``spla_tpu/types.py``.  Each ``Type`` also carries the
built-in operators registered for it (``INT.PLUS``, ``FLOAT.MIN``, ...),
installed by :mod:`spla_tpu_torch.op` at import time.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Type", "BOOL", "INT", "UINT", "FLOAT", "TYPES", "type_from_dtype"]


class Type:
    """A runtime element type: ``name``, one-letter ``code``, the torch
    ``dtype`` and the numpy ``np_dtype`` used by the host builders."""

    __slots__ = ("name", "code", "dtype", "np_dtype", "_ops")

    def __init__(self, name: str, code: str, dtype: torch.dtype, np_dtype):
        self.name = name
        self.code = code
        self.dtype = dtype
        self.np_dtype = np.dtype(np_dtype)
        self._ops = {}

    def _attach_op(self, attr: str, op) -> None:
        self._ops[attr] = op

    def __getattr__(self, attr):
        try:
            return self._ops[attr]
        except KeyError:
            raise AttributeError(f"type {self.name} has no op or attribute {attr!r}") from None

    def __repr__(self) -> str:
        return f"<spla_tpu_torch.Type {self.name}>"

    def __eq__(self, other):
        return isinstance(other, Type) and other.name == self.name

    def __hash__(self):
        return hash((Type, self.name))

    # pyspla's helper surface (python/pyspla/type.py:170-204)
    def get_code(self) -> str:
        """The one-letter code ('B' / 'I' / 'U' / 'F')."""
        return self.code

    def cast_value(self, value):
        """A ctypes, numpy or Python value as the Python value of this type."""
        raw = getattr(value, "value", value)  # unwrap ctypes
        out = self.np_dtype.type(raw).item()
        return bool(out) if self.np_dtype == np.bool_ else out

    def format_value(self, value, width: int = 2, precision: int = 2) -> str:
        """A value as text: floats in ``width.precision``, bools as t / f."""
        if self.np_dtype == np.bool_ or isinstance(value, bool):
            return f"{'t' if value else 'f':>{width}}"
        if self.is_float():
            return f"{value:>{width}.{precision}}"
        return f"{value:>{width}}"

    def is_float(self) -> bool:
        return self.dtype.is_floating_point

    def is_integral(self) -> bool:
        return not self.dtype.is_floating_point


BOOL = Type("BOOL", "B", torch.bool, np.bool_)
INT = Type("INT", "I", torch.int32, np.int32)
UINT = Type("UINT", "U", torch.uint32, np.uint32)
FLOAT = Type("FLOAT", "F", torch.float32, np.float32)

TYPES = (BOOL, INT, UINT, FLOAT)

_BY_TORCH = {t.dtype: t for t in TYPES}
_BY_NUMPY = {t.np_dtype: t for t in TYPES}


def type_from_dtype(dtype) -> Type:
    """Map a torch or numpy dtype to its Type."""
    if isinstance(dtype, torch.dtype):
        table, key = _BY_TORCH, dtype
    else:
        table, key = _BY_NUMPY, np.dtype(dtype)
    try:
        return table[key]
    except KeyError:
        raise TypeError(f"unsupported element dtype {dtype!r}") from None
