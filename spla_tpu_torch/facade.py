"""pyspla-compatible object API: Matrix, Vector, Scalar, Array, MemView
(counterpart of ``spla_tpu/facade.py``).

The reference Python package's surface (``python/pyspla/matrix.py``,
``vector.py``, ``scalar.py``, ``array.py``): eager execution, the same
method names and signatures (mxm, mxmT, kron, kronpow, mxv, vxm, eadd,
emult, reduce*, transpose, extract*, assign, map, ...), the from_lists /
rand / dense / diag constructors and the pretty-printers.

Each Vector and Matrix keeps

* a host staging buffer (numpy COO triplets) that ``set`` / ``build``
  write to, the analog of the reference's CpuLil/CpuDok write formats
  (``src/core/tmatrix.hpp:160-173``), and
* a device snapshot (a DenseVec, or a CsrMatrix and the CSR of its
  transpose for the push ops), built at the first op after a change.

An op's result is adopted as a device snapshot; the host staging is
read back only when the host needs it (``read``, ``set``, ...).  All
compute goes to the op layer (``spla_tpu_torch.ops``), so covered
semirings on CUDA tensors launch its kernels: ``Vector.vxm`` and
``Matrix.mxv`` kernel 1, ``Matrix.mxm`` kernel 9, ``Matrix.mxmT``
kernel 5.

**The device.** ``Vector`` and ``Matrix`` and their class constructors
take a keyword-only ``device=``.  With none, the object lives on
``get_library().default_device()``: the CPU when
``set_force_no_acceleration(True)`` is set, else the accelerator, which
raises without a card.  Nothing picks the CPU on its own.  An op's result
lives on its operands' device; operands on different devices raise.

Three faults of the ``spla_tpu`` facade are not copied: the top-level
``Scalar`` is this module's, ``Scalar`` and ``MemView`` take ``label=``,
and ``MemView.buffer`` is a ``ctypes.c_void_p``.
"""

from __future__ import annotations

import ctypes
import enum
import functools

import numpy as np
import torch

from . import formats as F
from . import op as OP
from . import ops as X
from .containers import CsrMatrix, DenseVec
from .library import get_library
from .profiling import profiler
from .types import FLOAT, INT, UINT, Type

__all__ = ["Matrix", "Vector", "Scalar", "Array", "MemView", "Object",
           "FormatMatrix", "FormatVector"]


class Object:
    """Base class of the user-facing objects (reference
    ``python/pyspla/object.py:34-76``).  The reference carries a native
    handle and a debug label; here tensors own the device memory, so only
    the label is kept and ``hnd`` is always None."""

    label = None

    @property
    def hnd(self):
        return None


class FormatMatrix(enum.Enum):
    """Reference matrix storage formats (``python/pyspla/bridge.py:101-124``);
    accepted by ``Matrix.set_format`` as hints, which change nothing."""

    CPU_LIL = 0
    CPU_DOK = 1
    CPU_COO = 2
    CPU_CSR = 3
    CPU_CSC = 4
    ACC_COO = 5
    ACC_CSR = 6
    ACC_CSC = 7
    COUNT = 8


class FormatVector(enum.Enum):
    """Reference vector storage formats (``python/pyspla/bridge.py:129-146``);
    hints, as :class:`FormatMatrix`."""

    CPU_DOK = 0
    CPU_DENSE = 1
    CPU_COO = 2
    ACC_DENSE = 3
    ACC_COO = 4
    COUNT = 5


def _op_or_default(op, default):
    return default if op is None else op


def _zero(dtype):
    return np.zeros((), dtype)[()]


def _host(t: torch.Tensor) -> np.ndarray:
    """numpy copy of a tensor on any device: the facade's one way to read
    the device."""
    return t.detach().cpu().numpy()


def _resolve(device) -> torch.device:
    return get_library().default_device() if device is None else torch.device(device)


def _same_device(*objs) -> torch.device:
    """The one device of the facade objects given (None entries skipped);
    raises when they live on different devices."""
    devices = {o.device for o in objs if o is not None}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devices))}")
    return devices.pop()


def _host_fold(op):
    """``op`` as the host builders' duplicate fold, which combines numpy
    scalars: a torch op runs on 0-d tensors."""
    if op is None:
        return None
    return lambda a, b: op.fn(torch.as_tensor(a), torch.as_tensor(b)).numpy()[()]


def _identity(a):
    return a


class Scalar(Object):
    """Typed scalar (reference ``python/pyspla/scalar.py``), held on the host.

    Takes both argument orders: ``Scalar(INT, 0)`` (the pyspla README's)
    and ``Scalar(0, INT)``."""

    def __init__(self, value=None, dtype: Type = INT, label=None):
        if isinstance(value, Type):  # pyspla order: Scalar(dtype, value)
            value, dtype = (dtype if not isinstance(dtype, Type) else None), value
        self._dtype = dtype
        self._value = dtype.np_dtype.type(0 if value is None else value)
        self.label = label

    @classmethod
    def make(cls, dtype: Type = INT, value=None):
        return cls(value, dtype)

    @classmethod
    def from_value(cls, value):
        """A scalar of the Python value's type (reference ``scalar.py:142-166``)."""
        if isinstance(value, bool):
            return cls(int(value), INT)
        if isinstance(value, float):
            return cls(value, FLOAT)
        if isinstance(value, int):
            return cls(value, INT)
        raise TypeError(f"cannot infer a type for {type(value).__name__}")

    @property
    def n_vals(self):
        """Number of stored values: always 1 (reference ``scalar.py:128``)."""
        return 1

    @classmethod
    def make_int(cls, value=0):
        return cls(value, INT)

    @classmethod
    def make_uint(cls, value=0):
        return cls(value, UINT)

    @classmethod
    def make_float(cls, value=0.0):
        return cls(value, FLOAT)

    @property
    def dtype(self):
        return self._dtype

    @property
    def shape(self):
        return ()

    def set(self, value):
        self._value = self._dtype.np_dtype.type(value)

    def get(self):
        return self._value.item()

    def as_int(self):
        return int(self._value)

    def as_uint(self):
        return int(self._value)

    def as_float(self):
        return float(self._value)

    def as_bool(self):
        return bool(self._value)

    def __int__(self):
        return int(self._value)

    def __float__(self):
        return float(self._value)

    def __bool__(self):
        return bool(self._value)

    def __eq__(self, other):
        return self.get() == (other.get() if isinstance(other, Scalar) else other)

    def __add__(self, other):
        return Scalar(self.get() + _sval(other), self._dtype)

    def __sub__(self, other):
        return Scalar(self.get() - _sval(other), self._dtype)

    def __mul__(self, other):
        return Scalar(self.get() * _sval(other), self._dtype)

    def __truediv__(self, other):
        return Scalar(self.get() / _sval(other), self._dtype)

    def __repr__(self):
        return f"{self.get()}"

    __str__ = __repr__


def _sval(x):
    return x.get() if isinstance(x, Scalar) else x


class MemView(Object):
    """Non-owning view of host memory for the bulk build and read
    (reference ``include/spla/memview.hpp:48-64``); the device copy is made
    when a snapshot is built."""

    def __init__(self, array, label=None):
        self._np = np.asarray(array)
        self.label = label

    @staticmethod
    def make(array) -> "MemView":
        return MemView(array)

    @property
    def size(self) -> int:
        return int(self._np.nbytes)

    def read(self, offset=0, size=None):
        flat = self._np.reshape(-1).view(np.uint8)
        end = len(flat) if size is None else offset + size
        return flat[offset:end]

    def write(self, offset, data):
        if not self._np.flags.c_contiguous:
            # reshape(-1) of a non-contiguous array copies, so the write would
            # land in the copy, not the caller's array
            raise ValueError("MemView.write requires a C-contiguous array (use np.ascontiguousarray)")
        flat = self._np.reshape(-1).view(np.uint8)
        data = np.frombuffer(bytes(data), np.uint8)
        flat[offset: offset + data.size] = data

    @property
    def buffer(self) -> ctypes.c_void_p:
        """Pointer to the viewed host memory, as the reference's
        ``python/pyspla/memview.py:90`` returns it."""
        return ctypes.c_void_p(self._np.ctypes.data)

    @property
    def is_mutable(self) -> bool:
        """True when the viewed buffer can be written through this view
        (reference ``python/pyspla/memview.py:109``)."""
        return bool(self._np.flags.writeable)

    def to_numpy(self):
        return self._np

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self._np, dtype=dtype)


class Array(Object):
    """Dense typed 1-D host array for construction and inspection
    (reference ``python/pyspla/array.py``)."""

    def __init__(self, dtype: Type = INT, label=None):
        self._dtype = dtype
        self._data = np.zeros(0, dtype.np_dtype)
        self.label = label

    @classmethod
    def from_list(cls, values, dtype: Type = INT):
        a = cls(dtype)
        a._data = np.asarray(values, dtype.np_dtype)
        return a

    @classmethod
    def rand(cls, dtype: Type = INT, n=1, seed=None, dist=(0, 1)):
        rng = np.random.default_rng(seed)
        a = cls(dtype)
        if dtype.is_float():
            a._data = rng.uniform(dist[0], dist[1], n).astype(dtype.np_dtype)
        else:
            a._data = rng.integers(dist[0], dist[1] + 1, n).astype(dtype.np_dtype)
        return a

    @property
    def dtype(self):
        return self._dtype

    @property
    def n_values(self):
        return int(self._data.size)

    n_vals = n_values  # reference property name (``array.py:105``)

    @property
    def empty(self):
        return self._data.size == 0

    @property
    def shape(self):
        return (self.n_values, 1)

    def set(self, index, value):
        self._data[index] = value

    def get(self, index):
        return self._data[index].item()

    def resize(self, n):
        old = self._data
        self._data = np.zeros(n, self._dtype.np_dtype)
        self._data[: min(n, old.size)] = old[: min(n, old.size)]

    def clear(self):
        self._data = np.zeros(0, self._dtype.np_dtype)

    def to_list(self):
        return self._data.tolist()

    def to_numpy(self):
        return self._data.copy()

    def build(self, view: "MemView"):
        """The content from a raw memory view (reference ``array.py:157-165``)."""
        self._data = np.frombuffer(view.to_numpy().tobytes(), dtype=self._dtype.np_dtype).copy()

    def read(self) -> "MemView":
        """The content as a view, no copy (reference ``array.py:167-176``)."""
        return MemView(self._data)

    def __iter__(self):
        return iter(self.to_list())

    def __repr__(self):
        return "[" + ", ".join(str(v) for v in self.to_list()) + "]"

    __str__ = __repr__


def _n_of(shape) -> int:
    return int(shape[0] if isinstance(shape, (tuple, list)) else shape)


class Vector(Object):
    """Generalized n-vector (reference ``python/pyspla/vector.py``) on
    ``device`` (see the module's docstring)."""

    def __init__(self, shape, dtype: Type = INT, label=None, *, device=None):
        self._n = _n_of(shape)
        self._dtype = dtype
        self.device = _resolve(device)
        self._fill_np = _zero(dtype.np_dtype)
        self._idx = np.zeros(0, np.int64)
        self._val = np.zeros(0, dtype.np_dtype)
        self._reduce_fn = None
        self._dense_cache = None
        self._host_stale = False  # True: the device snapshot is canonical
        self.label = label

    # -- properties ------------------------------------------------------
    @property
    def dtype(self):
        return self._dtype

    @property
    def n_rows(self):
        return self._n

    @property
    def shape(self):
        return (self._n, 1)

    @property
    def _fill(self):
        # after an op result is adopted only the device snapshot is live;
        # read its fill alone, not the whole vector
        if self._fill_np is None:
            self._fill_np = _host(self._dense_cache.fill)[()].astype(self._dtype.np_dtype)
        return self._fill_np

    @_fill.setter
    def _fill(self, value):
        self._fill_np = value

    @property
    def fill_value(self):
        return Scalar(self._fill, self._dtype)

    def set_fill_value(self, value):
        self._sync_host()
        self._fill_np = self._dtype.np_dtype.type(_sval(value))
        self._dense_cache = None

    def set_format(self, fmt):  # a storage hint: formats are implicit here
        pass

    def set_reduce(self, op):
        self._reduce_fn = op

    # -- mutation (host staging) ------------------------------------------
    def set(self, i, v):
        self._sync_host()  # appends need the current contents
        self._idx = np.append(self._idx, i)
        self._val = np.append(self._val, self._dtype.np_dtype.type(v))
        self._dense_cache = None

    def get(self, i):
        # one element read from the device, not the whole vector
        return _host(self._device().values[i])[()].item()

    def build(self, view_I, view_V):
        self._fill  # read the fill from the device snapshot before dropping it
        self._idx = np.asarray(view_I, np.int64).copy()
        self._val = np.asarray(view_V, self._dtype.np_dtype).copy()
        self._dense_cache = None
        self._host_stale = False

    def read(self):
        if self._host_stale:
            self._sync_host()  # the full read is the lazy sync too
            return self._idx.copy(), self._val.copy()
        d = _host(self._device().values)
        idx = np.nonzero(d != self._fill)[0]
        return idx, d[idx]

    def clear(self):
        self._fill  # read the fill from the device snapshot before dropping it
        self._idx = np.zeros(0, np.int64)
        self._val = np.zeros(0, self._dtype.np_dtype)
        self._dense_cache = None
        self._host_stale = False

    def fill_with(self, value):
        self.clear()
        self._fill_np = self._dtype.np_dtype.type(_sval(value))

    def fill_noize(self, seed=None):
        self._fill  # read the fill from the device snapshot before dropping it
        rng = np.random.default_rng(seed)
        self._idx = np.arange(self._n)
        self._val = (
            rng.uniform(0, 1, self._n).astype(self._dtype.np_dtype)
            if self._dtype.is_float()
            # the full non-negative range: examples/pi.py hashes these as seeds
            else rng.integers(0, 2**31 - 1, self._n).astype(self._dtype.np_dtype)
        )
        self._dense_cache = None
        self._host_stale = False

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_lists(cls, I, V, shape, dtype: Type = INT, fill_value=0, *, device=None):
        v = cls(shape, dtype, device=device)
        v._fill = dtype.np_dtype.type(fill_value)
        v._idx = np.asarray(I, np.int64)
        v._val = np.asarray(V, dtype.np_dtype)
        return v

    @classmethod
    def rand(cls, shape, dtype: Type = INT, density=0.1, seed=None, dist=(0, 1), *, device=None):
        n = _n_of(shape)
        rng = np.random.default_rng(seed)
        k = max(int(n * density), 0)
        idx = np.unique(rng.integers(0, n, k)) if k else np.zeros(0, np.int64)
        if dtype.is_float():
            vals = rng.uniform(dist[0], dist[1], idx.size)
        else:
            vals = rng.integers(dist[0], dist[1] + 1, idx.size)
        return cls.from_lists(idx, vals.astype(dtype.np_dtype), n, dtype, device=device)

    @classmethod
    def dense(cls, shape, dtype: Type = INT, fill_value=0, *, device=None):
        n = _n_of(shape)
        v = cls(n, dtype, device=device)
        v._idx = np.arange(n)
        v._val = np.full(n, fill_value, dtype.np_dtype)
        return v

    # -- device snapshot ----------------------------------------------------
    def _device(self) -> DenseVec:
        if self._dense_cache is None:
            self._dense_cache = F.dense_vec_from_entries(
                self._n, self._idx, self._val, fill=self._fill, dtype=self._dtype.np_dtype,
                reduce_fn=_host_fold(self._reduce_fn), device=self.device)
        return self._dense_cache

    def _adopt(self, dv: DenseVec):
        """Take a device vector as the contents.  The device snapshot stays
        canonical; the host staging syncs at the next read() or set(), as
        the reference keeps device decorations between ops
        (``storage_manager_matrix.hpp:138-142``)."""
        self._dense_cache = dv
        self._host_stale = True
        self._fill_np = None
        return self

    def _sync_host(self):
        """The host staging from the device snapshot (the lazy read-back)."""
        if not self._host_stale:
            return
        dv = self._dense_cache
        d = _host(dv.values)
        self._fill_np = _host(dv.fill)[()].astype(self._dtype.np_dtype)
        stored = np.nonzero(d != self._fill_np)[0]
        self._idx = stored
        self._val = d[stored].astype(self._dtype.np_dtype)
        self._host_stale = False

    def to_numpy(self):
        return _host(self._device().values)

    def to_lists(self):
        i, v = self.read()
        return i.tolist(), v.tolist()

    def to_list(self):
        i, v = self.read()
        return list(zip(i.tolist(), v.tolist()))

    def to_string(self, format_string="{:>%s}", width=2, precision=2, skip_value=0):
        fmt = format_string % max(width, 1)
        return "".join(fmt.format(_fmt_val(x, precision)) for x in self.to_numpy())

    # -- compute ops ----------------------------------------------------------
    def vxm(self, mask, M: "Matrix", op_mult, op_add, op_select, out=None, init=None, desc=None):
        device = _same_device(self, mask, M, out)
        init_v = _sval(init) if init is not None else _zero(self._dtype.np_dtype)
        # the dense-result variant: the Vector is dense, so vxm_masked's
        # compaction would be undone at once
        r = X.vxm_masked_dense(mask._device(), self._device(), M._device_t(),
                               op_mult, op_add, op_select, init_v, desc)
        res = out if out is not None else Vector(M.n_cols, self._dtype, device=device)
        return res._adopt(r)

    def eadd(self, op_add, v: "Vector", out=None, desc=None):
        device = _same_device(self, v, out)
        r = X.v_eadd(self._device(), v._device(), op_add)
        res = out if out is not None else Vector(self._n, self._dtype, device=device)
        return res._adopt(r)

    def emult(self, op_mult, v: "Vector", out=None, desc=None):
        device = _same_device(self, v, out)
        r = X.v_emult(self._device(), v._device(), op_mult)
        res = out if out is not None else Vector(self._n, self._dtype, device=device)
        return res._adopt(r)

    def assign(self, mask, value, op_assign, op_select, desc=None):
        _same_device(self, mask)
        r = X.v_assign_masked(self._device(), mask._device(), _sval(value), op_assign, op_select)
        return self._adopt(r)

    def map(self, op_map, out=None, desc=None):
        device = _same_device(self, out)
        r = X.v_map(self._device(), op_map)
        res = out if out is not None else Vector(self._n, self._dtype, device=device)
        return res._adopt(r)

    def reduce(self, op_reduce, out=None, init=None, desc=None):
        init_v = _sval(init) if init is not None else _zero(self._dtype.np_dtype)
        # the reference's sparse reduce folds the stored entries only
        r = X.v_reduce(init_v, self._device(), op_reduce, stored_only=True)
        res = out if out is not None else Scalar(dtype=self._dtype)
        res.set(_host(r.value)[()])
        return res

    def count_mf(self):
        return int(_host(X.v_count_mf(self._device()).value))

    def __str__(self):
        return self.to_string()

    def __iter__(self):
        return iter(self.to_list())


def _fmt_val(x, precision):
    if isinstance(x, (np.floating, float)):
        return f"{x:.{precision}f}"
    return str(x)


class Matrix(Object):
    """Generalized M x N matrix (reference ``python/pyspla/matrix.py``) on
    ``device`` (see the module's docstring)."""

    def __init__(self, shape, dtype: Type = INT, label=None, *, device=None):
        self._shape = (int(shape[0]), int(shape[1]))
        self._dtype = dtype
        self.device = _resolve(device)
        self._fill_np = _zero(dtype.np_dtype)
        self._rows = np.zeros(0, np.int64)
        self._cols = np.zeros(0, np.int64)
        self._vals = np.zeros(0, dtype.np_dtype)
        self._reduce_fn = None
        self._csr_cache = None
        self._csr_t_cache = None
        self._host_stale = False  # True: the device snapshot is canonical
        self.label = label

    # -- properties -------------------------------------------------------
    @property
    def dtype(self):
        return self._dtype

    @property
    def n_rows(self):
        return self._shape[0]

    @property
    def n_cols(self):
        return self._shape[1]

    @property
    def shape(self):
        return self._shape

    @property
    def _fill(self):
        if self._fill_np is None:
            self._fill_np = _host(self._csr_cache.fill)[()].astype(self._dtype.np_dtype)
        return self._fill_np

    @_fill.setter
    def _fill(self, value):
        self._fill_np = value

    @property
    def fill_value(self):
        return Scalar(self._fill, self._dtype)

    def set_fill_value(self, value):
        self._sync_host()
        self._fill_np = self._dtype.np_dtype.type(_sval(value))
        self._invalidate()

    def set_format(self, fmt):
        pass

    def set_reduce(self, op):
        self._reduce_fn = op

    def _invalidate(self):
        if self._csr_cache is not None:
            self._fill  # read the fill value before the snapshot is dropped
        self._csr_cache = None
        self._csr_t_cache = None

    # -- mutation -----------------------------------------------------------
    def set(self, i, j, v):
        self._sync_host()  # appends need the current contents
        self._rows = np.append(self._rows, i)
        self._cols = np.append(self._cols, j)
        self._vals = np.append(self._vals, self._dtype.np_dtype.type(v))
        self._invalidate()

    set_int = set
    set_uint = set
    set_float = set

    def get(self, i, j):
        """One element, read by a search of row i's window: the row's
        entries cross to the host, never the whole matrix (the reference
        reads a DOK hash, ``src/core/tmatrix.hpp:179-210``)."""
        A = self._device()
        s, e = (int(x) for x in _host(A.indptr[i: i + 2]))
        if e > s:
            hit = np.nonzero(_host(A.cols[s:e]) == j)[0]
            if hit.size:
                return _host(A.values[s + int(hit[0])])[()].item()
        return self._fill.item()

    def build(self, view_I, view_J, view_V):
        self._rows = np.asarray(view_I, np.int64).copy()
        self._cols = np.asarray(view_J, np.int64).copy()
        self._vals = np.asarray(view_V, self._dtype.np_dtype).copy()
        self._invalidate()
        self._host_stale = False

    def read(self):
        if self._host_stale:
            self._sync_host()  # the full read is the lazy sync too
            return self._rows.astype(np.int64), self._cols.astype(np.int64), self._vals.copy()
        A = self._device()
        nnz = int(A.nnz)
        return _host(A.row_ids[:nnz]), _host(A.cols[:nnz]), _host(A.values[:nnz])

    def clear(self):
        self._rows = np.zeros(0, np.int64)
        self._cols = np.zeros(0, np.int64)
        self._vals = np.zeros(0, self._dtype.np_dtype)
        self._invalidate()
        self._host_stale = False

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_lists(cls, I, J, V, shape, dtype: Type = INT, *, device=None):
        m = cls(shape, dtype, device=device)
        m._rows = np.asarray(I, np.int64)
        m._cols = np.asarray(J, np.int64)
        m._vals = np.asarray(V, dtype.np_dtype)
        return m

    @classmethod
    def rand(cls, shape, dtype: Type = INT, density=0.1, seed=None, dist=(0, 1), *, device=None):
        rng = np.random.default_rng(seed)
        mr, nc = shape
        k = int(mr * nc * density)
        rows = rng.integers(0, mr, k)
        cols = rng.integers(0, nc, k)
        keys = np.unique(rows * nc + cols)
        rows, cols = keys // nc, keys % nc
        if dtype.is_float():
            vals = rng.uniform(dist[0], dist[1], rows.size)
        else:
            vals = rng.integers(dist[0], dist[1] + 1, rows.size)
        return cls.from_lists(rows, cols, vals.astype(dtype.np_dtype), shape, dtype, device=device)

    @classmethod
    def dense(cls, shape, dtype: Type = INT, fill_value=0, *, device=None):
        mr, nc = shape
        rows, cols = np.divmod(np.arange(mr * nc), nc)
        vals = np.full(mr * nc, fill_value, dtype.np_dtype)
        return cls.from_lists(rows, cols, vals, shape, dtype, device=device)

    @classmethod
    def diag(cls, shape, dtype: Type = INT, diag_value=1, *, device=None):
        idx = np.arange(min(shape))
        return cls.from_lists(idx, idx, np.full(idx.size, diag_value, dtype.np_dtype), shape, dtype,
                              device=device)

    # -- device snapshots -------------------------------------------------------
    def _device(self) -> CsrMatrix:
        if self._csr_cache is None:
            self._csr_cache = F.csr_from_entries(
                self._shape, self._rows, self._cols, self._vals, fill=self._fill,
                dtype=self._dtype.np_dtype, reduce_fn=_host_fold(self._reduce_fn), device=self.device)
        return self._csr_cache

    def _device_t(self) -> CsrMatrix:
        """CSR of the transpose, made on the device by ``ops.m_transpose``
        (the JAX facade's ``csr_transpose_host`` would read an adopted
        result back to the host); its stored entries equal the host
        transpose's."""
        if self._csr_t_cache is None:
            self._csr_t_cache = X.m_transpose(self._device(), _identity)
        return self._csr_t_cache

    def _adopt(self, A: CsrMatrix):
        """Take a device result as the contents; the host staging syncs at
        the next read (as the reference keeps device decorations between
        ops, ``storage_manager_matrix.hpp:138-142``)."""
        self._csr_cache = A
        self._csr_t_cache = None
        self._host_stale = True
        self._fill_np = None
        self._shape = A.shape
        return self

    def _sync_host(self):
        """The host staging from the device snapshot (the lazy read-back)."""
        if not self._host_stale:
            return
        A = self._csr_cache
        nnz = int(A.nnz)
        self._rows = _host(A.row_ids[:nnz]).astype(np.int64)
        self._cols = _host(A.cols[:nnz]).astype(np.int64)
        self._vals = _host(A.values[:nnz]).astype(self._dtype.np_dtype)
        self._fill_np = _host(A.fill)[()].astype(self._dtype.np_dtype)
        self._host_stale = False

    def to_numpy(self):
        return _host(F.csr_to_dense(self._device()))

    def to_lists(self):
        r, c, v = self.read()
        return r.tolist(), c.tolist(), v.tolist()

    def to_list(self):
        r, c, v = self.read()
        return list(zip(r.tolist(), c.tolist(), v.tolist()))

    def to_string(self, format_string="{:>%s}", width=2, precision=2, skip_value=0, cell_sep=""):
        fmt = format_string % max(width, 1)
        return "\n".join(cell_sep.join(fmt.format(_fmt_val(x, precision)) for x in row)
                         for row in self.to_numpy()) + "\n"

    # -- compute ops --------------------------------------------------------
    def mxm(self, M: "Matrix", op_mult, op_add, out=None, init=None, desc=None):
        device = _same_device(self, M, out)
        init_v = _sval(init) if init is not None else _zero(self._dtype.np_dtype)
        r = X.mxm(self._device(), M._device(), op_mult, op_add, init_v)
        res = out if out is not None else Matrix((self.n_rows, M.n_cols), self._dtype, device=device)
        return res._adopt(r)

    def mxmT(self, mask: "Matrix", M: "Matrix", op_mult, op_add, op_select, out=None, init=None,
             desc=None):
        device = _same_device(self, mask, M, out)
        init_v = _sval(init) if init is not None else _zero(self._dtype.np_dtype)
        r = X.mxmT_masked(mask._device(), self._device(), M._device(), op_mult, op_add, op_select, init_v)
        res = out if out is not None else Matrix((self.n_rows, M.n_rows), self._dtype, device=device)
        return res._adopt(r)

    def kron(self, M: "Matrix", op_mult, out=None, desc=None):
        device = _same_device(self, M, out)
        r = X.kron(self._device(), M._device(), op_mult)
        res = out if out is not None else Matrix(
            (self.n_rows * M.n_rows, self.n_cols * M.n_cols), self._dtype, device=device)
        return res._adopt(r)

    def kronpow(self, exponent, op_mult=None):
        op_mult = _op_or_default(op_mult, OP.lookup("MULT", self._dtype))
        if exponent == 0:
            return Matrix.diag((1, 1), self._dtype, 1, device=self.device)
        if exponent == 1:
            # a new object: returning self would alias its mutations
            i, j, v = self.to_lists()
            return Matrix.from_lists(i, j, v, self.shape, self._dtype, device=self.device)
        r = self
        for _ in range(exponent - 1):
            r = r.kron(self, op_mult)
        return r

    def mxv(self, mask: Vector, v: Vector, op_mult, op_add, op_select, out=None, init=None, desc=None):
        device = _same_device(self, mask, v, out)
        init_v = _sval(init) if init is not None else _zero(self._dtype.np_dtype)
        r = X.mxv_masked(mask._device(), self._device(), v._device(), op_mult, op_add, op_select, init_v,
                         desc)
        res = out if out is not None else Vector(self.n_rows, self._dtype, device=device)
        return res._adopt(r)

    def eadd(self, op_add, M: "Matrix", out=None, desc=None):
        device = _same_device(self, M, out)
        r = X.m_eadd(self._device(), M._device(), op_add)
        res = out if out is not None else Matrix(self._shape, self._dtype, device=device)
        return res._adopt(r)

    def emult(self, op_mult, M: "Matrix", out=None, desc=None):
        device = _same_device(self, M, out)
        r = X.m_emult(self._device(), M._device(), op_mult)
        res = out if out is not None else Matrix(self._shape, self._dtype, device=device)
        return res._adopt(r)

    def reduce_by_row(self, op_reduce, out=None, init=None, desc=None):
        device = _same_device(self, out)
        init_v = _sval(init) if init is not None else _zero(self._dtype.np_dtype)
        r = X.m_reduce_by_row(self._device(), op_reduce, init_v)
        res = out if out is not None else Vector(self.n_rows, self._dtype, device=device)
        return res._adopt(r)

    def reduce_by_column(self, op_reduce, out=None, init=None, desc=None):
        device = _same_device(self, out)
        init_v = _sval(init) if init is not None else _zero(self._dtype.np_dtype)
        r = X.m_reduce_by_column(self._device(), op_reduce, init_v)
        res = out if out is not None else Vector(self.n_cols, self._dtype, device=device)
        return res._adopt(r)

    def reduce(self, op_reduce, out=None, init=None, desc=None):
        init_v = _sval(init) if init is not None else _zero(self._dtype.np_dtype)
        r = X.m_reduce(init_v, self._device(), op_reduce)
        res = out if out is not None else Scalar(dtype=self._dtype)
        res.set(_host(r.value)[()])
        return res

    def transpose(self, out=None, op_apply=None, desc=None):
        device = _same_device(self, out)
        op_apply = _op_or_default(op_apply, OP.lookup("IDENTITY", self._dtype))
        r = X.m_transpose(self._device(), op_apply)
        res = out if out is not None else Matrix((self.n_cols, self.n_rows), self._dtype, device=device)
        return res._adopt(r)

    def extract_row(self, index, out=None, op_apply=None, desc=None):
        device = _same_device(self, out)
        op_apply = _op_or_default(op_apply, OP.lookup("IDENTITY", self._dtype))
        r = X.m_extract_row(self._device(), index, op_apply)
        res = out if out is not None else Vector(self.n_cols, self._dtype, device=device)
        return res._adopt(F.sparse_to_dense_vec(r))

    def extract_column(self, index, out=None, op_apply=None, desc=None):
        device = _same_device(self, out)
        op_apply = _op_or_default(op_apply, OP.lookup("IDENTITY", self._dtype))
        r = X.m_extract_column(self._device(), index, op_apply)
        res = out if out is not None else Vector(self.n_rows, self._dtype, device=device)
        return res._adopt(F.sparse_to_dense_vec(r))

    def __str__(self):
        return self.to_string()

    def __iter__(self):
        return iter(self.to_list())


# ---------------------------------------------------------------------------
# Profiling: with profiling on, every op opens a profiler scope named
# <class>_<method> (the reference opens one in each backend algorithm, e.g.
# ``cl_vxm.hpp:74``) and waits for its result's device, so a scope's time is
# the device's (the reference's profiled dispatch, ``cl_debug.hpp:36-103``).
# ---------------------------------------------------------------------------


def _instrument(cls, names):
    for name in names:
        def make(fn, label):
            @functools.wraps(fn)
            def wrapped(self, *args, **kwargs):
                if not profiler.enabled:
                    return fn(self, *args, **kwargs)
                with profiler.scope(label, self.device):
                    out = fn(self, *args, **kwargs)
                    if isinstance(out, (Vector, Matrix)) and out.device.type == "cuda":
                        torch.cuda.synchronize(out.device)
                    return out

            return wrapped

        setattr(cls, name, make(getattr(cls, name), f"{cls.__name__.lower()}_{name}"))


_instrument(Matrix, ["mxm", "mxmT", "kron", "kronpow", "mxv", "eadd", "emult", "reduce_by_row",
                     "reduce_by_column", "reduce", "transpose", "extract_row", "extract_column"])
_instrument(Vector, ["vxm", "eadd", "emult", "assign", "map", "reduce", "count_mf"])
