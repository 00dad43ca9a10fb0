"""Semiring building blocks: unary / binary / select operators as torch callables.

Counterpart of ``spla_tpu/op.py``.  Binary ops carry, as fields, what the
kernels and the segment folds need to know about them:

* ``identity`` — the monoid identity, where one exists;
* ``scatter`` — the ``Tensor.scatter_reduce`` kind ("add" / "mul" /
  "min" / "max") when the op coincides with one;
* ``associative`` / ``commutative``;
* ``kernel_code`` — the :class:`KernelCode` the CUDA kernels switch on
  (every built-in binary op has one); ``None`` for user ops.  Which
  (mul, add, dtype) a kernel takes is each kernel's gate, in its wrapper.

torch has few CPU kernels for ``uint32`` tensors, so UINT ops compute in
int64 and wrap the result back to 32 bits.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from .types import FLOAT, INT, UINT, Type

__all__ = [
    "KernelCode",
    "Op",
    "OpUnary",
    "OpBinary",
    "OpSelect",
    "BUILTIN_OPS",
    "lookup",
]


class KernelCode(enum.IntEnum):
    """Operator codes of the CUDA kernels; kept equal to ``enum KernelCode``
    in ``kernels/csrc/semiring.cuh``."""

    PLUS = 0
    MULT = 1
    FIRST = 2
    SECOND = 3
    MIN = 4
    MAX = 5
    MINUS = 6
    DIV = 7
    MINUS_POW2 = 8
    BONE = 9
    LOR = 10
    LAND = 11
    BOR = 12
    BAND = 13
    BXOR = 14


@dataclass(frozen=True)
class Op:
    """Base operator: a named, typed torch callable."""

    name: str
    type: Type
    fn: Callable = field(repr=False)

    @property
    def key(self) -> str:
        return f"{self.name}_{self.type.name}"

    # the reference accessors (python/pyspla/op.py:79-192): ops are T -> T
    # or (T, T) -> T here, as every reference built-in is
    @property
    def dtype_res(self) -> Type:
        return self.type

    @property
    def dtype_arg0(self) -> Type:
        return self.type

    def __call__(self, *args):
        return self.fn(*args)

    def __hash__(self):
        return hash((self.__class__.__name__, self.name, self.type))

    def __eq__(self, other):
        return (
            isinstance(other, Op)
            and self.__class__ is other.__class__
            and self.name == other.name
            and self.type == other.type
        )


@dataclass(frozen=True, eq=False)
class OpUnary(Op):
    """T -> T elementwise operator."""

    @staticmethod
    def make(name: str, type: Type, fn: Callable) -> "OpUnary":
        """A user op (reference ``OpUnary::make_*``): ``fn`` maps a tensor of
        ``type`` to one of the same shape and type."""
        return OpUnary(name=name, type=type, fn=fn)


@dataclass(frozen=True, eq=False)
class OpBinary(Op):
    """(T, T) -> T operator with its monoid and kernel metadata.  A user op
    (:meth:`make`) keeps ``kernel_code=None``: it never reaches the kernels."""

    identity: Optional[object] = None
    scatter: Optional[str] = None
    associative: bool = False
    commutative: bool = False
    kernel_code: Optional[KernelCode] = None

    @property
    def dtype_arg1(self) -> Type:
        return self.type

    @staticmethod
    def make(name: str, type: Type, fn: Callable, identity=None, scatter=None,
             associative=False, commutative=False) -> "OpBinary":
        """A user op (reference ``OpBinary::make_*``): ``fn`` combines two
        tensors of ``type``.  Its ``kernel_code`` is None, so the static
        semiring gate (``ops/spmv.py`` ``_kernel_covers``, and kernel 9's
        and kernels 4 and 5's codes) sends every op that uses it down the
        plain PyTorch path, on CUDA tensors too: no kernel is tried first."""
        return OpBinary(name=name, type=type, fn=fn, identity=identity, scatter=scatter,
                        associative=associative, commutative=commutative)

    def identity_array(self, *, device) -> torch.Tensor:
        """The identity as a 0-d tensor of the op's dtype on ``device``."""
        if self.identity is None:
            raise ValueError(f"op {self.key} has no identity")
        return torch.from_numpy(np.asarray(self.identity, dtype=self.type.np_dtype)).to(device)


@dataclass(frozen=True, eq=False)
class OpSelect(Op):
    """T -> bool predicate."""

    @staticmethod
    def make(name: str, type: Type, fn: Callable) -> "OpSelect":
        """A user predicate (reference ``OpSelect::make_*``): ``fn`` maps a
        tensor of ``type`` to a bool tensor of the same shape."""
        return OpSelect(name=name, type=type, fn=fn)


BUILTIN_OPS: dict[str, Op] = {}


def _register(op: Op) -> Op:
    BUILTIN_OPS[op.key] = op
    op.type._attach_op(op.name, op)
    return op


def _via_int64(fn):
    """Run ``fn`` on uint32 tensors widened to int64; wrap the result to 32 bits."""

    def widened(*args):
        out = fn(*(a.to(torch.int64) if isinstance(a, torch.Tensor) and a.dtype == torch.uint32
                   else a for a in args))
        if isinstance(out, torch.Tensor) and out.dtype == torch.int64:
            return (out & 0xFFFFFFFF).to(torch.uint32)
        return out

    return widened


def _limits(t: Type):
    if t.is_float():
        return np.float32(-np.inf), np.float32(np.inf)
    info = np.iinfo(t.np_dtype)
    return t.np_dtype.type(info.min), t.np_dtype.type(info.max)


def _full_ones(a, b, dtype):
    shape = torch.broadcast_shapes(torch.as_tensor(a).shape, torch.as_tensor(b).shape)
    device = a.device if isinstance(a, torch.Tensor) else None
    return torch.ones(shape, dtype=dtype, device=device)


def _int_div(a, b):
    """Integer division as XLA's ``lax.div`` gives it: toward zero, ``x / 0``
    all ones (-1; 0xFFFFFFFF once a UINT result wraps) and ``INT_MIN / -1``
    INT_MIN, by a ``where`` on a safe divisor (no branch on values, no host
    read)."""
    a, b = (x if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=y.dtype, device=y.device)
            for x, y in ((a, b), (b, a)))
    zero = b == 0
    overflow = (a == torch.iinfo(a.dtype).min) & (b == -1)
    return torch.where(zero, -1, torch.div(a, torch.where(zero | overflow, 1, b), rounding_mode="trunc"))


def _float_min(a, b):
    """torch.minimum with -0.0 below +0.0 in either order, as XLA's min has
    it (torch.minimum gives ``b`` when ``a == b``, so MIN(0.0, -0.0) would
    be 0.0 and MIN(-0.0, 0.0) -0.0)."""
    return torch.where(a == b, torch.where(torch.signbit(a), a, b), torch.minimum(a, b))


def _float_max(a, b):
    """torch.maximum with +0.0 above -0.0 in either order, as XLA's max has it."""
    return torch.where(a == b, torch.where(torch.signbit(a), b, a), torch.maximum(a, b))


def _int_minv(a, hi):
    """Integer 1 / a as ``spla_tpu``'s saturating float-to-int cast gives it:
    0 -> ``hi`` (INT_MAX, or UINT_MAX), +-1 -> itself, every other value 0;
    in integer arithmetic, so no device's cast of inf enters."""
    return torch.where(a == 0, hi, torch.where((a == 1) | (a == -1), a, 0))


def register_builtins() -> None:
    for t in (INT, UINT, FLOAT):
        # compute dtype: UINT works in int64 (see _via_int64)
        d = torch.int64 if t is UINT else t.dtype
        wrap = _via_int64 if t is UINT else (lambda f: f)
        lo, hi = _limits(t)

        def unary(name, f):
            _register(OpUnary(name, t, wrap(f)))

        def binary(name, f, **kw):
            _register(OpBinary(name, t, wrap(f), kernel_code=KernelCode[name], **kw))

        def select(name, f):
            _register(OpSelect(name, t, wrap(f)))

        unary("IDENTITY", lambda a: a)
        unary("AINV", lambda a: -a)
        unary("MINV", (lambda a: 1 / a) if t is FLOAT else (lambda a, hi=int(hi): _int_minv(a, hi)))
        unary("LNOT", lambda a, d=d: (a == 0).to(d))
        unary("UONE", lambda a: torch.ones_like(a))
        unary("ABS", (lambda a: a) if t is UINT else torch.abs)
        if t is not FLOAT:
            unary("BNOT", lambda a: ~a)

        binary("PLUS", lambda a, b: a + b, identity=t.np_dtype.type(0), scatter="add",
               associative=True, commutative=True)
        binary("MINUS", lambda a, b: a - b)
        binary("MULT", lambda a, b: a * b, identity=t.np_dtype.type(1), scatter="mul",
               associative=True, commutative=True)
        # integer DIV gives lax.div's answers (spla_tpu.op), x / 0 and INT_MIN / -1 included
        binary("DIV", (lambda a, b: a / b) if t is FLOAT else _int_div)
        binary("MINUS_POW2", lambda a, b: (a - b) * (a - b))
        binary("FIRST", lambda a, b: a)
        binary("SECOND", lambda a, b: b, associative=True)
        binary("BONE", lambda a, b, d=d: _full_ones(a, b, d))
        binary("MIN", _float_min if t is FLOAT else torch.minimum, identity=hi, scatter="min",
               associative=True, commutative=True)
        binary("MAX", _float_max if t is FLOAT else torch.maximum, identity=lo, scatter="max",
               associative=True, commutative=True)
        binary("LOR", lambda a, b, d=d: ((a != 0) | (b != 0)).to(d),
               identity=t.np_dtype.type(0), associative=True, commutative=True)
        binary("LAND", lambda a, b, d=d: ((a != 0) & (b != 0)).to(d),
               associative=True, commutative=True)
        if t is not FLOAT:
            binary("BOR", lambda a, b: a | b, identity=t.np_dtype.type(0),
                   associative=True, commutative=True)
            binary("BAND", lambda a, b: a & b, identity=t.np_dtype.type(~t.np_dtype.type(0)),
                   associative=True, commutative=True)
            binary("BXOR", lambda a, b: a ^ b, identity=t.np_dtype.type(0),
                   associative=True, commutative=True)

        select("EQZERO", lambda a: a == 0)
        select("NQZERO", lambda a: a != 0)
        select("GTZERO", lambda a: a > 0)
        select("GEZERO", lambda a: a >= 0)
        select("LTZERO", lambda a: a < 0)
        select("LEZERO", lambda a: a <= 0)
        select("ALWAYS", lambda a: torch.ones(a.shape, dtype=torch.bool, device=a.device))
        select("NEVER", lambda a: torch.zeros(a.shape, dtype=torch.bool, device=a.device))

    for fname, f in (
        ("SQRT", torch.sqrt),
        ("LOG", torch.log),
        ("EXP", torch.exp),
        ("SIN", torch.sin),
        ("COS", torch.cos),
        ("TAN", torch.tan),
        ("ASIN", torch.asin),
        ("ACOS", torch.acos),
        ("ATAN", torch.atan),
        ("CEIL", torch.ceil),
        ("FLOOR", torch.floor),
        ("ROUND", torch.round),
        ("TRUNC", torch.trunc),
    ):
        _register(OpUnary(fname, FLOAT, f))


def lookup(name: str, type: Type) -> Op:
    """Find a built-in op by GraphBLAS name + element type."""
    return BUILTIN_OPS[f"{name}_{type.name}"]


register_builtins()

# module-level op constants: PLUS_INT, MIN_FLOAT, EQZERO_INT, ...
for _key, _op in list(BUILTIN_OPS.items()):
    globals()[_key] = _op
    __all__.append(_key)
