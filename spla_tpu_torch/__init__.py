"""spla_tpu_torch — spla_tpu's op layer, traversals and SpGEMM on PyTorch and CUDA.

A port of ``spla_tpu`` (JAX/XLA/Pallas, kept beside it as the reference)
to PyTorch, with hand-written Hopper kernels for each slice's hot path:

* the masked semiring SpMV (``ops.mxv_masked``, ``ops.vxm_masked``,
  ``ops.vxm_masked_dense``) and the BFS / SSSP / PageRank loops over it
  (``algorithms.bfs``, ``sssp``, ``pr``); BFS and SSSP on graphs whose CSR
  and state fit the L2 run whole in one persistent kernel instead;
* the masked SpGEMM-T (``ops.mxmT_masked``), with ``ops.m_reduce``, and
  triangle counting over it (``algorithms.tc``); the SpGEMM ``ops.mxm``;
* the rest of the op layer, in plain PyTorch: the vector ops
  (``ops.v_eadd``, ``v_emult``, ``v_map``, ``v_reduce``, ``v_count_mf``,
  ``v_assign_masked``, ``v_eadd_fdb``), the matrix ops (``ops.m_eadd``,
  ``m_emult``, ``m_reduce_by_row``/``_by_column``, ``m_transpose``,
  ``m_extract_row``/``_column``, ``kron``), the BSR products
  (``ops.bsr_spmv``, ``bsr_spmm``) and the reference's ``exec_*`` names;
* the pyspla-style facade (``Matrix``, ``Vector``, ``Scalar``, ``Array``,
  ``MemView``; module ``facade``), a schedule of tasks (``Schedule``),
  time profiling (``profiling``), MatrixMarket IO (``io``), a timer
  (``timer``), the library settings (``library``) and the example CLIs
  ``bfs``, ``sssp``, ``pr``, ``tc``, ``pi`` and ``convert``
  (``python -m spla_tpu_torch.examples.bfs ...``).

The device is explicit: containers are built with ``device=`` and ops run
where their tensors live.  A facade object made with no ``device=`` lives
on the accelerator (``cuda``, or an error without one) unless
``get_library().set_force_no_acceleration(True)`` asks for the CPU;
nothing picks a device on its own.  CPU tensors
take each kernel's plain PyTorch version; CUDA tensors launch the kernel
or raise.  This package imports neither jax nor spla_tpu.
"""

from . import algorithms, formats, interop, kernels, op, ops
from .algorithms import tc
from .containers import BsrMatrix, CooMatrix, CsrMatrix, DenseVec, SparseVec
from .descriptor import Descriptor
from .library import Library, get_library
from .ops import count_mxm_products, count_mxmT_products, m_reduce, mxmT_masked
from .schedule import Schedule, ScheduleTask, make_schedule
from .types import BOOL, FLOAT, INT, UINT, Type, type_from_dtype

# the facade is imported at first use, as spla_tpu's is; its Scalar is the
# top-level one (containers.Scalar stays spla_tpu_torch.containers.Scalar)
_LAZY_FACADE = ("Matrix", "Vector", "Scalar", "Array", "MemView", "Object",
                "FormatMatrix", "FormatVector")
_LAZY_OP = ("Op", "OpUnary", "OpBinary", "OpSelect")


def __getattr__(name):
    import importlib

    if name in _LAZY_FACADE:
        return getattr(importlib.import_module(".facade", __name__), name)
    if name in _LAZY_OP:
        return getattr(op, name)
    if name == "MtxLoader":
        return importlib.import_module(".io", __name__).MtxLoader
    if name == "Timer":
        return importlib.import_module(".timer", __name__).Timer
    if name in ("io", "profiling", "timer", "facade", "schedule", "library"):
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module 'spla_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))


__version__ = "0.1.0"

# the reference pyspla exports a list of versions (python/pyspla/version.py)
VERSIONS = [__version__]

__all__ = [
    "algorithms",
    "formats",
    "interop",
    "kernels",
    "op",
    "ops",
    "mxmT_masked",
    "m_reduce",
    "count_mxm_products",
    "count_mxmT_products",
    "tc",
    "Scalar",
    "DenseVec",
    "SparseVec",
    "CooMatrix",
    "CsrMatrix",
    "BsrMatrix",
    "Descriptor",
    "Type",
    "BOOL",
    "INT",
    "UINT",
    "FLOAT",
    "type_from_dtype",
    "Library",
    "get_library",
    "Schedule",
    "ScheduleTask",
    "make_schedule",
    "__version__",
    "VERSIONS",
    # imported at first use (module __getattr__)
    "Matrix",
    "Vector",
    "Array",
    "MemView",
    "Object",
    "FormatMatrix",
    "FormatVector",
    "Op",
    "OpUnary",
    "OpBinary",
    "OpSelect",
    "MtxLoader",
    "Timer",
]
