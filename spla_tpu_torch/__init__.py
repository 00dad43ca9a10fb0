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
* MatrixMarket IO (``io``), a timer (``timer``), the library settings
  (``library``) and the ``bfs``, ``sssp``, ``pr`` and ``tc`` example CLIs
  (``python -m spla_tpu_torch.examples.bfs ...``).

The device is explicit: containers are built with ``device=`` and ops run
where their tensors live; nothing picks ``cuda`` on its own.  CPU tensors
take each kernel's plain PyTorch version; CUDA tensors launch the kernel
or raise.  This package imports neither jax nor spla_tpu.
"""

from . import algorithms, formats, interop, kernels, op, ops
from .algorithms import tc
from .containers import BsrMatrix, CooMatrix, CsrMatrix, DenseVec, Scalar, SparseVec
from .descriptor import Descriptor
from .ops import count_mxm_products, count_mxmT_products, m_reduce, mxmT_masked
from .types import BOOL, FLOAT, INT, UINT, Type, type_from_dtype

__version__ = "0.1.0"

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
    "__version__",
]
