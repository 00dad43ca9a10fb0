"""Functional op layer: the counterparts of ``spla_tpu.ops``, the 20
``exec_*`` operations of the reference (``include/spla/exec.hpp:53-519``),
under their names and the ``exec_*`` aliases; plus the port's dispatch
counts (``DISPATCH_STATS``), ``best_spmv_fn`` and ``mxmT_masked_reduce``."""

from .spmv import (
    DISPATCH_STATS,
    best_spmv_fn,
    masked_spmv,
    masked_spmv_structural,
    mxv_masked,
    vxm_masked,
    vxm_masked_dense,
)
from .vector import v_assign_masked, v_count_mf, v_eadd, v_eadd_fdb, v_emult, v_map, v_reduce
from .matrix import (
    kron,
    m_eadd,
    m_emult,
    m_extract_column,
    m_extract_row,
    m_reduce,
    m_reduce_by_column,
    m_reduce_by_row,
    m_transpose,
)
from .spgemm import count_mxm_products, count_mxmT_products, mxm, mxmT_masked, mxmT_masked_reduce
from .bsr import bsr_spmm, bsr_spmv

__all__ = [
    "DISPATCH_STATS",
    "best_spmv_fn",
    "masked_spmv",
    "masked_spmv_structural",
    "mxv_masked",
    "vxm_masked",
    "vxm_masked_dense",
    "v_eadd",
    "v_emult",
    "v_map",
    "v_reduce",
    "v_count_mf",
    "v_assign_masked",
    "v_eadd_fdb",
    "m_eadd",
    "m_emult",
    "m_reduce",
    "m_reduce_by_row",
    "m_reduce_by_column",
    "m_transpose",
    "m_extract_row",
    "m_extract_column",
    "kron",
    "mxm",
    "mxmT_masked",
    "mxmT_masked_reduce",
    "count_mxm_products",
    "count_mxmT_products",
    "bsr_spmv",
    "bsr_spmm",
]

# the reference's exec_* names (include/spla/exec.hpp:53-519): each op runs at once
exec_mxm = mxm
exec_mxmT_masked = mxmT_masked
exec_kron = kron
exec_mxv_masked = mxv_masked
exec_vxm_masked = vxm_masked
exec_m_eadd = m_eadd
exec_m_emult = m_emult
exec_m_reduce = m_reduce
exec_m_reduce_by_row = m_reduce_by_row
exec_m_reduce_by_column = m_reduce_by_column
exec_m_transpose = m_transpose
exec_m_extract_row = m_extract_row
exec_m_extract_column = m_extract_column
exec_v_eadd = v_eadd
exec_v_emult = v_emult
exec_v_eadd_fdb = v_eadd_fdb
exec_v_assign_masked = v_assign_masked
exec_v_map = v_map
exec_v_reduce = v_reduce
exec_v_count_mf = v_count_mf

__all__ += [n for n in dir() if n.startswith("exec_")]
