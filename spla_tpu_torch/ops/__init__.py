"""Functional op layer: the masked SpMV, SpGEMM and masked SpGEMM-T slices
of ``spla_tpu/ops``, and ``m_reduce``."""

from .matrix import m_reduce
from .spgemm import count_mxm_products, count_mxmT_products, mxm, mxmT_masked, mxmT_masked_reduce
from .spmv import (
    DISPATCH_STATS,
    best_spmv_fn,
    masked_spmv,
    masked_spmv_structural,
    mxv_masked,
    vxm_masked,
    vxm_masked_dense,
)

__all__ = [
    "DISPATCH_STATS",
    "best_spmv_fn",
    "masked_spmv",
    "masked_spmv_structural",
    "mxv_masked",
    "vxm_masked",
    "vxm_masked_dense",
    "mxm",
    "mxmT_masked",
    "mxmT_masked_reduce",
    "count_mxm_products",
    "count_mxmT_products",
    "m_reduce",
]
