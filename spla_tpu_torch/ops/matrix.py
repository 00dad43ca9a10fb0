"""Matrix ops (counterpart of ``spla_tpu/ops/matrix.py``); so far the one
that triangle counting needs."""

from __future__ import annotations

import torch

from ..containers import CsrMatrix, Scalar
from ..utils.segments import segment_fold

__all__ = ["m_reduce"]


def m_reduce(init, M: CsrMatrix, op_reduce) -> Scalar:
    """Scalar fold of ``op_reduce`` over the stored values, starting at
    ``init`` (reference exec_m_reduce, ``cpu_m_reduce.hpp``).  Runs where
    M lives; the result stays on the device."""
    init_t = torch.as_tensor(init.value if isinstance(init, Scalar) else init,
                             dtype=M.values.dtype, device=M.values.device)
    seg = torch.zeros(M.values.shape, dtype=torch.int32, device=M.values.device)
    out, _ = segment_fold(M.values, seg, M.valid_mask(), 1, op_reduce, init_t)
    return Scalar(out[0])
