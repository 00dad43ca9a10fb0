"""uint32 data moved as the int32 of its bits.

PyTorch's CUDA kernels cover few ops for uint32 (``index_cuda`` and
``where_cuda`` raise for it), so the port gathers, selects and concatenates
uint32 tensors through their int32 view, which those ops leave bit for bit
unchanged; arithmetic on uint32 widens to int64 (``op._via_int64``).  Other
dtypes pass straight through.
"""

from __future__ import annotations

import torch

__all__ = ["bits", "gather", "where", "cat"]


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t``, or for uint32 the int32 view of its bits."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def gather(t: torch.Tensor, idx) -> torch.Tensor:
    """``t[idx]`` for any dtype."""
    return bits(t)[idx].view(t.dtype)


def _like(x, dtype, device):
    if isinstance(x, torch.Tensor):
        return x
    return torch.full((), x.item() if hasattr(x, "item") else x, dtype=dtype, device=device)


def where(cond: torch.Tensor, a, b) -> torch.Tensor:
    """``torch.where(cond, a, b)``: a uint32 operand, and a number beside it,
    as int32 bits."""
    dtype = a.dtype if isinstance(a, torch.Tensor) else b.dtype
    if dtype != torch.uint32:
        return torch.where(cond, a, b)
    a, b = (_like(x, dtype, cond.device) for x in (a, b))
    return torch.where(cond, bits(a), bits(b)).view(dtype)


def cat(tensors) -> torch.Tensor:
    """``torch.cat`` for any dtype."""
    return torch.cat([bits(t) for t in tensors]).view(tensors[0].dtype)
