"""Parallel primitives (counterpart of ``spla_tpu/utils/primitives.py``)."""

from __future__ import annotations

import torch

__all__ = ["sort_by_key", "prefix_sum", "expand_schedule"]


def sort_by_key(keys, *values):
    """Stable ascending sort of ``(keys, values...)`` by ``keys``."""
    order = torch.argsort(keys, stable=True)
    return (keys[order], *(v[order] for v in values))


def prefix_sum(x):
    """Exclusive prefix sum, in the dtype of ``x``."""
    return (torch.cumsum(x, 0) - x).to(x.dtype)


def expand_schedule(outer_deg, valid, products_cap: int):
    """Prefix-sum expansion (counterpart of ``spla_tpu/ops/spgemm.py``
    ``_expand_schedule``): outer entry e owns ``outer_deg[e]`` consecutive
    product slots where ``valid[e]``.  Returns int32 ``src`` (the entry of
    each of the ``products_cap`` slots), int32 ``local`` (its rank within
    the entry) and bool ``slot_valid`` (the slot lies below the total).

    ``src`` comes from run-start markers and a cumsum; entries with no
    slots stack their markers and are skipped."""
    if products_cap >= 1 << 31:
        raise ValueError(f"products_cap {products_cap} needs 64-bit slot indices")
    device = outer_deg.device
    deg = torch.where(valid, outer_deg.long(), 0)
    ends = torch.cumsum(deg, 0)
    total = ends[-1] if ends.numel() else torch.zeros((), dtype=torch.int64, device=device)
    starts = (ends - deg).clamp(max=products_cap).to(torch.int32)
    marks = torch.zeros(products_cap + 1, dtype=torch.int32, device=device)
    marks.index_add_(0, starts.long(), torch.ones_like(starts))
    src = torch.cumsum(marks[:products_cap], 0, dtype=torch.int32) - 1
    src = src.clamp(0, max(outer_deg.shape[0] - 1, 0))
    t = torch.arange(products_cap, dtype=torch.int32, device=device)
    local = t - starts[src.long()]
    return src, local, t < total
