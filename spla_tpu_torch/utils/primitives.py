"""Parallel primitives (counterpart of ``spla_tpu/utils/primitives.py``)."""

from __future__ import annotations

import torch

from .segments import segment_fold

__all__ = ["sort_by_key", "reduce_by_key", "prefix_sum", "inclusive_scan", "exclusive_scan",
           "lex_order", "expand_schedule"]


def sort_by_key(keys, *values):
    """Stable ascending sort of ``(keys, values...)`` by ``keys``."""
    order = torch.argsort(keys, stable=True)
    return (keys[order], *(v[order] for v in values))


def reduce_by_key(keys, values, op, num_segments, init=None):
    """Fold the runs of equal sorted ``keys``: dense ``(out[num_segments],
    has[num_segments])``, ``out[k]`` the fold of key k's values onto
    ``init``.  ``init`` defaults to the op's identity; an op with none needs
    an explicit ``init`` (a silent 0 would corrupt a MIN fold)."""
    if init is None:
        init = getattr(op, "identity", None)
        if init is None:
            raise ValueError(f"op {getattr(op, 'name', op)} has no identity; pass init=")
    valid = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    return segment_fold(values, keys, valid, num_segments, op, init)


def prefix_sum(x):
    """Exclusive prefix sum, in the dtype of ``x``."""
    return (torch.cumsum(x, 0) - x).to(x.dtype)


def inclusive_scan(x):
    """Inclusive prefix sum in the dtype of ``x`` (int32 for bool, as
    ``jnp.cumsum`` gives)."""
    return torch.cumsum(x, 0).to(torch.int32 if x.dtype == torch.bool else x.dtype)


exclusive_scan = prefix_sum


def lex_order(keys, sizes):
    """The stable permutation that sorts by ``keys[0]``, then ``keys[1]``,
    ... (``lax.sort`` with ``num_keys=len(keys)``); ``keys[i]`` lies in
    ``[0, sizes[i])``.  One argsort of a fused int64 key when the product
    of ``sizes`` is at most 2**63, else one stable argsort a key, from the
    last key to the first."""
    total = 1
    for s in sizes:
        total *= s
    if total <= 1 << 63:
        fused = keys[0].long()
        for k, s in zip(keys[1:], sizes[1:]):
            fused = fused * s + k.long()
        return torch.argsort(fused, stable=True)
    order = torch.argsort(keys[-1], stable=True)
    for k in reversed(keys[:-1]):
        order = order[torch.argsort(k[order], stable=True)]
    return order


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
