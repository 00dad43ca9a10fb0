"""Row-windowed binary search (counterpart of ``spla_tpu/utils/search.py``).

For each query q with a window ``[lo_q, hi_q)`` into a flat column array
whose rows are sorted ascending, find the position of ``key_q`` if present.
A fixed number of lower-bound bisection steps, vectorized over the queries.
"""

from __future__ import annotations

import torch

__all__ = ["rowwise_find", "bisect_steps"]


def rowwise_find(flat_sorted, lo, hi, keys, steps: int = 32):
    """Search ``flat_sorted[lo:hi]`` (sorted ascending) for each key.

    Returns ``(pos, found)``: ``pos`` indexes ``flat_sorted`` at the first
    element not below the key (the lower bound; meaningless where not
    found).  With duplicate keys in a window, the first one matches.
    ``steps`` bounds the bisection; ``bisect_steps(max window)`` suffices."""
    last = flat_sorted.shape[0] - 1
    lo = lo.to(torch.int32)
    hi = hi.to(torch.int32)
    l, h = lo, hi
    for _ in range(steps):
        mid = torch.div(l + h, 2, rounding_mode="floor")
        v = flat_sorted[mid.clamp(0, last).long()]
        go_right = v < keys
        l = torch.where(go_right, mid + 1, l)
        h = torch.where(go_right, h, mid)
    pos = l.clamp(0, last)
    found = (l < hi) & (flat_sorted[pos.long()] == keys)
    return pos, found


def bisect_steps(max_window: int) -> int:
    """Step count that covers windows of up to ``max_window`` elements."""
    s = 1
    while (1 << s) <= max_window:
        s += 1
    return s
