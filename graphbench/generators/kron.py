"""GAP's ``kron`` edges: the Graph500 Kronecker generator.

Each edge picks one quadrant of the adjacency matrix at each of ``scale``
levels, with the probabilities A, B, C and 1 - A - B - C, as GAP's
``MakeKronEL`` does (gapbs ``src/generator.h``): a draw r below A + B keeps
the source's bit 0 and sets the destination's where r > A; otherwise the
source's bit is 1 and the destination's is set where r > A + B + C.  With
``permute`` the vertex labels then go through one random permutation, as
GAP's ``PermuteIDs`` does, so that the hubs do not sit at the low ids.
"""

from __future__ import annotations

import torch


def edges(config: dict, scale: int, g: torch.Generator, device, chunk: int):
    """Yield ``(src, dst)`` int64 chunks of ``edge_factor << scale`` edges."""
    a, b, c = (float(config[k]) for k in ("A", "B", "C"))
    n = 1 << scale
    total = int(config["edge_factor"]) << scale
    perm = torch.randperm(n, generator=g, device=device) if config.get("permute") else None
    for lo in range(0, total, chunk):
        m = min(chunk, total - lo)
        src = torch.zeros(m, dtype=torch.int64, device=device)
        dst = torch.zeros(m, dtype=torch.int64, device=device)
        for _ in range(scale):
            r = torch.rand(m, generator=g, device=device)
            high = r >= a + b
            src.mul_(2).add_(high)
            dst.mul_(2).add_(torch.where(high, r > a + b + c, r > a))
        if perm is not None:
            src, dst = perm[src], perm[dst]
        yield src, dst
