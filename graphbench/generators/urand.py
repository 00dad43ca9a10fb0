"""GAP's ``urand`` edges: Erdős–Rényi, both ends uniform over the vertices
(gapbs ``src/generator.h`` ``MakeUniformEL``)."""

from __future__ import annotations

import torch


def edges(config: dict, scale: int, g: torch.Generator, device, chunk: int):
    """Yield ``(src, dst)`` int64 chunks of ``edge_factor << scale`` edges."""
    n = 1 << scale
    total = int(config["edge_factor"]) << scale
    for lo in range(0, total, chunk):
        m = min(chunk, total - lo)
        src = torch.randint(0, n, (m,), generator=g, device=device, dtype=torch.int64)
        dst = torch.randint(0, n, (m,), generator=g, device=device, dtype=torch.int64)
        yield src, dst
