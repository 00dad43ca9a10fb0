"""The plain reference for SSSP queries, its controls, and the comparison.

Plain PyTorch over the benchmark's own COO arrays; it imports nothing of the
program.  Bellman-Ford by rounds: each round relaxes every stored entry
whose row changed in the round before (``scatter_reduce`` with ``amin``)
until no distance changes.  The weights are whole numbers from 1 to 255 and
every distance stays far below 2^24, so f32 holds every sum exactly in any
order, here and in the program: the comparison is exact.

The controls, in the program's place (the first is the one the limit is
held against):

* ``bf16``: the reference in bfloat16, the precision below the f32 the
  configuration states.  bfloat16 holds every whole number to 256 exactly,
  so it fails only where a distance passes 256: on GAP's urand at scale 24
  a few hundred vertices of a query do, at the tiny scales of the tests
  none do unless the graph is sparse;
* ``one_round_short``: the reference stopped one round before its fixed
  point, which breaks the guarantee that every distance is the shortest.
"""

from __future__ import annotations

import torch


def distances(graph, source: int, dtype=torch.float32, stop_short: bool = False) -> torch.Tensor:
    inf = float("inf")
    d = torch.full((graph.n,), inf, dtype=dtype, device=graph.device)
    d[source] = 0
    w = graph.weights.to(dtype)
    changed = torch.zeros(graph.n, dtype=torch.bool, device=graph.device)
    changed[source] = True
    before = d
    while True:
        live = changed[graph.rows]
        cand = d[graph.rows[live]] + w[live]
        nd = d.clone()
        nd.scatter_reduce_(0, graph.cols[live].long(), cand, "amin")
        del live, cand
        changed = nd < d
        if not bool(changed.any()):
            break
        before, d = d, nd
    return (before if stop_short else d).to(torch.float32)


def reference(graph, source, mix) -> torch.Tensor:
    return distances(graph, source)


CONTROLS = {
    "bf16": lambda graph, source, mix: distances(graph, source, dtype=torch.bfloat16),
    "one_round_short": lambda graph, source, mix: distances(graph, source, stop_short=True),
}


def compare(out: torch.Tensor, ref: torch.Tensor, mix) -> dict:
    """``dist_mismatch``: vertices whose distance is not the reference's (+inf
    equals +inf; a NaN never matches)."""
    if out.shape != ref.shape:
        return {"dist_mismatch": float(ref.numel())}
    return {"dist_mismatch": float((out.to(ref.device, torch.float32) != ref).sum())}
