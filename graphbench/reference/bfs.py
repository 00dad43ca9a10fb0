"""The plain reference for BFS queries, its control, and the comparison.

Plain PyTorch over the benchmark's own COO arrays (``core.graph.Graph``);
it imports nothing of the program.  A level takes every stored entry whose
row is in the frontier and marks its column, if unvisited, with the next
depth.  Depths are 1-based, 0 unreached, as the program gives them.

BFS is structural: no arithmetic, so no lower precision to run it in.  Its
control breaks the guarantee the configuration states instead, that every
reachable vertex gets its exact depth: the reference stopped one level
early, as a level loop would that ended on a stale frontier count.
"""

from __future__ import annotations

import torch


def depths(graph, source: int, drop_last_level: bool = False) -> torch.Tensor:
    depth = torch.zeros(graph.n, dtype=torch.int32, device=graph.device)
    depth[source] = 1
    front = torch.zeros(graph.n, dtype=torch.bool, device=graph.device)
    front[source] = True
    level = 1
    while True:
        reached = torch.zeros(graph.n, dtype=torch.bool, device=graph.device)
        reached[graph.cols[front[graph.rows]]] = True
        reached &= depth == 0
        if not bool(reached.any()):
            break
        level += 1
        depth[reached] = level
        front = reached
    if drop_last_level and level > 1:
        depth[depth == level] = 0
    return depth


def reference(graph, source, mix) -> torch.Tensor:
    return depths(graph, source)


CONTROLS = {"one_level_short": lambda graph, source, mix: depths(graph, source, drop_last_level=True)}


def compare(out: torch.Tensor, ref: torch.Tensor, mix) -> dict:
    """``depth_mismatch``: vertices whose depth differs from the reference's."""
    if out.shape != ref.shape:
        return {"depth_mismatch": float(ref.numel())}
    return {"depth_mismatch": float((out.to(ref.device, torch.int64) != ref.long()).sum())}
