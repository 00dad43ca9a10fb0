"""The plain reference for triangle counts, its controls, and the comparison.

Plain PyTorch over the benchmark's own COO arrays (sorted row-major, both
directions of every edge stored, no self-loops); it imports nothing of the
program.  It is GAP's ordered count (gapbs ``tc.cc`` ``OrderedCount``): for
each edge (u, v) with v < u, and each neighbour w of v with w < v, one
triangle where w is a neighbour of u, so each triangle {w < v < u} counts
once.  A probe looks the key ``u·n + w`` up in the graph's row-major keys
(``torch.searchsorted``), in blocks of at most ``BLOCK`` probes, so that the
reference fits beside what the run holds.  The program counts each
triangle six times (``queries/tc.py``): the reference is 6 × the ordered
count, in int64.

The controls are the reference with a guarantee broken:
``last_rows_dropped``, the count with the edges of the last 1/64 of the
rows left out (a run that drops work: the triangles whose largest vertex
lies there), and ``half_mask``, the count over the mask entries (i, j) with
i < j only: each triangle has three of its six entries there, so it reads
3 × the ordered count.

``count_mismatch`` is ``|out − ref|``; the count is an integer, so its
limit is 0.
"""

from __future__ import annotations

import torch

BLOCK = 1 << 26  # probes a block
DROPPED_ROWS = 64  # the first control leaves out the edges of the last 1/64 of the rows


def _block_ends(counts: torch.Tensor, limit: int) -> list:
    """Ends of consecutive ranges of ``counts`` whose sums are at most
    ``limit`` (more only for a single entry)."""
    ends = torch.cumsum(counts, 0)
    out, at, base = [], 0, 0
    while at < counts.numel():
        nxt = int(torch.searchsorted(ends, base + limit, right=True))
        nxt = max(nxt, at + 1)
        out.append(nxt)
        at, base = nxt, int(ends[nxt - 1])
    return out


def ordered_count(graph, rows_below: int | None = None) -> int:
    """GAP's ordered count of the graph's triangles, over the edges (u, v),
    v < u, whose u is below ``rows_below`` (every edge where None)."""
    n, device = graph.n, graph.device
    keys = graph.rows.to(torch.int64) * n + graph.cols
    bounds = torch.arange(n + 1, dtype=torch.int64, device=device)
    start = torch.searchsorted(keys, bounds * n)  # row v's entries: [start[v], start[v + 1])
    low_end = torch.searchsorted(keys, bounds[:n] * (n + 1))  # its neighbours w < v: [start[v], low_end[v])
    lower = graph.cols < graph.rows
    if rows_below is not None:
        lower &= graph.rows < rows_below
    edges = torch.nonzero(lower).flatten()
    del lower
    v_all = graph.cols[edges].long()
    probes = low_end[v_all] - start[v_all]
    total, at = 0, 0
    for end in _block_ends(probes, BLOCK):
        e, v, cnt = edges[at:end], v_all[at:end], probes[at:end]
        m = int(cnt.sum())
        if m:
            src = torch.repeat_interleave(torch.arange(cnt.numel(), device=device), cnt, output_size=m)
            first = torch.cumsum(cnt, 0) - cnt
            w = graph.cols[start[v][src] + torch.arange(m, device=device) - first[src]]
            probe = graph.rows[e].long()[src] * n + w
            del src, first, w
            pos = torch.searchsorted(keys, probe).clamp_(max=keys.numel() - 1)
            total += int((keys[pos] == probe).sum())
            del probe, pos
        at = end
    return total


def reference(graph, source, mix) -> torch.Tensor:
    return torch.tensor([6 * ordered_count(graph)], dtype=torch.int64)


CONTROLS = {
    "last_rows_dropped": lambda graph, source, mix: torch.tensor(
        [6 * ordered_count(graph, graph.n - max(graph.n // DROPPED_ROWS, 1))], dtype=torch.int64),
    "half_mask": lambda graph, source, mix: torch.tensor([3 * ordered_count(graph)], dtype=torch.int64),
}


def readings(graph, mix) -> dict:
    """The triangles T, the program's count 6T, and each control's count."""
    t = ordered_count(graph)
    return {"triangles": t, "six_t": 6 * t,
            "controls": {name: int(fn(graph, None, mix)[0]) for name, fn in CONTROLS.items()}}


def compare(out: torch.Tensor, ref: torch.Tensor, mix) -> dict:
    if out.shape != ref.shape:
        return {"count_mismatch": float("inf")}
    return {"count_mismatch": float((out.to(ref.device, torch.int64) - ref).abs().max())}
