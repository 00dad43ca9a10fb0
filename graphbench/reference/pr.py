"""The plain reference for PageRank queries, its control, and the comparison.

Plain PyTorch over the benchmark's own COO arrays; it imports nothing of the
program and none of its values: the degrees and the scaled entries
alpha / deg(j) are worked out again here.  The reference is float64 and
runs its own stopping rule, the program's: ``p = A p + (1 - alpha) / n``
from p = 1 / n until the L2 norm of the step is at most eps (at most
10 000 iterations).  ``readings`` shows where GAP's own rule would stop,
from which the mix's eps is chosen.  The sums go through ``index_add_`` in
blocks of entries, so the reference fits beside what the run holds.

The control is the same iteration in bfloat16, the precision below the
f32 the configuration states, capped at ``CONTROL_ITERS`` iterations (its
step may never fall below eps).  ``one_iteration_short``, the float64
iteration stopped one step before its rule stops it, shows what a run that
ends early reads.

``rank_rel_l2`` is ``||p - p_ref||_2 / ||p_ref||_2``.  Against the
reference's own stop it also catches a run that stops early: one
iteration short moves p by about eps, far above the f32 rounding.
"""

from __future__ import annotations

import torch

BLOCK = 1 << 26  # entries a block
CONTROL_ITERS = 200


def _iterate(graph, mix, dtype):
    """Yield ``(p, step)`` after each iteration from p = 1 / n, where ``step``
    is ``p - p_prev`` in float64."""
    n = graph.n
    alpha = float(mix["alpha"])
    bounds = torch.arange(n + 1, dtype=torch.int32, device=graph.device)
    ptr = torch.searchsorted(graph.rows, bounds)
    scale = alpha / (ptr[1:] - ptr[:-1]).to(dtype)  # inf on isolated vertices, which no entry reads
    del ptr
    p = torch.full((n,), 1.0 / n, dtype=dtype, device=graph.device)
    while True:
        acc = torch.zeros(n, dtype=dtype, device=graph.device)
        for lo in range(0, graph.nnz, BLOCK):
            cols = graph.cols[lo:lo + BLOCK].long()
            acc.index_add_(0, graph.rows[lo:lo + BLOCK].long(), p[cols] * scale[cols])
            del cols
        p_new = acc + (1.0 - alpha) / n
        yield p_new, (p_new - p).to(torch.float64)
        p = p_new


def ranks(graph, mix, dtype=torch.float64, max_iters: int = 10_000, stop_short: bool = False) -> torch.Tensor:
    eps = float(mix["eps"])
    before = None
    for it, (p, step) in enumerate(_iterate(graph, mix, dtype), 1):
        if float(torch.linalg.vector_norm(step)) <= eps or it >= max_iters:
            break
        before = p
    if stop_short:
        return before if before is not None else torch.full_like(p, 1.0 / graph.n)
    return p


def readings(graph, mix) -> dict:
    """How many iterations GAP's own stop would take on this graph, and how
    many the mix's eps takes: the float64 iteration run until both have
    stopped, with the L1 and L2 norm of each step.  GAP's stop
    (``mix["gap_stop"]``) is an L1 norm of the step under ``l1``, after at most
    ``max_iters`` iterations; the program takes only an L2 eps, and the mix's
    eps is chosen from these readings to stop where GAP's rule does."""
    stop, eps = mix["gap_stop"], float(mix["eps"])
    l1s, l2s, gap_at, eps_at = [], [], None, None
    for it, (_, step) in enumerate(_iterate(graph, mix, torch.float64), 1):
        l1s.append(float(step.abs().sum()))
        l2s.append(float(torch.linalg.vector_norm(step)))
        if gap_at is None and (l1s[-1] < float(stop["l1"]) or it >= int(stop["max_iters"])):
            gap_at = it
        if eps_at is None and l2s[-1] <= eps:
            eps_at = it
        if (gap_at and eps_at) or it >= 100:
            break
    return {"gap_iterations": gap_at, "eps_iterations": eps_at, "step_l1": l1s, "step_l2": l2s}


def reference(graph, source, mix) -> torch.Tensor:
    return ranks(graph, mix)


CONTROLS = {
    "bf16": lambda graph, source, mix: ranks(graph, mix, torch.bfloat16, CONTROL_ITERS),
    "one_iteration_short": lambda graph, source, mix: ranks(graph, mix, stop_short=True),
}


def compare(out: torch.Tensor, ref: torch.Tensor, mix) -> dict:
    if out.shape != ref.shape:
        return {"rank_rel_l2": float("inf")}
    gap = torch.linalg.vector_norm(out.to(ref.device, torch.float64) - ref.double())
    return {"rank_rel_l2": float(gap / torch.linalg.vector_norm(ref.double()))}
