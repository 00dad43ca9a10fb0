"""PageRank queries through the program: ``algorithms.pr(A, alpha, eps)``.

GAP's PageRank: A[i, j] = alpha / deg(j) over the stored entries, so that
``p = A p + (1 - alpha) / n`` until the L2 norm of the step is at most eps.
GAP stops on the L1 norm of the step (``gap_stop`` in the mix); the program
takes only an L2 eps, so the mix's eps is the one that stops at the same
iteration on the cell's graph (``reference/pr.py`` ``readings``).
The values are the benchmark's (f32, from its own degree count); every
iteration is one full pull of kernel 1 (MULT, PLUS) and one host read.
A query has no source: each runs the whole iteration from p = 1 / n.
"""

from __future__ import annotations

import torch

from graphbench.core import port

SOURCES = False


def prepare(graph, mix):
    deg = graph.degrees().to(torch.float32)
    values = float(mix["alpha"]) / torch.index_select(deg, 0, graph.cols)
    return port.csr(graph, values, 0.0)


def run(A, source, mix):
    from spla_tpu_torch import algorithms

    return algorithms.pr(A, float(mix["alpha"]), float(mix["eps"])).values


def warm(A, hub, mix):
    """One iteration (eps = 1 stops after the first), which builds the pull
    plan; returns its ranks, whose shape and type the sample's slots take."""
    from spla_tpu_torch import algorithms

    return algorithms.pr(A, float(mix["alpha"]), 1.0).values
