"""Triangle counts through the program: ``algorithms.tc(A)``.

GAP's TC (gapbs ``tc.cc``) counts each triangle of the undirected graph
once.  The program sums A ⊙ (A·Aᵀ) (reference ``src/algorithm.cpp:380-414``),
which counts each triangle of a symmetric graph six times, once for each
of its ordered entries.  The guarantee: the exact count, 6 × the
triangles, an integer summed in int64.

The values are int32 ones, not the benchmark's weights: GAP's TC is
unweighted, and on ones ``tc`` finds a 0/1 pattern and runs kernel 4's
structural instance; fed the weights 1-255 it would sum their products, a
weighted count.  A query is one launch of kernel 4 over every stored
entry and one host read of the count.  It has no source.
"""

from __future__ import annotations

import torch

from graphbench.core import port

SOURCES = False


def prepare(graph, mix):
    ones = torch.ones(graph.nnz, dtype=torch.int32, device=graph.device)
    return port.csr(graph, ones, 0)


def run(A, source, mix):
    from spla_tpu_torch import algorithms

    return torch.tensor([algorithms.tc(A)], dtype=torch.int64)


def warm(A, hub, mix):
    """One full count, which builds kernel 4's plan and caches the pattern
    check; returns it, whose shape and type the sample's slots take."""
    return run(A, hub, mix)
