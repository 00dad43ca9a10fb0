"""BFS queries through the program: ``algorithms.bfs(A, s, At=A)``.

``At=A`` declares the graph symmetric, as it is, so the program neither
builds nor checks a transpose.  A graph of this size takes the level loop
(its CSR is far above ``RESIDENT_BYTES``): push levels by kernel 2, pull
levels by kernel 1's structural pull and kernel 3's update, the frontier's
size read on the host once a level.
"""

from __future__ import annotations

from graphbench.core import port

SOURCES = True  # a query starts from a source vertex


def prepare(graph, mix):
    return port.csr(graph, graph.weights, 0.0)


def run(A, source, mix):
    from spla_tpu_torch import algorithms

    return algorithms.bfs(A, source, At=A).values


def warm(A, hub, mix):
    """Two queries from a vertex of the largest degree: both kinds of level,
    and the pull plan, which the program builds at its first pull.  Returns
    the last result, whose shape and type the sample's slots take."""
    run(A, hub, mix)
    return run(A, hub, mix)
