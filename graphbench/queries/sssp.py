"""SSSP queries through the program: ``algorithms.sssp(A, s, At=A)``.

The CSR holds the GAP weights as f32 (whole numbers 1 to 255) with the fill
+inf.  On the level loop a push level is kernel 2's push and kernel 3's
update of the vertices it touched, a pull level kernel 1's (PLUS, MIN) pull
and kernel 3's update.
"""

from __future__ import annotations

from graphbench.core import port

SOURCES = True


def prepare(graph, mix):
    return port.csr(graph, graph.weights, float("inf"))


def run(A, source, mix):
    from spla_tpu_torch import algorithms

    return algorithms.sssp(A, source, At=A).values


def warm(A, hub, mix):
    """One query from a vertex of the largest degree; returns its result."""
    return run(A, hub, mix)
