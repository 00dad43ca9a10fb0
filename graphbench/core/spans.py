"""The program's spans in a traced window, and the device's idle inside them.

``spla_tpu_torch`` names ranges of its host work in a ``torch.profiler``
trace (``spla_tpu_torch.profiling.span``), each name starting ``spla.``:
the public call (``spla.bfs``, ``spla.sssp``, ``spla.pr``) and, nested in
it, a level's launches (``spla.level.push``, ``spla.level.pull``) and the
loop's host read (``spla.level.read``).  The profiler records such a range
as a host operation on the loop's thread, with no projection onto the
device, so ``core.trace`` keeps it among ``Trace.host_ops`` and never among
``device_ops``.  A program without spans leaves none there, and the readers
built on this module then give None.

The arithmetic is plain Python over ``(start, end)`` pairs, beside
``core.trace``'s ``union`` and ``gaps``, so the tests can hold it to
hand-made values.
"""

from __future__ import annotations

from .trace import gaps, length, union

PREFIX = "spla."  # the start of every span name the program gives


def intersect(a, b) -> list:
    """The parts that the sorted disjoint intervals ``a`` and ``b`` share."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def spans(trace) -> list:
    """``(name, start, end)`` of the program's spans in ``trace``, clipped to its window."""
    return [(n, max(s, trace.lo), min(e, trace.hi)) for n, s, e in trace.host_ops
            if n.startswith(PREFIX)]


def idle_within(trace, names) -> float:
    """Seconds of the window's idle inside the union of the spans named in ``names``."""
    inside = union((s, e) for n, s, e in spans(trace) if n in names)
    return length(intersect(gaps(trace.busy(), trace.lo, trace.hi), inside))
