"""query_idle_us_per_level (level loop, device trace): the device's idle time
inside the program's query spans (``spla.bfs``, ``spla.sssp``, ``spla.pr``)
over the levels the window ran (``algorithms.STATS["levels"]``): what the
program's host work costs a level.  ``idle_us_per_level`` less this is the
benchmark's own time between queries.  None where the trace holds no such
span (a program without them)."""

from graphbench.core import spans as S

SPANS = ("spla.bfs", "spla.sssp", "spla.pr")


def idle_us_per_level(run, names):
    """Microseconds of the window's idle inside the spans named ``names``, a
    level; None without a trace, a level or such a span."""
    t = run.trace
    levels = run.counters["stats"]["levels"]
    if t is None or not t.device_ops or levels == 0 or not any(s[0] in names for s in S.spans(t)):
        return None
    return S.idle_within(t, names) / levels * 1e6


def read(run):
    return idle_us_per_level(run, SPANS)
