"""read_idle_us_per_level (level loop, device trace): the device's idle time
inside the program's ``spla.level.read`` spans (the level loop's count
read, PageRank's step norm made and read, the resident route's round
count) over the levels the window ran (``algorithms.STATS["levels"]``).
None where the trace holds no such span."""

from graphbench.core.spec import load_module

SPANS = ("spla.level.read",)


def read(run):
    return load_module("metrics", "query_idle_us_per_level").idle_us_per_level(run, SPANS)
