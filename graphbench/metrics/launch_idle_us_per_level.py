"""launch_idle_us_per_level (level loop, device trace): the device's idle time
inside the program's ``spla.level.push`` and ``spla.level.pull`` spans (a
level's host work, from the direction chosen to the return of its last
launch) over the levels the window ran (``algorithms.STATS["levels"]``).
None where the trace holds no such span."""

from graphbench.core.spec import load_module

SPANS = ("spla.level.push", "spla.level.pull")


def read(run):
    return load_module("metrics", "query_idle_us_per_level").idle_us_per_level(run, SPANS)
