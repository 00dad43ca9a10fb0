"""levels_per_query (level loop, program counter): ``algorithms.STATS["levels"]``
over the window, a level loop's levels (PageRank: its iterations) a query."""


def read(run):
    if run.queries == 0:
        return None
    return run.counters["stats"]["levels"] / run.queries
