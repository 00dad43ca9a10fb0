"""pull_entries_per_query (kernels, program counter): the stored entries of the
rows kernel 1's pulls selected over the window (``algorithms.STATS
["pull_entries"]``: a BFS pull's unvisited rows, every row of an SSSP pull
or a PageRank iteration), a query.  None where the program has no such
counter or ran no pull."""


def read(run):
    entries = run.counters["stats"].get("pull_entries")
    if not entries or run.queries == 0:
        return None
    return entries / run.queries
