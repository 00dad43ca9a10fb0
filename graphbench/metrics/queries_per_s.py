"""queries_per_s (end to end, host clock): queries completed over the window's
elapsed time, from the first query's call to the last one's return.  A
PageRank run is one query."""


def read(run):
    if not run.window.latencies_s or run.window.elapsed_s <= 0:
        return None
    return len(run.window.latencies_s) / run.window.elapsed_s
