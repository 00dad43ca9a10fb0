"""query_p95_ms (end to end, host clock): the 95th percentile of the latency of
every query that completed in the window, each from its call to its
synchronised result (``statistics.quantiles``, inclusive method)."""

import statistics


def read(run):
    lat = run.window.latencies_s
    if len(lat) < 20:  # fewer than twenty leave no 95th percentile
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[-1] * 1e3
