"""push_ps_per_edge (kernels, device trace): the device time of the push levels
(``kernels/traversal.py``: BFS's ``bfs_push_level_kernel``; SSSP's
``sssp_push_kernel`` and kernel 3's ``sssp_touched_kernel``) over the edges
their lists held (``algorithms.STATS["push_edges"]``), in picoseconds.
None where either side has nothing to read."""

PUSH_LEVELS = r"\b(bfs_push_level|sssp_push|sssp_touched)_kernel\b"


def read(run):
    edges = run.counters["stats"].get("push_edges")
    if run.trace is None or not edges:
        return None
    seconds, count = run.trace.device_time(PUSH_LEVELS)
    if count == 0:
        return None
    return seconds / edges * 1e12
