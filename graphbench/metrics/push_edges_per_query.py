"""push_edges_per_query (kernels, program counter): the stored entries of the
lists that kernel 2's push levels walked over the window (``algorithms.STATS
["push_edges"]``, each query's source's degree among them), a query.  None
where the program has no such counter or ran no push level."""


def read(run):
    stats = run.counters["stats"]
    if not stats.get("push") or "push_edges" not in stats or run.queries == 0:
        return None
    return stats["push_edges"] / run.queries
