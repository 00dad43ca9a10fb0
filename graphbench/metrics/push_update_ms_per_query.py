"""push_update_ms_per_query (kernels, device trace): the device time of kernel 2's
push levels (``kernels/traversal.py``) and kernel 3's level updates
(``kernels/level_update.py``) over the traced window, a query."""

KERNELS_2_3 = (r"\b(bfs_push_level|sssp_push|spmv_push|spmv_push_structural|bfs_update|sssp_update"
               r"|sssp_touched)_kernel\b")


def read(run):
    if run.trace is None or run.queries == 0:
        return None
    seconds, count = run.trace.device_time(KERNELS_2_3)
    if count == 0:
        return None
    return seconds / run.queries * 1e3
