"""pull_ms_per_query (kernels, device trace): kernel 1's device time
(``kernels/spmv.py``: ``spmv_pull_kernel``, ``spmv_pull_structural_kernel``)
over the traced window, a query."""

KERNEL1 = r"\bspmv_pull(_structural)?_kernel\b"


def read(run):
    if run.trace is None or run.queries == 0:
        return None
    seconds, count = run.trace.device_time(KERNEL1)
    if count == 0:
        return None
    return seconds / run.queries * 1e3
