"""k1_segments_per_pull (kernels, program counter): the segments of x that
kernel 1's launches walked in turn over the window, a launch:
``kernels.LAUNCHES["pull_segments"]`` / (``["spmv_pull"]`` +
``["spmv_pull_generic"]``).  A value pull walks its hub rows one segment of
x at a time where x passes the card's L2 budget (``kernels/spmv.py``
``pull_plan``): S segments; one where x fits, where the matrix has no hub
row, and in a structural pull.  None where the program has no such counter
or launched no pull."""


def read(run):
    launches = run.counters["launches"]
    segments = launches.get("pull_segments")
    pulls = launches.get("spmv_pull", 0) + launches.get("spmv_pull_generic", 0)
    if segments is None or not pulls:
        return None
    return segments / pulls
