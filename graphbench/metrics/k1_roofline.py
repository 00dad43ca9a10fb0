"""k1_roofline (kernels, device trace): kernel 1's share of its roofline on a
full pull, in %: the least time one (MULT, PLUS) f32 pull over the whole
CSR could take on this card (``core.roofline``: indptr, cols, values and x
read once, y written once, against the table's peaks) over kernel 1's mean
device time a launch in the traced window.

Only PageRank's launches are all full pulls; a traversal's pulls select
rows, whose work the trace cannot see, so it reads nothing there.  A card
the table of peaks lacks reads nothing too."""

from graphbench.core.roofline import PEAKS, bound_s, spmv_pull_work

KERNEL1 = r"\bspmv_pull_kernel\b"


def read(run):
    if run.trace is None or run.cell.mix["query"] != "pr" or run.device_name not in PEAKS:
        return None
    seconds, count = run.trace.device_time(KERNEL1)
    if count == 0:
        return None
    least, _ = bound_s(*spmv_pull_work(run.n, run.n, run.nnz), PEAKS[run.device_name])
    return least / (seconds / count) * 100
