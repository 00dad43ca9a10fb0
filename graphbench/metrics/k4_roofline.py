"""k4_roofline (kernels, device trace): kernel 4's share of its roofline on a
triangle count, in %: the least time its work could take on this card
(``mxmt_reduce_work`` against ``core.roofline``'s peaks) over kernel 4's mean
device time a launch in the traced window (the pattern of
``k4_ps_per_product``).

The work is that of ``chip_smoke.py`` ``mxmt_bound`` for kernel 4's
structural count with mask = A = B, as ``tc`` calls it: each distinct input
read once (the one matrix's indptr and columns; no values) and the 8-byte
total written once.  Only a ``tc`` mix runs kernel 4 so; a card the table
of peaks lacks reads nothing."""

from graphbench.core.roofline import PEAKS, bound_s
from graphbench.core.spec import load_module

KERNEL4 = load_module("metrics", "k4_ps_per_product").KERNEL4


def mxmt_reduce_work(n: int, nnz: int) -> tuple:
    """``(bytes, flops)`` of kernel 4's structural count over an n x n CSR of
    ``nnz`` entries that is the mask, A and B at once: indptr and cols read
    once, the int64 total written once; no f32 operation."""
    return 4 * (n + 1) + 4 * nnz + 8, 0


def read(run):
    if run.trace is None or run.cell.mix["query"] != "tc" or run.device_name not in PEAKS:
        return None
    seconds, count = run.trace.device_time(KERNEL4)
    if count == 0:
        return None
    least, _ = bound_s(*mxmt_reduce_work(run.n, run.nnz), PEAKS[run.device_name])
    return least / (seconds / count) * 100
