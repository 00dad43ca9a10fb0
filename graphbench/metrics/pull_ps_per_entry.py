"""pull_ps_per_entry (kernels, device trace): kernel 1's device time (the
pattern of ``pull_ms_per_query``) over the stored entries of the rows its
pulls selected (``algorithms.STATS["pull_entries"]``), in picoseconds.  Not a
share of a roofline: the structural pull leaves a row at its first hit, so
the bytes it reads are not known outside the kernel.  None where either
side has nothing to read."""

from graphbench.core.spec import load_module

KERNEL1 = load_module("metrics", "pull_ms_per_query").KERNEL1


def read(run):
    entries = run.counters["stats"].get("pull_entries")
    if run.trace is None or not entries:
        return None
    seconds, count = run.trace.device_time(KERNEL1)
    if count == 0:
        return None
    return seconds / entries * 1e12
