"""k4_ps_per_product (kernels, device trace): kernel 4's device time over the
window (``kernels/mxmt.py`` ``mxmt_reduce``: the ``mxmt_kernel`` instances of
mode 0, not kernel 5's mode 1 nor the gather's mode 2) over the products that
``tc`` walked (``algorithms.STATS["tc_products"]``), in picoseconds.  None
where either side has nothing to read."""

KERNEL4 = r"\bmxmt_kernel<0,"


def read(run):
    products = run.counters["stats"].get("tc_products")
    if run.trace is None or not products:
        return None
    seconds, count = run.trace.device_time(KERNEL4)
    if count == 0:
        return None
    return seconds / products * 1e12
