"""idle_us_per_level (level loop, device trace): the device's idle time in the
traced window over the levels the window ran (``algorithms.STATS["levels"]``):
what the host costs each level, the frontier count's read among it."""


def read(run):
    t = run.trace
    levels = run.counters["stats"]["levels"]
    if t is None or not t.device_ops or levels == 0:
        return None
    return (t.window_s - t.busy_s) / levels * 1e6
