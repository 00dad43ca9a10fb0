"""device_idle_share (device, device trace): in %, the share of the traced window
in which no kernel, copy or memset ran on the device (1 - the union of
their intervals over the window)."""


def read(run):
    t = run.trace
    if t is None or not t.device_ops or t.window_s <= 0:
        return None
    return (1 - t.busy_s / t.window_s) * 100
