"""device.idle_pct: share of the traced window's wall time that no device
operation covers: the union of the trace's device intervals (kernels, copies,
sets), not the sum of their times."""

LAYER = "device"
UNIT = "%"


def read(ctx):
    if ctx.events is None or not ctx.events["device"]:
        return None
    window = (ctx.window_ns[1] - ctx.window_ns[0]) / 1e9
    return 100.0 * (1.0 - ctx.busy_s / window)
