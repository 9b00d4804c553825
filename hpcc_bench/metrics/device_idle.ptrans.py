"""device_idle.ptrans: the share of the traced window in which no operation ran on
the device, in %: 1 - busy / window (one stream, so the device's
operations do not overlap; their union is the busy time).
"""


def read(ctx):
    t = ctx.trace
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
