"""hpl_mfu: the whole solve's share of the card's float32 peak, in %.

HPL's 2/3 n^3 operations per solve over the median time of the window's
untraced solves (host clock, from the call to a synchronize after it), as a
share of the published float32 peak (``peaks.json``; the run's
``device.power`` gives the card's power limit beside it). It bounds what any
kernel's gain can give end to end.
"""


def read(ctx):
    peak = (ctx.peaks or {}).get("fp32_flops")
    if not peak or not ctx.unit_s:
        return None
    n = int(ctx.cell.params["n"])
    return 100.0 * (2.0 * n ** 3 / 3.0) / ctx.unit_s / peak
