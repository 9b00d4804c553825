"""ptrans.transpose_add_roofline: the least time of C = B + A^T, over the
device time of ``transpose_add`` per step, in %.

A and B are read once and C written once, 3 n^2 float32 values, at the
published bandwidth (``peaks.json``); the kernel's time per step is summed
over its launches (one a strip, where the step is chunked).
"""

KERNELS = ("transpose_add",)
BYTES = 4  # float32


def read(ctx):
    bw = (ctx.peaks or {}).get("hbm_bytes_per_s")
    spent = ctx.trace.seconds(*KERNELS)
    if not (bw and ctx.units and spent > 0):
        return None
    n = int(ctx.cell.params["n"])
    return 100.0 * (3 * n * n * BYTES / bw) / (spent / ctx.units)
