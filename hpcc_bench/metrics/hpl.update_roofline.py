"""hpl.update_roofline: the least time HPL's trailing updates need, over the
device time of the update kernels in one solve, in %.

The work counted is what LU needs, whatever implements it: at iteration k
(k = 0 .. n/b - 1) the trailing t x t block, t = n - (k+1) b, is read and
written once and its two b-wide panels are read once (float32), or its
2 b t^2 operations run at the float32 peak, whichever takes longer, at the
published bandwidth and peak (``peaks.json``). The kernels timed are every
device kernel whose name holds ``KERNELS``' names: the bulk update and, with
lookahead, its strip updates.
"""

KERNELS = ("gemm_update",)
BYTES = 4  # float32


def needed(n: int, b: int):
    """(bytes, operations) of each iteration's trailing update."""
    out = []
    for k in range(n // b):
        t = n - (k + 1) * b
        out.append((BYTES * (2 * t * t + 2 * b * t), 2 * b * t * t))
    return out


def least_seconds(n: int, b: int, bandwidth: float, flops: float) -> float:
    return sum(max(nb / bandwidth, ops / flops) for nb, ops in needed(n, b))


def read(ctx):
    peaks = ctx.peaks or {}
    bw, peak = peaks.get("hbm_bytes_per_s"), peaks.get("fp32_flops")
    spent = ctx.trace.seconds(*KERNELS)
    if not (bw and peak and ctx.units and spent > 0):
        return None
    p = ctx.cell.params
    least = least_seconds(int(p["n"]), int(p["b"]), bw, peak)
    return 100.0 * least / (spent / ctx.units)
