"""hpl.launches_per_solve: device operations per solve in the trace.

Kernels, copies and fills that ran on the device over the traced solves,
per solve; ``hand_written`` beside it is how many of them the port's kernel
wrappers launched (``repro_torch.kernels.ops.launch_counts``), the rest
being PyTorch's glue: masks, write-backs, clones.
"""


def read(ctx):
    ops = ctx.trace.count()
    if not ctx.units or not ops:
        return None
    return {"value": ops / ctx.units,
            "hand_written": sum(ctx.launches.values()) / ctx.units}
