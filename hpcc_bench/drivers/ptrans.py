"""PTRANS's timed loop: steps enqueued back to back on the port's 1x1 grid.

The entry point is ``repro_torch.core.ptrans.make_step``'s ``step`` on
``single_rank_mesh()`` and an engine with an explicit cost model (the
analytic model on the port's H100 figures, so no tuning table is read).
On a 1x1 grid a rank's local A and B are the whole matrices. Set-up makes
A and B on the device from the seed and runs a few warm steps. The window
enqueues ``step(A, B)`` with no synchronize between steps and records a
completion mark (a CUDA event) after each; the host stays at most
``IN_FLIGHT`` steps ahead of the device. Time runs from a mark before the
first step to the last step's mark. The traced units are consecutive steps
after the first, with the queue drained before and after them.

It keeps three of the C the window returned: two steps whose indices the
seed draws from the first 64, and the last. ``check`` compares each with
the reference's B + A^T, element for element (``c_gap``, exact).
:func:`readings` gives the same number for one seed of the port or of the
control in its place (``CONTROLS``: C added in bfloat16), for
``controls.py``.
"""
from __future__ import annotations

import random
import time

import hpcc_harness as hh

IN_FLIGHT = 8
WARM_STEPS = 3


def program(cell):
    """The port's timed entry point for ``cell``: ``step(A, B) -> C``."""
    from repro_torch.comm.autotune import CostModel
    from repro_torch.comm.engine import CollectiveEngine
    from repro_torch.comm.types import H100_80GB
    from repro_torch.core.ptrans import make_step
    from repro_torch.launch.mesh import single_rank_mesh

    p = cell.params
    n, b = int(p["n"]), int(p["b"])
    if n % b or int(p.get("pg", 1)) != 1:
        raise hh.BenchError(f"n={n}, b={b}, pg={p.get('pg')}: this loop "
                            "runs n = k b on a 1x1 grid")
    mesh = single_rank_mesh()
    engine = CollectiveEngine.for_mesh(mesh,
                                       cost_model=CostModel(hw=H100_80GB))
    return make_step(mesh, 1, engine, nchunks=int(p["nchunks"]))


CONTROLS = ("bf16",)


def readings(cell, seed: int, device, control=None) -> dict:
    """``c_gap`` of one step of the port's entry point on the seed's A and
    B, or of the control ``control`` in its place."""
    ref = hh.reference("ptrans_ref", cell.bench)
    a, b = ref.make_inputs(int(cell.params["n"]), seed, device)
    if control == "bf16":
        c = ref.transpose_add_bf16(a, b)
    elif control is None:
        c = program(cell)(a, b)
    else:
        raise hh.BenchError(f"no PTRANS control {control!r}; "
                            f"there are {CONTROLS}")
    return {"c_gap": ref.c_gap(c, a, b)}


class PtransRun:
    def __init__(self, cell, seed: int, device):
        self.step = program(cell)
        self.n = int(cell.params["n"])
        self.device = device
        self.ref = hh.reference("ptrans_ref", cell.bench)
        self.limits = cell.limits
        self.sync = hh.Sync(device)
        self.a, self.bm = self.ref.make_inputs(self.n, seed, device)
        self.keep_at = set(random.Random(seed).sample(range(64), 2))
        self.kept = {}
        for _ in range(WARM_STEPS):
            out = self.step(self.a, self.bm)
        self.sync()
        del out

    def window(self, seconds: float, trace=None) -> dict:
        from repro_torch.kernels.ops import launch_counts
        marks = hh.Marks(self.device)
        marks.mark()
        i, out, traced = 0, None, {}
        t_first = time.perf_counter()
        while True:
            if trace is not None and i == 1:
                marks.wait(i)
                before = launch_counts()
                trace.start()
            if i >= IN_FLIGHT:
                marks.wait(i - IN_FLIGHT + 1)
            out = self.step(self.a, self.bm)
            marks.mark()
            if i in self.keep_at:
                self.kept[i] = out
            i += 1
            if trace is not None and trace.active and i - 1 == trace.units:
                trace.stop()
                trace.done = trace.units
                traced = {k: v - before[k] for k, v in
                          launch_counts().items()}
            tracing = trace is not None and i <= trace.units
            if time.perf_counter() - t_first >= seconds and not tracing:
                break
        marks.wait(len(marks.marks) - 1)
        self.kept[i - 1] = out
        gaps = marks.intervals_ms()
        window_ms = sum(gaps)
        res = {"attempted": i,
               "metrics": {"ptrans_gflops": float(self.n) ** 2 * i
                           / (window_ms * 1e-3) / 1e9,
                           "ptrans_step_ms_p95": hh.quantile(gaps, 0.95)}}
        if trace is not None:
            res["traced_launches"] = traced
        return res

    def check(self):
        """Free the port's state, then compare each kept C with B + A^T."""
        self.step = None
        gap, failed = 0.0, 0
        for i in sorted(self.kept):
            g = self.ref.c_gap(self.kept.pop(i), self.a, self.bm)
            gap = hh.larger(gap, g)
            failed += not g <= self.limits["c_gap"]
        return {"c_gap": {"value": gap, "limit": self.limits["c_gap"]}}, \
            failed

def setup(cell, seed: int, device) -> PtransRun:
    return PtransRun(cell, seed, device)
