"""HPL's timed loop: back-to-back solves of one system on the port's 1x1
grid.

The entry point is ``repro_torch.core.hpl.make_factorize``'s ``fact`` on
``single_rank_mesh()``, with its engine's cost model given explicitly (the
analytic model on the port's H100 figures, so no tuning table is read).
Set-up makes A on the device from the seed by the HPL-AI rule
(``reference/hpl_ref.py``), builds ``fact`` and runs one warm solve. The
window then calls ``fact(A)`` back to back, each call timed on the host
from the call to a synchronize after it, until ``seconds`` have passed;
the traced units are consecutive solves from the window's second on, and
the median time of the others is what ``hpl_mfu`` reads.

It keeps two of the LU factors the window returned: the solve whose index
the seed draws from the first three, and the last. ``check`` holds both
against the plain reference (:func:`numbers`): the float64 LU of the same A
(``lu_gap``), the float32 LU by the configuration's blocked algorithm
(``update_gap``, which sees the precision of the trailing updates), and
the scaled residual of the solve with the kept factors (``residual``).

:func:`readings` gives the same numbers for one seed of the port or of a
control in its place (``CONTROLS``), for ``controls.py``.
"""
from __future__ import annotations

import contextlib
import random
import statistics
import time

import hpcc_harness as hh


def hpl_flops(n: int) -> float:
    """HPL's operation count of one solve, 2/3 n^3."""
    return 2.0 * n ** 3 / 3.0


def program(cell):
    """The port's timed entry point for ``cell``: ``fact(A) -> LU``."""
    from repro_torch.comm.autotune import CostModel
    from repro_torch.comm.engine import CollectiveEngine
    from repro_torch.comm.types import H100_80GB
    from repro_torch.core.hpl import make_factorize
    from repro_torch.launch.mesh import single_rank_mesh

    p = cell.params
    n, b = int(p["n"]), int(p["b"])
    if n % b or int(p.get("pg", 1)) != 1:
        raise hh.BenchError(f"n={n}, b={b}, pg={p.get('pg')}: this loop "
                            "runs n = k b on a 1x1 grid")
    mesh = single_rank_mesh()
    engine = CollectiveEngine.for_mesh(mesh,
                                       cost_model=CostModel(hw=H100_80GB))
    return make_factorize(mesh, pg=1, nb=n // b, b=b,
                          lookahead=int(p["lookahead"]), engine=engine)


# controls put in the port's place: the float32 LU with every matrix
# multiply in TF32; the blocked float32 LU with the trailing updates' operands
# in TF32 or in bfloat16; the port with its bf16 gemm_update route (C, A
# and B cast to bfloat16 for each update)
CONTROLS = ("tf32", "update.tf32", "update.bf16", "bf16_route")


def references(cell, a):
    """The plain references of ``a``'s factors: float64 (recursive) and
    float32 by the configuration's blocked algorithm."""
    ref = hh.reference("hpl_ref", cell.bench)
    return ref.lu_nopivot(a), ref.lu_blocked32(a, int(cell.params["b"]))


def numbers(cell, a, lu, refs) -> dict:
    """Every number a run compares, for the packed factors ``lu`` of
    ``a``."""
    ref = hh.reference("hpl_ref", cell.bench)
    lu64, lu32 = refs
    return {"lu_gap": ref.lu_gap(lu, lu64),
            "update_gap": ref.update_gap(lu, lu32, a),
            "residual": ref.scaled_residual(a, lu)}


@contextlib.contextmanager
def _bf16_route():
    """The port's HPL with each trailing update on its bf16 gemm_update
    route: C, A and B cast to bfloat16, the result cast back into C."""
    import repro_torch.core.hpl as hpl
    from repro_torch.kernels.ops import gemm_update

    def update(c, a, b, *, alpha=-1.0):
        return c.copy_(gemm_update(c.bfloat16(), a.bfloat16(), b.bfloat16(),
                                   alpha=alpha))
    was = hpl.gemm_update
    hpl.gemm_update = update
    try:
        yield
    finally:
        hpl.gemm_update = was


def readings(cell, seed: int, device, control=None) -> dict:
    """The numbers a run compares, for one solve of the seed's A by the
    port's entry point, or by the control ``control`` in its place."""
    import torch
    ref = hh.reference("hpl_ref", cell.bench)
    a = ref.make_matrix(int(cell.params["n"]), seed, device)
    if control == "tf32":
        lu = ref.lu_nopivot(a, dtype=torch.float32, tf32=True)
    elif control in ("update.tf32", "update.bf16"):
        lu = ref.lu_blocked32(a, int(cell.params["b"]),
                              operands=control.split(".")[1])
    elif control == "bf16_route":
        with _bf16_route():
            lu = program(cell)(a)
    elif control is None:
        lu = program(cell)(a)
    else:
        raise hh.BenchError(f"no HPL control {control!r}; "
                            f"there are {CONTROLS}")
    return numbers(cell, a, lu, references(cell, a))


class HplRun:
    def __init__(self, cell, seed: int, device):
        import torch

        self.cell = cell
        self.fact = program(cell)
        self.n = int(cell.params["n"])
        self.ref = hh.reference("hpl_ref", cell.bench)
        self.limits = cell.limits
        self.sync = hh.Sync(device)
        self.a = self.ref.make_matrix(self.n, seed, device)
        self.keep_at = random.Random(seed).randrange(3)
        self.kept = {}
        # the window holds A, a kept LU, the previous and the new output:
        # two more blocks of A's size in the allocator's pool than one solve
        # leaves, so that no solve of the window waits on cudaMalloc
        spare = [torch.empty_like(self.a) for _ in range(2)]
        del spare
        out = self.fact(self.a)  # warm: kernels built and loaded
        self.sync()
        del out

    def window(self, seconds: float, trace=None) -> dict:
        from repro_torch.kernels.ops import launch_counts
        times, out, i = [], None, 0
        traced = {}
        t_first = t_end = time.perf_counter()
        while True:
            if trace is not None and i == 1:
                before = launch_counts()
                trace.start()
            t0 = time.perf_counter()
            out = self.fact(self.a)
            self.sync()
            t_end = time.perf_counter()
            times.append(t_end - t0)
            if i == self.keep_at:
                self.kept[i] = out
            if trace is not None and trace.active and i == trace.units:
                trace.stop()
                trace.done = trace.units
                traced = {k: v - before[k]
                          for k, v in launch_counts().items()}
            i += 1
            tracing = trace is not None and i <= trace.units
            if t_end - t_first >= seconds and not tracing:
                break
        self.kept[i - 1] = out
        res = {"attempted": i,
               "metrics": {"hpl_gflops": hpl_flops(self.n) * i
                           / (t_end - t_first) / 1e9}}
        if trace is not None:
            untraced = times[:1] + times[trace.units + 1:]
            res["traced_launches"] = traced
            res["unit_s"] = statistics.median(untraced)
        return res

    def check(self):
        """Free the port's state, then hold each kept LU against the
        reference (:func:`numbers`)."""
        self.fact = None
        refs = references(self.cell, self.a)
        worst = {}
        failed = 0
        for i in sorted(self.kept):
            got = numbers(self.cell, self.a, self.kept.pop(i), refs)
            failed += not all(v <= self.limits[k] for k, v in got.items())
            for k, v in got.items():
                worst[k] = hh.larger(worst.get(k, v), v)
        return ({k: {"value": v, "limit": self.limits[k]}
                 for k, v in worst.items()}, failed)


def setup(cell, seed: int, device) -> HplRun:
    return HplRun(cell, seed, device)
