"""Single-device blocked LU (paper Fig. 13's per-device sweep).

Port of ``repro/core/hpl_blocked.py:34-64``: a thin wrapper over the
distributed factorization (:mod:`repro_torch.core.hpl`) on a 1 x 1 grid, so
the single-device sweep runs exactly the kernels and iteration structure of
the torus (every broadcast is the identity on 1-rank axes). As in the
reference, the trailing update is a masked full-matrix GEMM every
iteration, about 3x the FLOPs of a shrinking-submatrix loop; GFLOP/s stays
normalized by ``hpl_flops(n)``.
"""
from __future__ import annotations

import torch

from repro_torch.core.hpcc import (BenchResult, device_name, register,
                                   resolve_device, timeit)
from repro_torch.core.hpl import (generate_system, make_factorize,
                                  normalized_residual, solve_from_lu)
from repro_torch.core.models import hpl_flops
from repro_torch.launch.mesh import single_rank_mesh


def lu_blocked(a: torch.Tensor, b: int) -> torch.Tensor:
    """Blocked LU of (n, n) ``a`` with block size ``b``; returns packed
    L\\U as a new tensor on ``a``'s device (``a`` is left as it was)."""
    n = a.shape[0]
    fact = make_factorize(single_rank_mesh(), pg=1, nb=n // b, b=b)
    return fact(a)


@register("hpl_single")
def run_hpl_single(mesh=None, comm=None, *, n: int = 512, b: int = 64,
                   reps: int = 2, validate: bool = True,
                   schedule: str = "auto", device=None) -> BenchResult:
    # single device: no communication — ``schedule`` is accepted so the
    # drivers can pass one flag suite-wide; recorded as "local" in results.
    device = resolve_device(device)
    a, x_true, b_vec = generate_system(n)
    a_dev = torch.from_numpy(a).to(device)
    out, t = timeit(lu_blocked, a_dev, b, reps=reps)

    err = 0.0
    if validate:
        x = solve_from_lu(out.cpu().numpy(), b_vec)
        err = normalized_residual(a, x, b_vec)

    return BenchResult(
        name="hpl_single", metric_name="GFLOP/s", metric=hpl_flops(n) / t / 1e9,
        error=err, times={"best": t},
        details={"n": n, "block": b, "schedule": "local",
                 "device": device_name(device)})
