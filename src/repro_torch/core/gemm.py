"""GEMM — C = A @ B on one device (paper legacy suite).

Port of ``repro/core/gemm.py``: an (m, m) fp32 product through the
hand-written ``matmul`` kernel on the card (its plain version on the CPU).
The inputs are standard normal / sqrt(m) from an explicit
``torch.Generator``. The error is the largest difference from
``torch.matmul`` with TF32 off (a library call as the test oracle, in full
fp32 as the reference's numpy product is).
"""
from __future__ import annotations

import math

import torch

from repro_torch.comm.types import CommunicationType
from repro_torch.core.hpcc import (BenchResult, device_name, register,
                                   resolve_device, timeit)
from repro_torch.kernels.ops import matmul


def make_inputs(m: int, device):
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(m, m, generator=gen, device=device) / math.sqrt(m)
    b = torch.randn(m, m, generator=gen, device=device) / math.sqrt(m)
    return a, b


def oracle(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul`` in full fp32 (TF32 off for the call)."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


@register("gemm")
def run_gemm(mesh=None, comm=CommunicationType.ICI_DIRECT, *, m: int = 512,
             reps: int = 3, device=None) -> BenchResult:
    """GEMM on ``device`` (default: the card). ``mesh`` and ``comm`` are
    accepted for the suite's one signature: nothing is communicated."""
    device = resolve_device(device)
    a, b = make_inputs(m, device)
    out, t = timeit(matmul, a, b, reps=reps)
    err = float((out - oracle(a, b)).abs().max())
    return BenchResult(
        name="gemm", metric_name="GFLOP/s", metric=2.0 * m ** 3 / t / 1e9,
        error=err, times={"best": t},
        details={"m": m, "devices": 1, "device": device_name(device)})
