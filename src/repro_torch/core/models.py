"""Analytical performance models — the HPL part of paper Eqs. 1-6.

Port of ``repro/core/models.py:69-86``: the HPL work count and the paper's
Fig. 15 strong-scaling extrapolation. The communication models wait for the
b_eff and PTRANS slices.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable

import numpy as np


def hpl_flops(n: int) -> float:
    """HPL-AI rule: LU factorization work = 2/3 n^3."""
    return 2.0 * n ** 3 / 3.0


def hpl_strong_scaling_model(perf_per_dev_by_local_n: Dict[int, float],
                             n_global: int, devices: Iterable[int]) -> Dict[int, float]:
    """Paper Fig. 15 extrapolation: aggregate perf = d * perf(single device at
    local size n_global/sqrt(d)), interpolating the measured single-device
    curve."""
    xs = np.array(sorted(perf_per_dev_by_local_n))
    ys = np.array([perf_per_dev_by_local_n[x] for x in xs])
    out = {}
    for d in devices:
        n_local = n_global / math.sqrt(d)
        out[d] = float(d * np.interp(n_local, xs, ys))
    return out
