"""Analytical performance models — paper Eqs. 1-6 with pluggable hardware.

Port of ``repro/core/models.py``: b_eff (Eqs. 1-4), PTRANS (Eqs. 5-6), the
HPL work count and the paper's Fig. 15 strong-scaling extrapolation. The
models that take a :class:`HardwareModel` take it with no default: the
reference defaults to its TPU constants, which the port does not carry.
Callers pass ``H100_80GB`` (the port's card, from its own measurements) or
``BITTWARE_520N`` (the paper's own card).
"""
from __future__ import annotations

import math
from typing import Dict, Iterable

import numpy as np

from repro_torch.comm.types import (CHANNEL_FREQ_520N, CHANNEL_WIDTH_520N,
                                    HardwareModel)


def effective_bandwidth(bw_by_size: Dict[int, float]) -> float:
    """Paper Eq. 1: b_eff = sum_L max_rep b(L, rep) / #sizes. The caller
    passes the per-size best bandwidth."""
    return sum(bw_by_size.values()) / len(bw_by_size)


def beff_host_staged_model(L: int, hw: HardwareModel) -> float:
    """Paper Eq. 2: b_L = 2L / (pcie_write + mpi + pcie_read); sequential."""
    pcie = L / hw.pcie_bw
    mpi = L / hw.dcn_bw + hw.mpi_latency
    return 2 * L / (pcie + mpi + pcie)


def beff_csn_model_520n(L: int, channels_per_pair: int = 2) -> float:
    """Paper Eq. 3/4 with Table 2 constants: one send/recv kernel pair of the
    520N (b_L = 2L / (ceil(L / 64B) * 6.4 ns + 520 ns))."""
    cw = channels_per_pair * CHANNEL_WIDTH_520N  # bytes per cycle
    t = math.ceil(L / cw) / CHANNEL_FREQ_520N + 520e-9
    return 2 * L / t


def beff_ici_model(L: int, hw: HardwareModel) -> float:
    """Eq. 3 for a direct link: the message streamed over one link each
    direction, one hop of latency."""
    t = L / hw.ici_link_bw + hw.ici_latency
    return 2 * L / t


def ptrans_block_time(b: int, elem_bytes: int, hw: HardwareModel,
                      staged: bool = False) -> float:
    """Paper Eq. 5: t = t_comm + 3 * b^2 / (c_w * c_f), the '3x global
    memory traffic' term (Eq. 6) as b^2 * elem_bytes * 3 / hbm_bw."""
    block_bytes = b * b * elem_bytes
    if staged:
        t_comm = 2 * block_bytes / hw.pcie_bw + block_bytes / hw.dcn_bw \
            + hw.mpi_latency
    else:
        t_comm = block_bytes / hw.ici_link_bw + hw.ici_latency
    t_mem = 3 * block_bytes / hw.hbm_bw
    return t_comm + t_mem


def ptrans_required_hbm_bw(net_bw: float) -> float:
    """Paper Eq. 6: global-memory bandwidth must be 3x the network bandwidth
    for PTRANS to stay network-bound."""
    return 3.0 * net_bw


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
