"""Alpha-beta link terms of the cost model.

Port of the alpha-beta half of ``repro/roofline.py`` (``:453-495``). The
HLO half of the reference, which parses compiled XLA programs, has no
counterpart yet (ROADMAP A14). Neither function takes a default hardware
model: the reference defaults to its TPU constants, which the port does
not carry.
"""
from __future__ import annotations

from repro_torch.comm.types import HardwareModel


def alpha_beta_time(hops: float, wire_bytes: float, hw: HardwareModel, *,
                    staged: bool = False) -> float:
    """Link-level alpha-beta term: ``hops x per-hop latency + bytes / bw``.

    Schedule selection (:mod:`repro_torch.comm.autotune`) needs the latency
    side, because small-message collectives are hop-count-bound.
    ``staged=True`` prices the host-staged domain (MPI small-message
    latency, PCIe/DCN bandwidth — the paper's Eq. 2 path) instead of the
    direct links.
    """
    if staged:
        return hops * hw.mpi_latency + wire_bytes / min(hw.pcie_bw, hw.dcn_bw)
    return hops * hw.ici_latency + wire_bytes / hw.ici_link_bw


def pipelined_alpha_beta_time(hops: float, wire_bytes: float, nchunks: int,
                              hw: HardwareModel, *,
                              staged: bool = False) -> float:
    """Alpha-beta term for a software-pipelined collective.

    The payload is split into ``nchunks`` chunks that stream through the
    ``hops``-stage pipe, so the transfer takes ``hops + nchunks - 1`` stages
    of one per-chunk hop each::

        T(S) = (H + S - 1) x (alpha + W / (H * S * beta))

    ``S = 1`` reduces exactly to :func:`alpha_beta_time`. More chunks shrink
    the per-stage wire term but add ``S - 1`` stages of fill/drain latency —
    the trade :func:`repro_torch.comm.autotune.best_nchunks` optimizes.
    """
    h = float(hops)
    if h < 1.0:
        # nothing to pipeline (1-rank axis / degenerate segment): keep the
        # S=1 == monolithic contract exact instead of clamping to one hop
        return alpha_beta_time(hops, wire_bytes, hw, staged=staged)
    s = max(int(nchunks), 1)
    alpha = hw.mpi_latency if staged else hw.ici_latency
    beta = min(hw.pcie_bw, hw.dcn_bw) if staged else hw.ici_link_bw
    return (h + s - 1) * (alpha + wire_bytes / (h * s) / beta)
