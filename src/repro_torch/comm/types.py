"""Communication types and hardware model constants.

Port of ``repro/comm/types.py``. ``CommunicationType`` is the paper's Fig. 1
selector between the direct device-to-device path and the host-staged path.
``HardwareModel`` carries the constants of the analytical models (paper
Eqs. 2-6) and of the cost model (:mod:`repro_torch.comm.autotune`): the
paper's own BittWare 520N, and :data:`H100_80GB`, the port's card, filled
from its own measurements.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass


class CommunicationType(enum.Enum):
    # Direct device-to-device over the circuit-switched interconnect
    # (paper: Intel External Channels / CSN).
    ICI_DIRECT = "ici_direct"
    # Staged through the hosts (paper: PCIe + MPI over the inter-CPU network).
    HOST_STAGED = "host_staged"


def comm_type(name) -> CommunicationType:
    if isinstance(name, CommunicationType):
        return name
    return CommunicationType(name)


@dataclass(frozen=True)
class HardwareModel:
    name: str
    peak_flops: float          # peak FLOP/s per device
    hbm_bw: float              # device-memory bytes/s per device
    ici_link_bw: float         # bytes/s per direct link (per direction)
    ici_links: int             # direct links per device
    ici_latency: float         # seconds per hop
    pcie_bw: float             # bytes/s device<->host
    dcn_bw: float              # bytes/s per host over the host network
    mpi_latency: float         # host-network small-message latency (s)
    vmem_bytes: int = 0        # per-core fast memory
    hbm_bytes: int = 0


# The paper's evaluation hardware (Fig. 10, Eq. 4).
BITTWARE_520N = HardwareModel(
    name="bittware_520n",
    peak_flops=8.6e12,         # fp32 DSP peak-ish (not used by models)
    hbm_bw=76.8e9,             # 4x DDR4 banks, 19.2 GB/s each
    ici_link_bw=5e9,           # 40 Gbit/s serial channel
    ici_links=4,
    ici_latency=520e-9,        # Table 2: c_l
    pcie_bw=7.88e9,            # PCIe 3.0 x8
    dcn_bw=12.5e9,             # Omni-Path 100 Gbit/s
    mpi_latency=1.5e-6,
)

# The port's card: an NVIDIA H100 80GB HBM3 at a 700 W power limit. Every
# figure is one run of ``python -m repro_torch.benchmarks.hw_model`` on it
# (PERF.md cites the run), none from a datasheet. On one card every path
# between two ranks is this host's gloo loopback between processes sharing
# the card, so the link figures (ici_*, mpi_latency, dcn_bw) are loopback
# figures, not NVLink or network figures: the direct and the staged routes
# ride the same transport.
H100_80GB = HardwareModel(
    name="h100_80gb",
    peak_flops=34.49e12,       # fp32, HPL's trailing update (gemm_update)
    hbm_bw=3.033e12,           # STREAM copy, 2^28 fp32
    ici_link_bw=1.722e9,       # loopback: 8 B / 64 MiB ping-pong, beta
    ici_links=1,               # one loopback path per process
    ici_latency=259.1e-6,      # loopback: one-way time of 8 B
    pcie_bw=49.31e9,           # pinned 256 MiB, slower of H2D and D2H
    dcn_bw=1.722e9,            # the same loopback
    mpi_latency=259.1e-6,      # the same loopback
    vmem_bytes=233472,         # shared memory of one SM
    hbm_bytes=85017493504,     # torch.cuda.get_device_properties
)

# External-channel IP parameters of the 520N (paper Table 2) for Eq. 3/4.
CHANNEL_FREQ_520N = 156.25e6   # c_f
CHANNEL_WIDTH_520N = 32        # c_w bytes
CHANNELS_520N = 4              # c_n
