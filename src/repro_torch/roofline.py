"""Roofline terms of the port: the alpha-beta link terms and the model
half.

Port of ``repro/roofline.py``'s alpha-beta terms (``:453-495``), its
collective wire factor (``_wire_factor``, ``:222-229``), :class:`Roofline`
and :func:`from_stats` (``:497-514``, ``:536-559``) and
:func:`model_flops_for` (``:562-570``).

The reference's HLO half (``:45-452`` apart from ``_wire_factor``:
parsing the optimized XLA program, recovering loop trip counts) and its
``from_compiled`` have no counterpart: PyTorch compiles no whole-step
program. :func:`from_stats` takes the counts of the port's meta-device dry
run instead (:mod:`repro_torch.launch.dryrun`), held in
:class:`DryStats`, which has the fields of the reference's ``HloStats``.

No function takes a default hardware model: the reference defaults to its
TPU constants, which the port does not carry. The compute term prices a
cell at the peak of its compute dtype: fp32 at ``H100_80GB.peak_flops``,
bf16 at :data:`H100_BF16_PEAK_FLOPS`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from repro_torch.comm.types import HardwareModel

# dense bf16 tensor-core peak of the H100 SXM 80GB, NVIDIA's H100 datasheet
# (989 TFLOP/s dense, without sparsity): the flash kernel's bound in PERF.md §6
# and chip_smoke.BF16_TENSOR_FLOPS
H100_BF16_PEAK_FLOPS = 989e12


def peak_flops_for(dtype, hw: HardwareModel) -> float:
    """The compute peak a cell of compute dtype ``dtype`` is priced at:
    the bf16 tensor-core peak for bf16 and fp16, ``hw.peak_flops`` (fp32)
    otherwise."""
    if dtype in (torch.bfloat16, torch.float16, "bfloat16", "float16"):
        return H100_BF16_PEAK_FLOPS
    return hw.peak_flops


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


def _wire_factor(opcode: str, n: int) -> float:
    """Bytes on the wire per operand byte of a collective over ``n``
    ranks: a ring all-reduce 2(n-1)/n, an all-gather, reduce-scatter or
    all-to-all (n-1)/n, anything else (a permute, a broadcast) 1."""
    if n <= 1:
        return 0.0 if not opcode.startswith("collective-permute") else 1.0
    if opcode.startswith("all-reduce"):
        return 2.0 * (n - 1) / n
    if opcode.startswith(("all-gather", "reduce-scatter", "all-to-all")):
        return (n - 1) / n
    return 1.0


@dataclass
class DryStats:
    """One rank's counts of a dry run (the reference's ``HloStats``
    fields): FLOPs, an unfused upper bound on HBM bytes (every aten op's
    inputs and outputs), the collectives' operand bytes by opcode, their
    wire bytes, their count; ``unresolved_loops`` is always 0 (the dry run
    executes every loop)."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    operand_bytes: Dict[str, float] = field(default_factory=dict)
    wire_bytes: float = 0.0
    collective_count: int = 0
    unresolved_loops: int = 0

    @property
    def total_operand_bytes(self) -> float:
        return sum(self.operand_bytes.values())


@dataclass
class Roofline:
    flops: float                 # per-device FLOPs
    hbm_bytes: float             # per-device HBM traffic
    coll_operand_bytes: float
    coll_wire_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float = 0.0
    useful_ratio: float = 0.0    # MODEL_FLOPS / (FLOPs * chips)
    step_s: float = 0.0          # max of the three terms (no-overlap bound)
    details: Dict = field(default_factory=dict)

    def row(self) -> str:
        return (f"compute {self.compute_s:.4g}s | memory {self.memory_s:.4g}s"
                f" | collective {self.collective_s:.4g}s -> {self.dominant}"
                f" (useful {self.useful_ratio:.2%})")


def from_stats(stats, *, chips: int, hw: HardwareModel,
               model_flops: float = 0.0, cost: Optional[dict] = None,
               peak_flops: Optional[float] = None) -> Roofline:
    """The three roofline terms of one rank's ``stats`` (a
    :class:`DryStats`, or anything with its fields), per-device
    convention. ``peak_flops`` overrides ``hw.peak_flops`` for the compute
    term (:func:`peak_flops_for` a bf16 cell)."""
    peak = hw.peak_flops if peak_flops is None else peak_flops
    compute_s = stats.flops / peak
    memory_s = stats.hbm_bytes / hw.hbm_bw
    collective_s = stats.wire_bytes / hw.ici_link_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    useful = model_flops / (stats.flops * chips) if stats.flops else 0.0
    details = {
        "per_op_bytes": stats.operand_bytes,
        "collective_count": stats.collective_count,
        "unresolved_loops": stats.unresolved_loops,
    }
    if cost:
        details["cost_analysis_flops"] = float(cost.get("flops", 0.0))
        details["cost_analysis_bytes"] = float(cost.get("bytes accessed", 0.0))
    return Roofline(
        flops=stats.flops, hbm_bytes=stats.hbm_bytes,
        coll_operand_bytes=stats.total_operand_bytes,
        coll_wire_bytes=stats.wire_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops, useful_ratio=useful,
        step_s=max(terms.values()), details=details)


def model_flops_for(cfg, kind: str, global_batch: int, seq_len: int) -> float:
    """MODEL_FLOPS: 6*N*D (train) / 2*N*D (forward-only), N = active params."""
    n_active = cfg.param_count(active_only=True)
    if kind == "train":
        tokens = global_batch * seq_len
        return 6.0 * n_active * tokens
    if kind == "prefill":
        return 2.0 * n_active * global_batch * seq_len
    return 2.0 * n_active * global_batch
