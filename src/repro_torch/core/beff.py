"""b_eff — effective bandwidth benchmark (paper §2.1).

Port of ``repro/core/beff.py``. A ring over all ranks (axis ``x``);
messages of 2^0 .. 2^max_log bytes are exchanged with both ring neighbours
at once, ``rounds`` times back to back, the received buffers becoming the
next round's sends (the paper's internal-channel forwarding). The metric is
Eq. 1's effective bandwidth. The exchange is the engine's
``ring_exchange``: ``direct`` posts both hops together, ``staged`` (forced
by HOST_STAGED) routes every message through an all_gather.

Verification follows the paper: every message is filled with the byte
``log2(size) mod 256`` and checked after the timed run.

On a single rank there is no wire: every exchange is the identity, so the
"bandwidth" measures the host's loop overhead and no link. ``details``
records ``ranks`` so that no reader takes it for a link rate.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.comm.engine import CollectiveEngine
from repro_torch.comm.types import CommunicationType
from repro_torch.core import models
from repro_torch.core.hpcc import (BenchResult, device_name, register,
                                   resolve_device, timeit)
from repro_torch.launch.mesh import single_rank_mesh

AXIS = "x"


def make_step(engine: CollectiveEngine, rounds: int = 1, axis: str = AXIS):
    """``step(fwd, bwd) -> (fwd, bwd)``: ``rounds`` back-to-back
    bidirectional ring exchanges."""
    def step(fwd: torch.Tensor, bwd: torch.Tensor):
        for _ in range(rounds):
            fwd, bwd = engine.ring_exchange(fwd, bwd, axis)
        return fwd, bwd
    return step


@register("b_eff")
def run_beff(mesh=None, comm=CommunicationType.ICI_DIRECT, *,
             max_log: int = 20, reps: int = 3, rounds: int = 4,
             schedule: str = "auto", device=None) -> BenchResult:
    """Measured b_eff over the ranks of ``mesh`` (axis 'x'; None is the
    single-rank ring), with buffers on ``device`` (default: the card)."""
    device = resolve_device(device)
    mesh = mesh or single_rank_mesh((AXIS,))
    n = mesh.shape[AXIS]
    engine = CollectiveEngine.for_mesh(mesh, comm, schedule)
    step = make_step(engine, rounds)
    bw: Dict[int, float] = {}
    times: Dict[str, float] = {}
    error = 0.0
    out_device = None
    for lg in range(max_log + 1):
        L = 2 ** lg
        fill = lg % 256
        fwd = torch.full((L,), fill, dtype=torch.uint8, device=device)
        bwd = torch.full((L,), fill, dtype=torch.uint8, device=device)
        (ofwd, obwd), t = timeit(step, fwd, bwd, reps=reps)
        # bytes on the wire per round: every rank sends L fwd + L bwd
        bw[L] = 2.0 * L * n * rounds / t
        times[f"L={L}"] = t
        ok = bool((ofwd == fill).all() and (obwd == fill).all())
        error += 0.0 if ok else 1.0
        out_device = str(ofwd.device)
    resolved = engine.schedule_for("ring_exchange", nbytes=2 ** max_log,
                                   axis=AXIS)
    return BenchResult(
        name="b_eff", metric_name="effective_bandwidth_B/s",
        metric=models.effective_bandwidth(bw), error=error, times=times,
        details={"bandwidth_by_size": bw, "devices": n, "ranks": n,
                 "comm": engine.comm.value, "schedule": resolved,
                 "schedule_requested": engine.schedule, "rounds": rounds,
                 "device": device_name(device),
                 "buffer_device": out_device})
