"""HPCC suite registry — the paper's Fig. 1 host architecture.

Port of ``repro/core/hpcc.py``. Every benchmark registers a ``run_*`` entry
point that returns a :class:`BenchResult`. :func:`resolve_device` is the
port's one rule for where an entry point runs: on ``cuda`` unless the caller
asks for another device, and never quietly on the CPU.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict

import torch
import torch.distributed as dist


@dataclass
class BenchResult:
    name: str
    metric_name: str
    metric: float
    error: float = 0.0
    times: Dict[str, float] = field(default_factory=dict)
    details: Dict[str, object] = field(default_factory=dict)

    def row(self) -> str:
        return (f"{self.name},{self.metric_name},{self.metric:.6g},"
                f"err={self.error:.3g}")


_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_benchmark(name: str) -> Callable:
    return _REGISTRY[name]


def list_benchmarks():
    return sorted(_REGISTRY)


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the card, and
    raises when there is none rather than running on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


def device_name(device: torch.device) -> str:
    """What a result records as the device it ran on."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def axis_values(value, ax) -> list:
    """``value`` (a picklable host value) of every rank along the mesh axis
    ``ax``, in axis-index order: a collective, every rank of the axis calls
    it. How a multi-rank result takes the slowest rank's time and the whole
    output's error."""
    if ax.size == 1:
        return [value]
    out = [None] * ax.size
    dist.all_gather_object(out, value, group=ax.group)
    return out


def _sync():
    # the reference's block_until_ready: wait for the card's queued work
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn, *args, reps: int = 3, warmup: int = 1, **kw) -> tuple:
    """Best-of-reps wall time (paper: slowest rank per rep via barrier, best
    rep for the metric; single-process here, so plain best-of)."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
        _sync()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return out, best
