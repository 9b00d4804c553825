"""FFT — batched 1-D FFTs, local (legacy) and distributed (engine-routed).

Port of ``repro/core/fft.py``. The transform is ``torch.fft.fft`` (cuFFT on
the card), the counterpart of the reference's XLA FFT: the reference has no
Pallas kernel here. Metric: 5 N log2 N FLOPs per 1-D FFT.

**Local (legacy reference).** The batch is sharded over the ring axis
``x`` by rows; each rank transforms its signals.

**Distributed (pencil decomposition).** The batch is sharded along the
*signal* axis (each rank holds a ``(B, n/P)`` pencil). An
``all_to_all_tiles`` under ``fft.transpose`` (tile axes 0 -> 1) gives each
rank ``B/P`` complete signals, the local transform is ``torch.fft.fft``
over them, and the inverse exchange (1 -> 0) restores the pencils. So the
output is bitwise ``torch.fft.fft`` at the per-rank block shape
``(B/P, n)`` on every schedule and chunking; ``nchunks > 1`` strips the
pencil axis (axis 2), which rides through both exchanges untouched.

The reference draws its signals from ``jax.random``, which the port cannot
reproduce; :func:`make_signals` draws them from an explicit
``torch.Generator``. ``error`` keeps the reference's meaning: the whole
output's max |Δ| over the max |ref| of a float64 transform (on the card
``torch.fft.fft`` in complex128).
"""
from __future__ import annotations

import math

import torch

from repro_torch.comm.callsites import FFT_TRANSPOSE
from repro_torch.comm.engine import CollectiveEngine
from repro_torch.comm.types import CommunicationType
from repro_torch.core.hpcc import (BenchResult, axis_values, device_name,
                                   register, resolve_device, timeit)
from repro_torch.launch.mesh import single_rank_mesh

CALLSITE = FFT_TRANSPOSE  # tuning-table tag for both pencil exchanges
AXIS = "x"


def make_signals(batch: int, n: int, *, device=None) -> torch.Tensor:
    """``(batch, n)`` complex64 with standard normal real and imaginary
    parts, from a generator seeded with 0 on ``device`` (the reference
    fixes its key the same way)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    re = torch.randn(batch, n, generator=gen, device=device)
    im = torch.randn(batch, n, generator=gen, device=device)
    return torch.complex(re, im)


def fft_local(x: torch.Tensor) -> torch.Tensor:
    """The local transform of every row."""
    return torch.fft.fft(x, dim=-1)


def _exchange(engine, b, tile_split: int, tile_concat: int, nchunks: int):
    if nchunks <= 1:
        return engine.all_to_all_tiles(b, AXIS, split_axis=tile_split,
                                       concat_axis=tile_concat,
                                       callsite=CALLSITE)
    return engine.pipelined("all_to_all_tiles", b, AXIS, nchunks=nchunks,
                            split_axis=2, concat_axis=2,
                            tile_split_axis=tile_split,
                            tile_concat_axis=tile_concat, callsite=CALLSITE)


def make_dist_step(engine: CollectiveEngine, *, nchunks: int = 1):
    """``step(x_loc) -> out_loc`` on this rank's ``(B, n/P)`` pencil; both
    global transposes ride ``fft.transpose``."""
    def step(x_loc: torch.Tensor) -> torch.Tensor:
        buf = x_loc[:, None, :]                              # (B, 1, ns)
        gathered = _exchange(engine, buf, 0, 1, nchunks)     # (B/P, P, ns)
        spec = fft_local(gathered.reshape(gathered.shape[0], -1))
        out = _exchange(engine, spec.reshape(gathered.shape), 1, 0, nchunks)
        return out[:, 0, :]                                  # (B, ns)
    return step


def _error(out: torch.Tensor, x: torch.Tensor, cols: slice, ax) -> float:
    """Max |out - ref| over max |ref| across the axis, ``ref`` the
    complex128 transform of the rows ``x``, this rank's columns ``cols``."""
    ref = torch.fft.fft(x.to(torch.complex128), dim=-1)[:, cols]
    diff = float((out.to(torch.complex128) - ref).abs().max())
    scale = float(ref.abs().max())
    return max(axis_values(diff, ax)) / max(axis_values(scale, ax))


@register("fft")
def run_fft(mesh=None, comm=CommunicationType.ICI_DIRECT, *,
            log_size: int = 12, batch_per_device: int = 64, reps: int = 3,
            device=None) -> BenchResult:
    """Batched local FFTs over the ranks of ``mesh`` (axis 'x'; None: one
    rank), each holding ``batch_per_device`` rows of the same global batch,
    on ``device`` (default: the card). ``error`` covers the whole output."""
    device = resolve_device(device)
    mesh = mesh or single_rank_mesh((AXIS,))
    ax = mesh.axis(AXIS)
    n = 1 << log_size
    batch = batch_per_device * ax.size
    x = make_signals(batch, n, device=device)
    if ax.size > 1:
        x = x[ax.index * batch_per_device:
              (ax.index + 1) * batch_per_device].clone()

    out, t = timeit(fft_local, x, reps=reps)
    t = max(axis_values(t, ax))
    err = _error(out, x, slice(None), ax)

    flops = 5.0 * n * math.log2(n) * batch
    return BenchResult(
        name="fft", metric_name="GFLOP/s", metric=flops / t / 1e9, error=err,
        times={"best": t},
        details={"log_size": log_size, "batch": batch, "devices": ax.size,
                 "device": device_name(device)})


@register("fft_dist")
def run_fft_dist(mesh=None, comm=CommunicationType.ICI_DIRECT, *,
                 log_size: int = 12, batch_per_device: int = 64,
                 reps: int = 3, schedule: str = "auto", nchunks="auto",
                 device=None) -> BenchResult:
    """Pencil-decomposed FFT over the ring 'x' of ``mesh`` (None: one
    rank). The signal axis is sharded; the ``fft.transpose`` exchanges
    localize full signals, so the output is bitwise ``torch.fft.fft`` at the
    per-rank block shape on every schedule and chunking. ``error`` is the
    whole output's relative error against the float64 transform."""
    mesh = mesh or single_rank_mesh((AXIS,))
    ax = mesh.axis(AXIS)
    n = 1 << log_size
    batch = batch_per_device * ax.size
    if n % ax.size:
        raise ValueError(
            f"signal length 2**{log_size} = {n} not divisible by "
            f"{ax.size} devices (pencil decomposition)")
    device = resolve_device(device)
    engine = CollectiveEngine.for_mesh(mesh, comm, schedule)

    ns = n // ax.size
    cols = slice(ax.index * ns, (ax.index + 1) * ns)
    x = make_signals(batch, n, device=device)
    x_loc = x[:, cols].contiguous()

    payload = batch * ns * 8  # per-rank (B, 1, ns) complex64
    nchunks_requested = nchunks
    if nchunks == "auto":
        nchunks = engine.pipeline_chunks("all_to_all_tiles", nbytes=payload,
                                         axis=AXIS, callsite=CALLSITE)
    nchunks = max(int(nchunks), 1)

    out, t = timeit(make_dist_step(engine, nchunks=nchunks), x_loc,
                    reps=reps)
    t = max(axis_values(t, ax))
    err = _error(out, x, cols, ax)

    flops = 5.0 * n * math.log2(n) * batch
    return BenchResult(
        name="fft_dist", metric_name="GFLOP/s", metric=flops / t / 1e9,
        error=err, times={"best": t},
        details={"log_size": log_size, "batch": batch, "devices": ax.size,
                 "comm": engine.comm.value,
                 "schedule": engine.schedule_for(
                     "all_to_all_tiles", nbytes=payload, axis=AXIS,
                     callsite=CALLSITE),
                 "schedule_requested": engine.schedule,
                 "nchunks": nchunks, "nchunks_requested": nchunks_requested,
                 "exchange_bytes": payload, "device": device_name(device)})
