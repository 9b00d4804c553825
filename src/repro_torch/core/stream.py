"""STREAM — memory bandwidth benchmark (paper legacy suite, §3.4).

Port of ``repro/core/stream.py``: copy, scale, add and triad over arrays of
``elems_per_device`` fp32 values on this rank's device, through the
hand-written kernels on the card (their plain versions on the CPU). Each
rank measures its own device; the metric is triad bytes over time.

The inputs come from an explicit ``torch.Generator`` seeded with 0.
``a`` and ``b`` are two distinct draws: the reference draws both from one
key (``stream.py:30-32``), so there ``a == b`` and a triad or add with its
operands swapped would pass its check. Here every op is checked against
its plain version on the same inputs, and each must agree bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.comm.types import CommunicationType
from repro_torch.core.hpcc import (BenchResult, device_name, register,
                                   resolve_device, timeit)
from repro_torch.kernels import ops, ref

ALPHA = 3.0
BYTES_PER_ELEM = {"copy": 2, "scale": 2, "add": 3, "triad": 3}  # x 4 bytes


def make_inputs(n: int, device):
    """Two distinct standard-normal fp32 arrays of ``n`` values."""
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(n, generator=gen, device=device)
    b = torch.randn(n, generator=gen, device=device)
    return a, b


@register("stream")
def run_stream(mesh=None, comm=CommunicationType.ICI_DIRECT, *,
               elems_per_device: int = 1 << 20, reps: int = 3,
               device=None) -> BenchResult:
    """STREAM on ``device`` (default: the card). ``mesh`` and ``comm`` are
    accepted for the suite's one signature: nothing is communicated."""
    device = resolve_device(device)
    n = elems_per_device
    a, b = make_inputs(n, device)
    runs = {"copy": (ops.stream_copy, ref.stream_copy, (a,)),
            "scale": (ops.stream_scale, ref.stream_scale, (a, ALPHA)),
            "add": (ops.stream_add, ref.stream_add, (a, b)),
            "triad": (ops.stream_triad, ref.stream_triad, (a, b, ALPHA))}
    times, bw, err = {}, {}, 0.0
    for name, (fn, plain, args) in runs.items():
        out, times[name] = timeit(fn, *args, reps=reps)
        bw[name] = BYTES_PER_ELEM[name] * 4.0 * n / times[name]
        want = plain(*args)
        err = max(err, float((out - want).abs().max()))
        del out, want
    return BenchResult(
        name="stream", metric_name="triad_B/s", metric=bw["triad"], error=err,
        times=times, details={"bandwidth": bw, "devices": 1,
                              "elems_per_device": elems_per_device,
                              "device": device_name(device)})
