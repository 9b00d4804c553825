"""Where HPL's time goes on the card: one factorization under torch.profiler.

    PYTHONPATH=src python -m repro_torch.benchmarks.hpl_profile [--n 16384] [--b 64] [--lookahead 0]

Runs one warm factorization on the 1x1 grid and prints one JSON line: its
wall time (host clock, ending in a synchronize), the device time summed by
kernel (and copy) name, and the device's busy share of the wall time. The
work runs on one stream, so device activities do not overlap and their sum
over the wall time is the busy share. The profiler adds host cost to every
launch, so the wall time here is longer than ``run_hpl``'s.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.hpcc import device_name, resolve_device
from repro_torch.core.hpl import generate_system, make_factorize
from repro_torch.launch.mesh import single_rank_mesh


def main(n: int = 16384, b: int = 64, lookahead: int = 0) -> dict:
    device = resolve_device(None)
    a = torch.from_numpy(generate_system(n)[0]).to(device)
    fact = make_factorize(single_rank_mesh(), pg=1, nb=n // b, b=b,
                          lookahead=lookahead)
    fact(a)  # warm: kernels built and loaded, allocator primed
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fact(a)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total:
            by_name[evt.key] = (evt.self_device_time_total / 1e3, evt.count)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    record = {"n": n, "b": b, "lookahead": lookahead,
              "device": device_name(device), "wall_ms": wall * 1e3,
              "device_busy_ms": busy_ms,
              "busy_share": busy_ms / (wall * 1e3),
              "by_kernel": [{"name": k[:120], "ms": ms, "count": cnt}
                            for k, (ms, cnt) in top[:12]]}
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--b", type=int, default=64)
    ap.add_argument("--lookahead", type=int, default=0)
    args = ap.parse_args()
    main(args.n, args.b, args.lookahead)
