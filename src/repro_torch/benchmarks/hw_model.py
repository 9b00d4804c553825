"""Measure the constants of the port's H100 hardware model on the card.

    python -m repro_torch.benchmarks.hw_model

prints one JSON object and writes ``results/bench/torch_hw_model.json`` at
the root of the checkout. ``comm/types.py::H100_80GB`` holds the figures of
one such run; this script is how they were taken and how to take them
again.

Device constants, in this process on the card (CUDA events, warm):

- ``peak_flops``: the rate of HPL's trailing update, ``gemm_update`` with C
  16384², A 16384 x 64 and B 64 x 16384 in fp32, 2·m²·b operations over
  its time. It is the rate :func:`repro_torch.comm.autotune
  .choose_hpl_depth` divides the update's operations by;
- ``hbm_bw``: STREAM copy of 2^28 fp32 (2·2^30 bytes) over its time;
- ``hbm_bytes`` and ``vmem_bytes``: ``torch.cuda.get_device_properties``:
  the card's memory and the shared memory of one SM;
- ``pcie_bw``: a pinned 256 MiB host buffer copied to the card and back,
  the slower direction.

Link constants, on four gloo processes sharing the card
(:func:`~repro_torch.launch.mesh.spawn_mesh`): ranks 0 and 1 ping-pong a
small (8 B) and a large (64 MiB) host tensor while the others wait. Half a
round trip gives the one-way time t(S) of each, and the two points fit
t(S) = alpha + S / beta:

- ``ici_latency`` = ``mpi_latency`` = alpha;
- ``ici_link_bw`` = ``dcn_bw`` = beta.

On one card every path between two ranks is this host's loopback, so these
are loopback figures, not NVLink or network figures: the direct and the
staged routes of the cost model ride the same transport.
"""
from __future__ import annotations

import json
import time

import torch
import torch.distributed as dist

from repro_torch.benchmarks.common import save_result
from repro_torch.launch.mesh import spawn_mesh

N_GEMM, B_GEMM = 16384, 64
STREAM_ELEMS = 1 << 28
PINNED_BYTES = 256 << 20
SMALL_BYTES, LARGE_BYTES = 8, 64 << 20
PING_ITERS = {SMALL_BYTES: 500, LARGE_BYTES: 10}
RANKS = 4  # as many as share the card in the allreduce and a2a paths


def _event_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after two warm
    ones."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_constants() -> dict:
    """The card's constants, measured in this process."""
    from repro_torch.kernels import ops

    props = torch.cuda.get_device_properties(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    c = torch.randn(N_GEMM, N_GEMM, device="cuda", generator=gen)
    a = torch.randn(N_GEMM, B_GEMM, device="cuda", generator=gen)
    b = torch.randn(B_GEMM, N_GEMM, device="cuda", generator=gen)
    gemm_ms = _event_ms(lambda: ops.gemm_update(c, a, b, alpha=-1e-3), 20)
    del c, a, b
    x = torch.randn(STREAM_ELEMS, device="cuda", generator=gen)
    copy_ms = _event_ms(lambda: ops.stream_copy(x), 20)
    del x
    torch.cuda.empty_cache()
    host = torch.empty(PINNED_BYTES, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(PINNED_BYTES, dtype=torch.uint8, device="cuda")
    h2d_ms = _event_ms(lambda: card.copy_(host, non_blocking=True), 10)
    d2h_ms = _event_ms(lambda: host.copy_(card, non_blocking=True), 10)
    return {
        "peak_flops": 2.0 * N_GEMM * N_GEMM * B_GEMM / (gemm_ms * 1e-3),
        "hbm_bw": 2.0 * STREAM_ELEMS * 4 / (copy_ms * 1e-3),
        "pcie_bw": PINNED_BYTES / (max(h2d_ms, d2h_ms) * 1e-3),
        "hbm_bytes": int(props.total_memory),
        "vmem_bytes": int(props.shared_memory_per_multiprocessor),
        "gemm_update_ms": gemm_ms, "stream_copy_ms": copy_ms,
        "h2d_ms": h2d_ms, "d2h_ms": d2h_ms,
    }


def ping_pong_rank(mesh) -> dict:
    """Runs on every rank of a ring: ranks 0 and 1 bounce a host tensor of
    each size; rank 0 returns the one-way seconds of each."""
    rank = mesh.rank
    out = {}
    for nbytes, iters in PING_ITERS.items():
        buf = torch.zeros(nbytes, dtype=torch.uint8)
        dist.barrier()
        if rank in (0, 1):
            peer = 1 - rank
            for i in range(iters + 2):  # two warm round trips
                if i == 2:
                    t0 = time.perf_counter()
                if rank == 0:
                    dist.send(buf, peer)
                    dist.recv(buf, peer)
                else:
                    dist.recv(buf, peer)
                    dist.send(buf, peer)
            out[nbytes] = (time.perf_counter() - t0) / iters / 2
        dist.barrier()
    return out


def link_constants(timeout: float = 120.0) -> dict:
    """The loopback's alpha and beta, from four gloo processes."""
    t = spawn_mesh(RANKS, ping_pong_rank, axes=("x",), timeout=timeout)[0]
    alpha = t[SMALL_BYTES]
    beta = (LARGE_BYTES - SMALL_BYTES) / (t[LARGE_BYTES] - t[SMALL_BYTES])
    return {"ici_latency": alpha, "mpi_latency": alpha,
            "ici_link_bw": beta, "dcn_bw": beta,
            "one_way_s": {str(k): v for k, v in t.items()}, "ranks": RANKS}


def main() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the hardware "
                           "model's constants are the card's")
    record = {"device": torch.cuda.get_device_name(0),
              "device_constants": device_constants(),
              "link_constants": link_constants(),
              "transport": "gloo loopback between processes sharing the "
                           "card; not NVLink, not a network"}
    print(json.dumps(record))
    save_result("hw_model", record)
    return record


if __name__ == "__main__":
    main()
