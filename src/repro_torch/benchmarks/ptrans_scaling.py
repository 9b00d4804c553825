"""Paper Fig. 12 + Eqs. 5/6 — PTRANS strong and weak scaling over the grid,
both backends, with the block-time model (Eq. 5) on the port's H100
model beside it, whose link figures are the host's loopback. Port of ``benchmarks/ptrans_scaling.py``; it runs on the card.

    python -m repro_torch.benchmarks.ptrans_scaling [--quick] [--schedule NAME] [--nchunks S]

Grids: 1x1 on every rank, and g x g where the world holds exactly g*g
ranks (one process per card under ``torch.distributed``), so one card runs
the 1x1 grid only. Prints a table and writes
``results/bench/torch_ptrans_scaling.json`` at the root of the checkout.
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import save_result, table
from repro_torch.comm.types import H100_80GB
from repro_torch.comm.types import CommunicationType as CT
from repro_torch.core import models
from repro_torch.core.hpcc import device_name, resolve_device
from repro_torch.core.ptrans import run_ptrans
from repro_torch.launch.mesh import make_torus_mesh, single_rank_mesh, world


def main(quick: bool = False, schedule=None, nchunks="auto",
         device=None) -> dict:
    device = resolve_device(device)
    _, size = world()
    grids = [g for g in (1, 2, 3) if g == 1 or g * g == size]
    n_base = 256 if quick else 512
    b = 64
    reps = 2
    print(f"== PTRANS scaling (paper Fig. 12) on {device_name(device)} ==")
    record = {"device": device_name(device)}
    # HOST_STAGED forces `staged`: another explicit schedule would rerun
    # byte-identical host-staged configurations
    comms = ((CT.ICI_DIRECT,) if schedule not in (None, "auto", "staged")
             else (CT.ICI_DIRECT, CT.HOST_STAGED))
    for label, strong in (("strong", True), ("weak", False)):
        rows, base_perf = [], {}
        for ct in comms:
            for g in grids:
                n = n_base if strong else n_base * g
                if n % (g * b):
                    continue
                mesh = single_rank_mesh() if g == 1 else make_torus_mesh(g)
                res = run_ptrans(mesh, ct, n=n, b=b, reps=reps,
                                 schedule=schedule or "auto",
                                 nchunks=nchunks, device=device)
                record[f"{label}/{ct.value}/g{g}"] = {
                    "n": n, "gflops": res.metric, "err": res.error,
                    "time": res.times["best"],
                    "nchunks": res.details["nchunks"],
                    "schedule": res.details["schedule"],
                    "launches": res.details["launches"]}
                if g == grids[0]:
                    base_perf[ct.value] = res.metric
                model_t = models.ptrans_block_time(
                    b, 4, H100_80GB, staged=(ct is CT.HOST_STAGED))
                rows.append([label, ct.value, f"{g}x{g}", n,
                             f"{res.metric:.3f}",
                             f"{res.metric / base_perf[ct.value]:.2f}x",
                             f"{res.error:.2e}", f"{model_t * 1e6:.1f}us"])
        print(table(rows, ["scaling", "backend", "grid", "n", "GFLOP/s",
                           "speedup", "max_err", "model_t/blk(h100)"]))
        print()
    save_result("ptrans_scaling", record)
    return record


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--schedule", default=None)
    ap.add_argument("--nchunks", default="auto")
    args = ap.parse_args()
    main(args.quick, args.schedule, args.nchunks)
