"""Paper Fig. 10 + Eqs. 1/4 — b_eff bandwidth by message size, for both
communication backends, beside the paper's 520N model (Eq. 4). Port of
``benchmarks/beff_bandwidth.py``; it runs on the card.

    python -m repro_torch.benchmarks.beff_bandwidth [--quick] [--schedule NAME]

The ring is every rank of the world (one process per card under
``torch.distributed``). On one card the ring has one rank and no wire: each
exchange is the identity, so the measured column is the host's loop
overhead, not a link rate (``ranks`` in the record says so). Prints a table
and writes ``results/bench/torch_beff_bandwidth.json`` at the root of the
checkout.
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import fmt_bw, save_result, table
from repro_torch.comm.types import CommunicationType as CT
from repro_torch.core import models
from repro_torch.core.beff import run_beff
from repro_torch.core.hpcc import device_name, resolve_device
from repro_torch.launch.mesh import make_ring_mesh


def main(quick: bool = False, schedule=None, device=None) -> dict:
    device = resolve_device(device)
    mesh = make_ring_mesh("x")
    n = mesh.shape["x"]
    max_log = 12 if quick else 16
    reps = 2 if quick else 3

    print(f"== b_eff (paper Fig. 10) over {n} rank(s) on "
          f"{device_name(device)} ==")
    results = {}
    for ct in (CT.ICI_DIRECT, CT.HOST_STAGED):
        res = run_beff(mesh, ct, max_log=max_log, reps=reps, rounds=2,
                       schedule=schedule or "auto", device=device)
        results[ct.value] = res
        rows = [[L, fmt_bw(bw), fmt_bw(models.beff_csn_model_520n(L))]
                for L, bw in sorted(res.details["bandwidth_by_size"].items())]
        print(f"\n-- backend={ct.value}  b_eff={fmt_bw(res.metric)} "
              f"errors={res.error} ranks={res.details['ranks']}")
        print(table(rows, ["msg_B", "measured", "model:CSN(520N Eq.4)"]))
    save_result("beff_bandwidth", {
        "device": device_name(device), "ranks": n,
        **{k: {"b_eff": v.metric,
               "bandwidth_by_size": v.details["bandwidth_by_size"],
               "error": v.error, "schedule": v.details["schedule"]}
           for k, v in results.items()}})
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--schedule", default=None)
    args = ap.parse_args()
    main(args.quick, args.schedule)
