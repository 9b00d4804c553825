"""Paper Figs. 14/15 — HPL scaling and the single-device extrapolation
model (the paper's Fig. 15 coloured lines), the section one card runs.

Port of ``benchmarks/hpl_scaling.py``: its 1x1 rows and its Fig. 15
extrapolation; it runs on the card.

    python -m repro_torch.benchmarks.hpl_scaling [--quick] [--schedule NAME]
        [--device cuda|cpu]

Each backend (ICI_DIRECT, HOST_STAGED) runs the 1x1 grid eager, validated,
and with ``lookahead="auto"``, the cost model's depth
(:func:`repro_torch.comm.autotune.choose_hpl_depth`, with the broadcasts
priced on what the backend runs); the lookahead row reports the depth
that ran. Lookahead equals eager bit for bit, so its row is not validated
again, as in the reference. On the 1x1 grid every broadcast is the
identity and the two backends run the same work. The extrapolation
interpolates the single-device GFLOP/s curve (``run_hpl_single``) at
n_base / sqrt(d) and scales it by d devices
(``core/models.py::hpl_strong_scaling_model``). Sizes are the card's: the
reference's n = 512 only times the launches on an H100. The 2x2 rows need
four cards (ROADMAP, "Needs several cards").

Prints two tables and writes ``results/bench/torch_hpl_scaling.json`` at
the root of the checkout.
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import save_result, table
from repro_torch.comm.types import CommunicationType as CT
from repro_torch.core.hpcc import device_name, resolve_device
from repro_torch.core.hpl import run_hpl
from repro_torch.core.hpl_blocked import run_hpl_single
from repro_torch.core.models import hpl_strong_scaling_model
from repro_torch.launch.mesh import single_rank_mesh

B = 64
DEVICES = (1, 4, 9, 16, 25)


def main(quick: bool = False, schedule=None, device=None) -> dict:
    device = resolve_device(device)
    n_base = 1024 if quick else 16384
    curve_sizes = (256, 512, 1024) if quick else (2048, 4096, 8192, 16384)
    # HOST_STAGED forces `staged`: another explicit schedule would rerun
    # byte-identical host-staged configurations
    comms = ((CT.ICI_DIRECT,) if schedule not in (None, "auto", "staged")
             else (CT.ICI_DIRECT, CT.HOST_STAGED))

    print(f"== HPL scaling (paper Figs. 14/15), 1x1 grid on "
          f"{device_name(device)} ==")
    record = {"device": device_name(device)}
    rows, base = [], {}
    for label in ("strong", "weak"):
        for ct in comms:
            for lookahead in (False, "auto"):
                eager = lookahead is False
                res = run_hpl(single_rank_mesh(), ct, n=n_base, b=B,
                              schedule=schedule or "auto", reps=1,
                              lookahead=lookahead, validate=eager,
                              device=device)
                key = (label, ct.value)
                base.setdefault(key, res.metric)
                d = res.details["lookahead_depth"]
                rows.append([label, ct.value, "1x1", n_base,
                             "eager" if eager else f"lookahead(d={d}, auto)",
                             f"{res.metric:.3f}",
                             f"{res.metric / base[key]:.2f}x",
                             f"{res.error:.2e}" if eager else "= eager"])
                suffix = "" if eager else "/lookahead"
                record[f"{label}/{ct.value}/g1{suffix}"] = {
                    "n": n_base, "gflops": res.metric,
                    "err": res.error if eager else None,
                    "lookahead": not eager, "lookahead_depth": d,
                    "schedule": res.details["schedule"],
                    "schedule_block": res.details["schedule_block"],
                    "schedule_panel": res.details["schedule_panel"]}
    print(table(rows, ["scaling", "backend", "grid", "n", "mode", "GFLOP/s",
                       "speedup", "resid"]))

    print("\n-- strong-scaling extrapolation from the single-device curve "
          "(paper Fig. 15 model) --")
    curve = {n: run_hpl_single(n=n, b=B, reps=1, validate=False,
                               device=device).metric for n in curve_sizes}
    model = hpl_strong_scaling_model(curve, n_base, DEVICES)
    print(table([[d, f"{p:.3f}"] for d, p in model.items()],
                ["devices", "predicted aggregate GFLOP/s"]))
    record["curve"] = curve
    record["extrapolation"] = model
    save_result("hpl_scaling", record)
    return record


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--schedule", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(args.quick, args.schedule, args.device)
