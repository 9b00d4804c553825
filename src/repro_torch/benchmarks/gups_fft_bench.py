"""Distributed GUPS + FFT: the legacy suite's two kernels, engine-routed,
on this rank's card. Port of ``benchmarks/gups_fft_bench.py``.

    python -m repro_torch.benchmarks.gups_fft_bench [--quick]
        [--schedule NAME] [--device cuda|cpu]

RandomAccess runs drop-local and routed (every update forwarded to its
owning rank over ``all_to_all_tiles``, tag ``ra.updates``), FFT per-rank
and pencil-decomposed (both global transposes on ``fft.transpose``), at
the reference's sizes. On one rank every exchange is the identity, so the
routed rows time the path's local work (the routed GUPS row also prints
its split into generate / bucket / exchange / scatter).

Like the reference, the module exits 1 unless both routed sections
resolved a registered ``all_to_all_tiles`` schedule (never the literal
``"auto"``), routed GUPS restores exactly (``err == 0.0``) and the pencil
FFT's error is below 1e-5. Prints a table and writes
``results/bench/torch_gups_fft_bench.json`` at the root of the checkout.
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import save_result, table
from repro_torch.comm.engine import schedules_for
from repro_torch.core.fft import run_fft, run_fft_dist
from repro_torch.core.hpcc import device_name, resolve_device
from repro_torch.core.randomaccess import (run_randomaccess,
                                           run_randomaccess_dist)


def gate(record) -> list:
    """The reference's in-module gate: what fails in ``record``."""
    a2a = schedules_for("all_to_all_tiles")
    bad = []
    for sec in ("randomaccess_routed", "fft_dist"):
        name = record[sec]["schedule"]
        if name == "auto" or name not in a2a:
            bad.append(f"{sec}: unregistered schedule {name!r}")
    if record["randomaccess_routed"]["err"] != 0.0:
        bad.append("randomaccess_routed: inverse restore not exact "
                   f"(err={record['randomaccess_routed']['err']})")
    if not record["fft_dist"]["err"] < 1e-5:
        bad.append(f"fft_dist: err={record['fft_dist']['err']} against the "
                   "float64 transform")
    return bad


def main(quick: bool = False, schedule=None, device=None) -> dict:
    device = resolve_device(device)
    sched = schedule or "auto"
    print(f"== distributed GUPS + FFT on {device_name(device)} "
          f"(schedule={sched}) ==")
    record = {"schedule_requested": sched, "device": device_name(device)}
    rows = []

    ra_kw = dict(table_log=16 if quick else 20,
                 updates_per_rng=1024 if quick else 4096, device=device)
    res = run_randomaccess(**ra_kw)
    rows.append(["RandomAccess local", "GUPS", f"{res.metric:.4f}",
                 "drop-local", f"{res.error:.2e}"])
    record["randomaccess_local"] = {"gups": res.metric, "err": res.error}

    res = run_randomaccess_dist(schedule=sched, **ra_kw)
    rows.append(["RandomAccess routed", "GUPS", f"{res.metric:.4f}",
                 res.details["schedule"], f"{res.error:.2e}"])
    record["randomaccess_routed"] = {
        "gups": res.metric, "err": res.error,
        "schedule": res.details["schedule"],
        "nchunks": res.details["nchunks"],
        "exchange_bytes": res.details["exchange_bytes"],
        "phase_seconds": res.details["phase_seconds"]}

    fft_kw = dict(log_size=10 if quick else 14,
                  batch_per_device=16 if quick else 64, device=device)
    res = run_fft(**fft_kw)
    rows.append(["FFT local", "GFLOP/s", f"{res.metric:.2f}", "per-rank",
                 f"{res.error:.2e}"])
    record["fft_local"] = {"gflops": res.metric, "err": res.error}

    res = run_fft_dist(schedule=sched, **fft_kw)
    rows.append(["FFT pencil", "GFLOP/s", f"{res.metric:.2f}",
                 res.details["schedule"], f"{res.error:.2e}"])
    record["fft_dist"] = {
        "gflops": res.metric, "err": res.error,
        "schedule": res.details["schedule"],
        "nchunks": res.details["nchunks"],
        "exchange_bytes": res.details["exchange_bytes"]}

    print(table(rows, ["benchmark", "metric", "value", "schedule",
                       "error"]))
    print("routed GUPS step by phase (s):",
          record["randomaccess_routed"]["phase_seconds"])
    save_result("gups_fft_bench", record)

    bad = gate(record)
    if bad:
        print("GATE FAILURES:", bad)
        raise SystemExit(1)
    print("[gups_fft ok: resolved schedules registered, restore exact, "
          "fft matches the float64 transform]")
    return record


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--schedule", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(args.quick, args.schedule, args.device)
