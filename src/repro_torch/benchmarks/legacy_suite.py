"""Paper Fig. 16 — the legacy HPCC benchmarks on this rank's card. Port of
``benchmarks/legacy_suite.py``; it runs on the card.

    python -m repro_torch.benchmarks.legacy_suite [--quick]

STREAM, RandomAccess (drop-local GUPS), FFT and GEMM; RandomAccess and FFT
at the reference's sizes. Prints a table and writes
``results/bench/torch_legacy_suite.json`` at the root of the checkout.
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import fmt_bw, save_result, table
from repro_torch.core.fft import run_fft
from repro_torch.core.gemm import run_gemm
from repro_torch.core.hpcc import device_name, resolve_device
from repro_torch.core.randomaccess import run_randomaccess
from repro_torch.core.stream import run_stream


def main(quick: bool = False, device=None) -> dict:
    device = resolve_device(device)
    print(f"== legacy suite (paper Fig. 16) on {device_name(device)} ==")
    record = {"device": device_name(device)}
    rows = []

    res = run_stream(elems_per_device=(1 << 22) if quick else (1 << 28),
                     device=device)
    rows.append(["STREAM", "triad B/s", fmt_bw(res.metric),
                 f"{res.error:.2e}"])
    record["stream"] = {"triad_bps": res.metric,
                        "bandwidth": res.details["bandwidth"],
                        "elems": res.details["elems_per_device"],
                        "err": res.error}

    res = run_randomaccess(table_log=16 if quick else 20,
                           updates_per_rng=1024 if quick else 4096,
                           device=device)
    rows.append(["RandomAccess", "GUPS", f"{res.metric:.4f}",
                 f"{res.error:.2e}"])
    record["randomaccess"] = {"gups": res.metric, "err": res.error,
                              "table_log": res.details["table_log"]}

    res = run_fft(log_size=10 if quick else 14,
                  batch_per_device=16 if quick else 64, device=device)
    rows.append(["FFT", "GFLOP/s", f"{res.metric:.2f}", f"{res.error:.2e}"])
    record["fft"] = {"gflops": res.metric, "err": res.error,
                     "log_size": res.details["log_size"]}

    res = run_gemm(m=1024 if quick else 8192, device=device)
    rows.append(["GEMM", "GFLOP/s", f"{res.metric:.2f}", f"{res.error:.2e}"])
    record["gemm"] = {"gflops": res.metric, "m": res.details["m"],
                      "err": res.error}

    print(table(rows, ["benchmark", "metric", "value", "error"]))
    save_result("legacy_suite", record)
    return record


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    main(quick=ap.parse_args().quick)
