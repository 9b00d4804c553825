"""Paper Fig. 13 — HPL performance vs matrix size on one device, two block
sizes. Port of ``benchmarks/hpl_matrix_sweep.py:18-37``; it runs on the card.

The reference's second section, HPL on a 2x2 torus under each backend,
needs four cards (ROADMAP, "Needs several cards").

    python -m repro_torch.benchmarks.hpl_matrix_sweep [--quick]

prints a table and writes ``results/bench/torch_hpl_matrix_sweep.json`` at
the root of the checkout.
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import save_result
from repro_torch.core.hpcc import device_name, resolve_device
from repro_torch.core.hpl_blocked import run_hpl_single


def main(quick: bool = False, device=None) -> dict:
    device = resolve_device(device)
    sizes = [1024, 2048, 4096] if quick else [1024, 2048, 4096, 8192, 16384]
    blocks = [32, 64]

    print(f"== HPL matrix-size sweep, single device ({device_name(device)}) ==")
    print(f"{'n':>6} {'block':>5} {'GFLOP/s':>10} {'resid':>9} {'time':>10}")
    record = {"device": device_name(device), "single": {},
              "single_curve_b64": {}}
    for b in blocks:
        for n in sizes:
            res = run_hpl_single(n=n, b=b, reps=2, device=device)
            print(f"{n:>6} {b:>5} {res.metric:>10.1f} {res.error:>9.2e} "
                  f"{res.times['best'] * 1e3:>8.1f}ms")
            record["single"][f"n{n}_b{b}"] = {
                "gflops": res.metric, "err": res.error,
                "seconds": res.times["best"]}
            if b == 64:
                record["single_curve_b64"][n] = res.metric
    save_result("hpl_matrix_sweep", record)
    return record


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    main(quick=ap.parse_args().quick)
