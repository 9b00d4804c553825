"""Readings that set a cell's limits: the port on many seeds, and controls
on a few, at the cell's own size, in one process.

    python hpcc_bench/controls.py --workload <cell> --seeds 1 2 ... [--control-seeds 1 2 3] [--controls NAME ...]

For each seed it makes the cell's inputs as a run does, calls the port's
timed entry point once, and prints one JSON line with every number a run
compares. For each control seed it does the same with each control in the
port's place. The cell's driver (``drivers/<driver>.py``) gives both:
``readings(cell, seed, device, control)`` and the names of its controls,
``CONTROLS`` (all of them unless ``--controls`` names some). A control that
raises is printed as such and gives no reading. The last line gives the
largest reading of the port and the smallest of each control, per number.
A benchmark run never runs this; it needs the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

import hpcc_harness as hh  # noqa: E402


def main(argv=None, device="cuda", root=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--controls", nargs="*", default=None)
    args = ap.parse_args(argv)
    cell = hh.load_cell(Path(root) if root else BENCH.parent, args.workload)
    driver = hh.load_module(cell.bench / "drivers" / f"{cell.driver}.py",
                            "driver")
    controls = args.controls if args.controls is not None \
        else list(driver.CONTROLS)
    sides = [(None, args.seeds)] + [(c, args.control_seeds)
                                    for c in controls]
    worst = {}
    for control, seeds in sides:
        side = control or "port"
        for seed in seeds:
            t0 = time.perf_counter()
            line = {"cell": cell.name, "side": side, "seed": seed}
            try:
                got = driver.readings(cell, seed, device, control)
            except Exception as e:  # a control that crashes gives no number
                print(json.dumps({**line, "error": repr(e)[:500]}),
                      flush=True)
                continue
            print(json.dumps({**line, **got,
                              "s": time.perf_counter() - t0}), flush=True)
            keep = max if control is None else min
            for k, v in got.items():
                w = worst.setdefault(side, {})
                w[k] = keep(w.get(k, v), v)
    summary = {"cell": cell.name, "port_max": worst.get("port", {}),
               "control_min": {c: worst[c] for c in controls if c in worst},
               "limits": cell.limits}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
