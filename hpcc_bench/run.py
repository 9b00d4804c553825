"""Run one cell of the benchmark of ``repro_torch`` and print its result.

    python hpcc_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is an entry of ``BENCHMARK.json``;
its configuration, traffic and limits are files under ``hpcc_bench/``
(see ``hpcc_bench/README.md``). The run makes its inputs from ``--seed``,
builds and warms the port's path (set-up), measures for ``--seconds``
(with ``--trace 1`` part of that window under ``torch.profiler``), then
compares what the timed calls returned with the plain reference. The last
lines of standard error give each number compared beside its limit; the
last line of standard output is one JSON object:

    {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
     "checks"}

With ``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics. Exit codes: 0 a result was printed
(``correct`` may be false), 1 no card or too few cards, 2 the cell or the
port cannot be loaded, or on the card a per-layer metric's reader found
nothing to read, 3 the process holds JAX or the JAX package.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

import hpcc_harness as hh  # noqa: E402


def _cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own kernels build under ``build/repro_torch_kernels/``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / "build" / sub)


def _import_port(root: Path):
    """Import ``repro_torch`` from ``root/src``, and from nowhere else."""
    src = root / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    try:
        import repro_torch
    except ImportError as e:
        raise hh.BenchError(f"cannot import repro_torch from {src}: {e}")
    where = Path(repro_torch.__file__).resolve()
    if src.resolve() not in where.parents:
        raise hh.BenchError(f"repro_torch was imported from {where}, not "
                            f"from {src}")
    return repro_torch


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "not read"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, device=None, root=None) -> int:
    """Run a cell. ``device`` (default: the card, which must exist) and
    ``root`` (default: the checkout this file lies in) are for tests, which
    drive the run on the CPU at small sizes."""
    args = parse(argv)
    root = Path(root) if root is not None else BENCH.parent
    _cache_dirs(root)
    try:
        cell = hh.load_cell(root, args.workload)
    except (hh.BenchError, KeyError) as e:
        print(f"hpcc_bench: {e}", file=sys.stderr)
        return 2

    import torch
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            print(f"hpcc_bench: cell {cell.name} needs {cell.chips} CUDA "
                  f"device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 1
        device = "cuda"
    device = torch.device(device)
    try:
        _import_port(root)
        driver = hh.load_module(cell.bench / "drivers" / f"{cell.driver}.py",
                                "driver")
    except hh.BenchError as e:
        print(f"hpcc_bench: {e}", file=sys.stderr)
        return 2
    card = device.type == "cuda"

    # set-up: inputs from the seed, the port's path built and warmed
    run = driver.setup(cell, args.seed, device)
    sync = hh.Sync(device)
    sync()
    if card:
        torch.cuda.reset_peak_memory_stats()
    trace = hh.Trace(int(cell.workload["trace_units"]), sync) \
        if args.trace else None
    setup_s = time.perf_counter() - T_START

    window = run.window(args.seconds, trace)
    sync()
    peak = torch.cuda.max_memory_allocated() if card else 0

    dev = {"platform": "gpu" if card else device.type,
           "kind": torch.cuda.get_device_name(0) if card else device.type,
           "count": cell.chips if card else 1,
           "memory_peak_bytes": int(peak)}
    if args.trace:
        summary = hh.summarize_profile(trace)
        ctx = hh.Context(cell=cell, units=trace.done, trace=summary,
                         launches=window.get("traced_launches", {}),
                         unit_s=window.get("unit_s"),
                         peaks=hh.peaks_for(dev["kind"], cell.bench))
        try:
            metrics = hh.read_metrics(ctx, strict=card)
        except hh.BenchError as e:
            print(f"hpcc_bench: {e}", file=sys.stderr)
            return 2
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
        breakdown = summary.breakdown()
    else:
        values = {**window["metrics"], "setup_s": setup_s}
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] not in values:
                print(f"hpcc_bench: driver {cell.driver} gives no "
                      f"{m['name']}", file=sys.stderr)
                return 2
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        breakdown = None
    if card:
        dev["power"] = _power_limit()

    # correctness: the outputs the window kept, against the plain reference
    checks, failed = run.check()
    correct = all(c["value"] <= c["limit"] for c in checks.values()) \
        and not failed

    found = hh.forbidden_modules()
    if found:
        print(f"hpcc_bench: the process holds {', '.join(found)}",
              file=sys.stderr)
        return 3
    result = {"correct": bool(correct), "attempted": window["attempted"],
              "failed": int(failed), "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
