"""Benchmark driver of the port:
``python -m repro_torch.benchmarks.run [--quick] [--schedule NAME]
[--sweep-schedules] [--device cuda|cpu] [--autotune] [modules...]``.

Port of ``benchmarks/run.py``, every driver. ``--schedule``
selects a registered collective-engine schedule for every driver that
communicates; without it (or with ``--schedule auto``) every engine
resolves per callsite through the cost model
(:mod:`repro_torch.comm.autotune`) and the driver prints the choices.

``--sweep-schedules`` instead runs each selected driver once per schedule
registered for its primary collective op (:data:`SWEEP_OPS`), plus an
``auto`` column showing what the cost model picks, and prints one
comparison table per driver (the paper's Figs. 10-16 with schedules as
columns), saved to ``results/bench/torch_schedule_sweep.json``. The
drivers with a software-pipeline dimension (:data:`PIPELINE_SWEEP`: the
PTRANS chunk count, the HPL lookahead depth) are also swept over S in
:data:`PIPELINE_DEPTHS` under ``schedule="auto"``, in a second table. A
failed driver-schedule pair is listed and the run exits 1.

``--autotune`` times every registered schedule per op on gloo worlds of
four processes (payloads on ``--device``: the card unless ``cpu`` is
given), persists the per-size winners to ``results/tuning_torch.json``
(loaded by every later ``schedule="auto"`` engine on the same backend and
device), and fails if any ``auto`` resolution or table band names an
unregistered schedule. With modules it runs them against the fresh table
in the same invocation; alone it only tunes.

Module arguments accept short aliases: ``hpl`` -> hpl_scaling, ``ptrans``
-> ptrans_scaling, ``beff`` -> beff_bandwidth, ``gups`` / ``fftd`` ->
gups_fft_bench, ``overlap`` -> overlap_bench, ``failover`` ->
failover_bench, ``resilience`` -> resilience_bench, ``lm`` -> lm_step_bench,
``serve`` -> serve_bench.

  beff_bandwidth   Fig. 10/11 + Eqs. 1/2/4
  ptrans_scaling   Fig. 12 + Eqs. 5/6
  hpl_matrix_sweep Fig. 13
  hpl_scaling      Figs. 14/15, the 1x1 rows and the extrapolation
  legacy_suite     Fig. 16
  gups_fft_bench   distributed GUPS + pencil FFT (gated)
  resource_table   Table 7 analogue: the dry run's per-device FLOPs,
                   bytes and wire bytes of b_eff, PTRANS and HPL on the
                   production mesh, and the LM cells of
                   results/dryrun_torch
  overlap_bench    Figs. 5/7 analogue: bucketed gradient reduction on a
                   ring of processes
  failover_bench   a severed ring hop rerouted and repaired on a ring of
                   processes (gated)
  resilience_bench drift detection and in-run retune under a degraded
                   link on a ring of processes, training and serving
                   under a host delay (gated)
  lm_step_bench    train and decode step times per architecture (reduced
                   configs), and the explicit whole-model step on a ring
                   of processes against the one-rank step (gated)
  serve_bench      the explicit paged decode on a ring of processes
                   against the one-rank step, the continuous-batching
                   engine's batch sweep and its two modes (gated)
"""
from __future__ import annotations

import argparse
import importlib
import time
import traceback
from typing import Optional

from repro_torch.benchmarks.common import save_result, table

MODULES = [
    "beff_bandwidth",
    "ptrans_scaling",
    "hpl_matrix_sweep",
    "hpl_scaling",
    "legacy_suite",
    "gups_fft_bench",
    "resource_table",
    "lm_step_bench",
    "overlap_bench",
    "serve_bench",
    "resilience_bench",
    "failover_bench",
]

ALIASES = {"hpl": "hpl_scaling", "ptrans": "ptrans_scaling",
           "beff": "beff_bandwidth", "gups": "gups_fft_bench",
           "fftd": "gups_fft_bench", "overlap": "overlap_bench",
           "failover": "failover_bench", "resilience": "resilience_bench",
           "lm": "lm_step_bench", "serve": "serve_bench"}

# the drivers whose main() takes quick= and schedule=
_SCHEDULED = ("beff_bandwidth", "ptrans_scaling", "hpl_scaling",
              "gups_fft_bench", "resource_table", "failover_bench",
              "resilience_bench", "lm_step_bench", "serve_bench")

# primary collective op per driver: --sweep-schedules runs the driver once
# per schedule registered for that op (None = no communication to sweep)
SWEEP_OPS = {
    "beff_bandwidth": "ring_exchange",
    "ptrans_scaling": "grid_transpose",
    "hpl_matrix_sweep": "bcast",
    "hpl_scaling": "bcast",
    "legacy_suite": None,      # embarrassingly parallel: ignores schedule
    # routed GUPS + pencil FFT both exchange over all_to_all_tiles (the
    # ra.updates / fft.transpose callsites)
    "gups_fft_bench": "all_to_all_tiles",
    "resource_table": None,
    # the explicit-MoE section routes its dispatch/combine exchanges
    # through the engine
    "lm_step_bench": "all_to_all_tiles",
    "overlap_bench": "allreduce",
    # the decode.qkv/decode.out/decode.moe exchanges are all_to_all_tiles
    "serve_bench": "all_to_all_tiles",
    # the adaptive auto path is the subject under test: a fixed-schedule
    # sweep would defeat the retune
    "resilience_bench": None,
    # likewise: the health-masked re-resolution is the subject under test
    "failover_bench": None,
}

# drivers with a software-pipeline dimension: --sweep-schedules also runs
# them once per pipeline depth S (chunk count for PTRANS, lookahead depth
# for HPL; "auto" = the cost-model resolution) under schedule="auto"
PIPELINE_SWEEP = ("ptrans_scaling", "hpl_scaling")
PIPELINE_DEPTHS = (1, 2, 4, "auto")


def _print_resolved(name: str, record) -> None:
    """Surface the cost-model choices: every resolved schedule recorded in
    the driver's result dict (the literal "auto" never appears here)."""
    picks = sorted({str(v["schedule"]) for v in (record or {}).values()
                    if isinstance(v, dict) and "schedule" in v})
    if picks:
        print(f"[{name}: resolved schedule(s): {', '.join(picks)}]")


def _run_module(name: str, quick: bool, schedule: Optional[str], device,
                pipeline=None):
    print("\n" + "=" * 78)
    print(f"### repro_torch.benchmarks.{name}"
          + (f" (schedule={schedule})" if schedule else "")
          + (f" (pipeline={pipeline})" if pipeline is not None else ""))
    print("=" * 78)
    t0 = time.time()
    mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
    kw = {} if pipeline is None else {"pipeline": pipeline}
    if name in _SCHEDULED:
        record = mod.main(quick=quick, schedule=schedule, device=device,
                          **kw)
    elif name == "overlap_bench":
        record = mod.main(device=device,
                          schedules=[schedule] if schedule else None)
    else:
        record = mod.main(quick=quick, device=device)
    if schedule in (None, "auto"):
        _print_resolved(name, record)
    print(f"[{name} done in {time.time() - t0:.1f}s]")
    return record


def _metric_rows(record):
    """(key, gflops-like scalar) pairs from a driver's record, for the
    cross-schedule comparison table."""
    rows = []
    for key, val in (record or {}).items():
        if isinstance(val, dict):
            for field in ("gflops", "gbps", "gups", "bandwidth_gbs", "time"):
                if field in val:
                    rows.append((key, field, float(val[field])))
                    break
    return rows


def _compare(name: str, title: str, runs: dict) -> None:
    """One comparison table: the records' metric rows x the runs."""
    cols = list(runs)
    cells, metric_field = {}, {}
    for col, rec in runs.items():
        for key, field, v in _metric_rows(rec):
            cells.setdefault(key, {})[col] = v
            metric_field[key] = field
    if cells:
        print(f"\n-- {name}: {title} --")
        rows = [[key, metric_field[key]]
                + [f"{cells[key].get(c, float('nan')):.4g}" for c in cols]
                for key in cells]
        print(table(rows, ["config", "metric"] + cols))


def _sweep(modules, quick: bool, device) -> list:
    """Every driver once per registered schedule of its op plus auto, and
    the pipeline drivers once per depth; returns the failed pairs."""
    from repro_torch.comm.engine import schedules_for

    sweep_record, failures = {}, []
    for name in modules:
        op = SWEEP_OPS.get(name)
        # "auto" rides along as its own column: the cost-model pick should
        # sit within noise of the best fixed schedule
        schedules = list(schedules_for(op)) + ["auto"] if op else [None]
        per_schedule = {}
        for s in schedules:
            try:
                per_schedule[s or "default"] = _run_module(name, quick, s,
                                                           device)
            except Exception:  # noqa: BLE001
                failures.append(f"{name}[{s}]")
                print(f"[{name} schedule={s} FAILED]\n"
                      f"{traceback.format_exc()[-3000:]}")
        sweep_record[name] = per_schedule
        _compare(name, f"schedule comparison ({op or 'no collective op'})",
                 per_schedule)
        if name in PIPELINE_SWEEP:
            per_pipe = {}
            for s in PIPELINE_DEPTHS:
                try:
                    per_pipe[f"S={s}"] = _run_module(name, quick, "auto",
                                                     device, pipeline=s)
                except Exception:  # noqa: BLE001
                    failures.append(f"{name}[pipeline={s}]")
                    print(f"[{name} pipeline={s} FAILED]\n"
                          f"{traceback.format_exc()[-3000:]}")
            sweep_record[f"{name}/pipeline"] = per_pipe
            _compare(name, "pipeline-depth comparison (schedule=auto)",
                     per_pipe)
    save_result("schedule_sweep", sweep_record)
    return failures


def autotune_gate(quick: bool, *, device=None, path=None,
                  timeout: float = 600.0) -> dict:
    """Time the registered schedules on gloo worlds (each bounded by
    ``timeout`` seconds), save the tuning table (``path``, default
    ``results/tuning_torch.json``), load it back into a cost model (the
    refreshed process default when ``path`` is the default), and raise
    SystemExit(1) unless every exact registered schedule of every measured
    op was timed at every size, and every ``auto`` resolution on the
    measured ring and every table band names a registered schedule.
    Returns the table's JSON, the resolutions and the path."""
    from repro_torch.comm import autotune
    from repro_torch.comm.engine import OPS, schedules_for
    from repro_torch.comm.topology import AxisTopology

    print("\n" + "=" * 78)
    print(f"### autotune: timing registered schedules on {autotune.RANKS} "
          "gloo processes")
    print("=" * 78)
    table, record = autotune.autotune_mesh(quick=quick, device=device,
                                           timeout=timeout)
    path = table.save(path or autotune.DEFAULT_TABLE_PATH)
    save_result("autotune_raw", record)
    print(f"[tuning table -> {path}]")
    for op, sigs in table.entries.items():
        for sig, rows in sigs.items():
            bands = ", ".join(f"<= {b}B: {n}" if b is not None
                              else f"rest: {n}" for b, n in rows)
            print(f"  {op:30s} {sig:28s} {bands}")

    if path == autotune.DEFAULT_TABLE_PATH:
        model = autotune.default_cost_model(refresh=True)
    else:
        # a table kept elsewhere gets a model of its own: the process-wide
        # default stays as it was
        model = autotune.CostModel(table=autotune.TuningTable.load(path))
    # gate: auto must resolve to a registered schedule for every op across
    # the measured ring and a size ladder spanning the table bands
    bad, resolved = [], {}
    axes = (AxisTopology("x", autotune.RANKS, "ring"),)
    for op in OPS:
        for lg in range(0, 27, 2):
            choice = model.choose(op, 1 << lg, axes)
            resolved[f"{op}/{1 << lg}"] = choice
            if choice is None or choice not in schedules_for(op):
                bad.append((op, "ring", 1 << lg, choice))
    for op, sigs in table.entries.items():
        base_op = op.split("@", 1)[0]  # callsite-tagged keys
        for sig, rows in sigs.items():
            for _, name in rows:
                if name not in schedules_for(base_op):
                    bad.append((op, sig, "table", name))
    missing = autotune.untimed(record, table.meta["sizes"])
    for line in missing:
        print(f"  UNTIMED {line}")
    if bad:
        print("UNREGISTERED auto resolutions:", bad)
    if bad or missing:
        raise SystemExit(1)
    print("[autotune ok: every registered schedule timed, every auto "
          "resolution a registered schedule]")
    return {"table": table.to_json(), "resolved": resolved,
            "path": str(path)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("modules", nargs="*")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--schedule", default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--sweep-schedules", action="store_true")
    args = ap.parse_args(argv)
    if args.sweep_schedules and args.schedule is not None:
        raise SystemExit("--sweep-schedules and --schedule are "
                         "mutually exclusive")
    if args.schedule is not None:
        # engine construction is the single source of schedule validation
        from repro_torch.comm.engine import CollectiveEngine
        CollectiveEngine(schedule=args.schedule)
    only = [ALIASES.get(a, a) for a in args.modules]
    for name in only:
        if name not in MODULES:
            raise SystemExit(f"unknown benchmark {name!r}; modules are "
                             f"{MODULES} (aliases: {ALIASES})")

    if args.autotune:
        autotune_gate(args.quick, device=args.device)
        if not only and not args.sweep_schedules:
            return  # tune-only invocation
    if args.sweep_schedules:
        _finish(_sweep(only or MODULES, args.quick, args.device))
        return
    failures = []
    for name in only or MODULES:
        try:
            _run_module(name, args.quick, args.schedule, args.device)
        except Exception:  # noqa: BLE001 — report and run the others
            failures.append(name)
            print(f"[{name} FAILED]\n{traceback.format_exc()[-3000:]}")
    _finish(failures)


def _finish(failures: list) -> None:
    print("\n" + "=" * 78)
    if failures:
        print("FAILED:", failures)
        raise SystemExit(1)
    print("all benchmarks passed")


if __name__ == "__main__":
    main()
