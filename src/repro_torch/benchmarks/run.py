"""Benchmark driver of the port:
``python -m repro_torch.benchmarks.run [--quick] [--schedule NAME]
[--device cuda|cpu] [--autotune] [modules...]``.

Port of ``benchmarks/run.py`` for the drivers the port has. ``--schedule``
selects a registered collective-engine schedule for every driver that
communicates; without it (or with ``--schedule auto``) every engine
resolves per callsite through the cost model
(:mod:`repro_torch.comm.autotune`) and the driver prints the choices.

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

MODULES = ["beff_bandwidth", "ptrans_scaling", "hpl_matrix_sweep",
           "hpl_scaling", "legacy_suite", "gups_fft_bench", "overlap_bench",
           "failover_bench", "resilience_bench", "lm_step_bench",
           "serve_bench"]

ALIASES = {"hpl": "hpl_scaling", "ptrans": "ptrans_scaling",
           "beff": "beff_bandwidth", "gups": "gups_fft_bench",
           "fftd": "gups_fft_bench", "overlap": "overlap_bench",
           "failover": "failover_bench", "resilience": "resilience_bench",
           "lm": "lm_step_bench", "serve": "serve_bench"}

# the drivers whose main() takes quick= and schedule=
_SCHEDULED = ("beff_bandwidth", "ptrans_scaling", "hpl_scaling",
              "gups_fft_bench", "failover_bench", "resilience_bench",
              "lm_step_bench", "serve_bench")


def _print_resolved(name: str, record) -> None:
    """Surface the cost-model choices: every resolved schedule recorded in
    the driver's result dict (the literal "auto" never appears here)."""
    picks = sorted({str(v["schedule"]) for v in (record or {}).values()
                    if isinstance(v, dict) and "schedule" in v})
    if picks:
        print(f"[{name}: resolved schedule(s): {', '.join(picks)}]")


def _run_module(name: str, quick: bool, schedule: Optional[str], device):
    print("\n" + "=" * 78)
    print(f"### repro_torch.benchmarks.{name}"
          + (f" (schedule={schedule})" if schedule else ""))
    print("=" * 78)
    t0 = time.time()
    mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
    if name in _SCHEDULED:
        record = mod.main(quick=quick, schedule=schedule, device=device)
    elif name == "overlap_bench":
        record = mod.main(device=device,
                          schedules=[schedule] if schedule else None)
    else:
        record = mod.main(quick=quick, device=device)
    if schedule in (None, "auto"):
        _print_resolved(name, record)
    print(f"[{name} done in {time.time() - t0:.1f}s]")
    return record


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
    from repro_torch.benchmarks.common import save_result
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
    args = ap.parse_args(argv)
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
        if not only:
            return  # tune-only invocation
    failures = []
    for name in only or MODULES:
        try:
            _run_module(name, args.quick, args.schedule, args.device)
        except Exception:  # noqa: BLE001 — report and run the others
            failures.append(name)
            print(f"[{name} FAILED]\n{traceback.format_exc()[-3000:]}")
    print("\n" + "=" * 78)
    if failures:
        print("FAILED:", failures)
        raise SystemExit(1)
    print("all benchmarks passed")


if __name__ == "__main__":
    main()
