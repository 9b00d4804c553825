"""Degraded-link resilience: detect drift, retune mid-run, flip back.

Port of the train-retune and measured-retune sections of
``benchmarks/resilience_bench.py`` (``_modeled_step``,
``_train_retune_section``, ``_gate_train_retune``,
``_measured_retune_section``, ``:67-204``).

    python -m repro_torch.benchmarks.resilience_bench [--quick]
        [--device cuda|cpu]

* **train retune** (gated, deterministic): on every rank of a ring of four
  gloo processes, a scripted
  :class:`~repro_torch.comm.faults.FaultSchedule` collapses one ring
  link's bandwidth (``beta_scale`` :data:`BETA_SCALE`) over steps
  [:data:`FAULT_AT`, :data:`HEAL_AT`). Each rank's
  :class:`~repro_torch.comm.retune.RetuneController` watches the modeled
  step durations (:func:`modeled_step`), detects the drift, re-prices its
  engine on the injector's degraded hardware view and swaps the
  ``hpl.panel`` bcast schedule through ``invalidate_resolutions``, without
  rebuilding the engine; after the heal the two-sided detector flips it
  back. The durations are the same deterministic numbers on every rank, so
  every rank flips at the same step, as it must: the next collective pairs
  the ranks' schedules. The section runs the ``hpl.panel`` bcast once per
  phase on the real ring (payload on the card unless ``--device cpu``).
  Recorded: the resolution per phase, the detect delays (steps), the retune
  latency, the flip events, and the bcast's bit-identity across the phases.
  Exits 1 unless the schedule flips away and back within [0, 6] steps of
  each event, bit-identically, and every rank recorded the same trace.
* **measured retune** (informational): the narrow
  :func:`~repro_torch.comm.autotune.autotune_mesh` ladder for the hot
  callsite's pattern (``bcast@hpl.panel``), clean and under
  :func:`~repro_torch.comm.faults.injected`, from this process (a measured
  retune cannot run inside a rank). Measured winners on the host's loopback
  are noisy, so this section records and never gates. As in the reference,
  the fault sits on axis ``x`` while the pattern is measured on the torus
  axes ``rows``/``cols``, so the injected delay is 0 and the section
  compares two clean runs (ROADMAP C14).

The reference's other two sections wait for later slices and are named in
the printed record under ``not_ported``: train degradation (``:206-264``)
needs the training loop (ROADMAP A12), serve degradation (``:274``) the
serving engine (A13).

The rank body, :func:`train_retune_rank`, is a module-level function, so
that spawned processes can import it. Writes
``results/bench/torch_resilience_bench.json`` at the root of the checkout.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.benchmarks.common import save_result, table
from repro_torch.comm.autotune import (CostModel, _seg_time, autotune_mesh,
                                       segments)
from repro_torch.comm.callsites import HPL_PANEL
from repro_torch.comm.engine import CollectiveEngine, schedules_for
from repro_torch.comm.faults import FaultInjector, FaultSchedule, injected
from repro_torch.comm.retune import RetuneController, Watched
from repro_torch.comm.topology import MeshTopology
from repro_torch.comm.types import H100_80GB
from repro_torch.core.hpcc import device_name, resolve_device
from repro_torch.launch.mesh import spawn_mesh

RANKS = 4               # gloo processes on the ring
# the watched hpl.panel payload per rank. The reference's is 16384 (16
# KiB); on H100_80GB's loopback figures the bcast resolves to staged at
# that size whatever the link does, and the 64x collapse moves the modeled
# step only 1.42x, under drift_factor, so nothing would retune. At 1 MiB
# the bcast resolves to ring2d, and the collapse moves the step 24x.
NBYTES = 1 << 20
BETA_SCALE = 64.0       # bandwidth collapse on the degraded link
FAULT_AT, HEAL_AT = 8, 20
STEPS = 30
TIMEOUT = 240.0         # seconds each gloo world may take
CONTROLLER = dict(drift_factor=1.75, recent=2, min_baseline=3, cooldown=2)
PHASES = (("before", 0, FAULT_AT), ("during", FAULT_AT, HEAL_AT),
          ("after", HEAL_AT, STEPS))
NOT_PORTED = {
    "train_degradation": "needs the training loop, ROADMAP A12 "
                         "(benchmarks/resilience_bench.py:206-264)",
    "serve_degradation": "needs the serving engine, ROADMAP A13 "
                         "(benchmarks/resilience_bench.py:274)",
}


def modeled_step(inj: FaultInjector, axes, bcast_schedule: str) -> float:
    """Deterministic stand-in for one step's comm wall time under the
    injector's current link state: the watched bcast at its current
    resolution plus a fixed-schedule gradient allreduce that always rides
    the ring, so a healed link shows up even while the bcast has been
    retuned onto a route that avoids the link."""
    hw = inj.hardware_view()
    t = 0.0
    for op, schedule in (("bcast", bcast_schedule), ("allreduce", "rs_ag")):
        t += sum(_seg_time(s, hw)
                 for s in segments(op, schedule, NBYTES, axes, hw))
    return t


def train_retune_rank(mesh, device) -> Dict:
    """Runs on every rank of a gloo ring: the train-retune loop with this
    rank's own engine, injector and controller. Returns the step trace, the
    retune events, and the per-phase bcast's checks."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(0)
    ax = mesh.axis("x")
    axes = (MeshTopology.from_mesh(mesh).axis("x"),)
    inj = FaultInjector(hw=H100_80GB)
    fault = FaultSchedule.degrade_window(
        inj, FAULT_AT, HEAL_AT, axis="x", hop=0, beta_scale=BETA_SCALE)
    # explicit analytic cost model: isolated from any measured table
    engine = CollectiveEngine.for_mesh(mesh,
                                       cost_model=CostModel(hw=H100_80GB))
    ctrl = RetuneController(engine, [Watched(HPL_PANEL, "bcast", NBYTES,
                                             "x")],
                            hw_probe=inj.hardware_view, **CONTROLLER)
    x = np.arange(ax.size * (NBYTES // 4), dtype=np.int32).reshape(ax.size,
                                                                   -1)
    local = torch.from_numpy(x[ax.index].copy()).to(device)

    trace, outputs = [], {}
    for step in range(STEPS):
        fault.apply(step)
        resolved = ctrl.resolutions()[HPL_PANEL]
        dur = modeled_step(inj, axes, resolved)
        event = ctrl.observe(step, dur)
        trace.append({"step": step, "resolved": resolved, "modeled_s": dur,
                      "retuned": event is not None})
        phase = next(ph for ph, lo, hi in PHASES if lo <= step < hi)
        if phase not in outputs:
            # the same engine object: only its cost model was mutated
            outputs[phase] = engine.bcast(local, "x", 0,
                                          callsite=HPL_PANEL).cpu().numpy()
    return {
        "device": str(local.device), "trace": trace,
        "events": [{"step": e.step, "trigger": e.trigger,
                    "detect_steps": e.detect_steps,
                    "duration_s": e.duration_s,
                    "changed": {k: list(v) for k, v in e.changed.items()}}
                   for e in ctrl.events],
        "bit_identical": all(np.array_equal(outputs["before"], o)
                             for o in outputs.values()),
        "bcast_correct": bool(np.array_equal(outputs["before"], x[0])),
    }


def train_retune_record(per_rank) -> Dict:
    """The section record from every rank's :func:`train_retune_rank`
    result: rank 0's trace and events, and each check over all ranks.
    The ranks agree when their traces and events are equal, the retunes'
    wall-clock durations aside."""
    first = per_rank[0]
    trace = first["trace"]

    def timeless(rec):
        return [{k: v for k, v in e.items() if k != "duration_s"}
                for e in rec["events"]]

    flips = [e for e in first["events"] if e["changed"]]
    retune_s = max((e["duration_s"] for r in per_rank for e in r["events"]),
                   default=0.0)
    return {
        "ranks": len(per_rank), "nbytes": NBYTES, "device": first["device"],
        "beta_scale": BETA_SCALE, "fault_at": FAULT_AT, "heal_at": HEAL_AT,
        "steps": STEPS,
        "resolved_before": trace[FAULT_AT - 1]["resolved"],
        "resolved_during": trace[HEAL_AT - 1]["resolved"],
        "resolved_after": trace[STEPS - 1]["resolved"],
        "by_phase": {ph: sorted({t["resolved"] for t in trace
                                 if lo <= t["step"] < hi})
                     for ph, lo, hi in PHASES},
        "events": first["events"],
        "flip_events": len(flips),
        "detect_degrade_steps": (flips[0]["step"] - FAULT_AT) if flips
        else None,
        "detect_heal_steps": (flips[1]["step"] - HEAL_AT) if len(flips) > 1
        else None,
        "ranks_agree": all(r["trace"] == trace
                           and timeless(r) == timeless(first)
                           for r in per_rank),
        "retune_s": retune_s,
        "time": retune_s,
        "bit_identical": all(r["bit_identical"] for r in per_rank),
        "bcast_correct": all(r["bcast_correct"] for r in per_rank),
        "schedule": trace[HEAL_AT - 1]["resolved"],
        "trace": trace,
    }


def train_retune_section(device) -> Dict:
    """The section on a gloo ring of :data:`RANKS` processes, payloads on
    ``device``."""
    return train_retune_record(spawn_mesh(RANKS, train_retune_rank,
                                          str(device), axes=("x",),
                                          timeout=TIMEOUT))


def gate_train_retune(sec) -> list:
    """The reference's gate (``_gate_train_retune``), plus agreement of
    every rank's trace: what fails in ``sec``."""
    bad = []
    if sec["resolved_during"] == sec["resolved_before"]:
        bad.append("schedule never flipped away under the degraded link")
    if sec["resolved_after"] != sec["resolved_before"]:
        bad.append("schedule never flipped back after the heal")
    if sec["flip_events"] < 2:
        bad.append(f"expected >= 2 flip events, saw {sec['flip_events']}")
    if not sec["ranks_agree"]:
        bad.append("the ranks' retune traces differ")
    if not sec["bit_identical"]:
        bad.append("bcast outputs diverged across schedule flips")
    if not sec["bcast_correct"]:
        bad.append("bcast output wrong vs the broadcast reference")
    for k in ("detect_degrade_steps", "detect_heal_steps"):
        if sec[k] is None or not 0 <= sec[k] <= 6:
            bad.append(f"{k}={sec[k]} outside [0, 6]")
    for name in (sec["resolved_before"], sec["resolved_during"]):
        if name not in schedules_for("bcast"):
            bad.append(f"unregistered resolution {name!r}")
    return bad


def measured_retune_section(quick: bool, device) -> Dict:
    """Informational: the narrow measured ladder, clean and with the
    injector active, timed on gloo worlds this process spawns. Writes no
    table."""
    inj = FaultInjector(hw=H100_80GB, delay_scale=1e4)
    inj.degrade_link("x", 0, beta_scale=BETA_SCALE)
    sizes = (NBYTES,) if quick else (NBYTES // 4, NBYTES, NBYTES * 4)
    op = "bcast@hpl.panel"
    t0 = time.perf_counter()
    clean, _ = autotune_mesh(ops=(op,), sizes=sizes, reps=1, quick=True,
                             device=device, timeout=TIMEOUT)
    with injected(inj):
        degraded, _ = autotune_mesh(ops=(op,), sizes=sizes, reps=1,
                                    quick=True, device=device,
                                    timeout=TIMEOUT)
    return {
        "ranks": RANKS, "sizes": list(sizes), "op": op,
        "clean_winners": clean.entries.get(op, {}),
        "degraded_winners": degraded.entries.get(op, {}),
        "fault": {"axis": "x", "hop": 0, "beta_scale": BETA_SCALE},
        "measured_on": ["rows", "cols"],
        "caveat": "the fault is on axis x and the pattern is measured on "
                  "the torus axes, so the injected delay is 0: two clean "
                  "runs, as in the reference (ROADMAP C14)",
        "wall_s": time.perf_counter() - t0,
    }


def main(quick: bool = False, schedule=None, device=None) -> dict:
    device = resolve_device(device)
    if schedule not in (None, "auto"):
        print(f"[resilience: --schedule {schedule} ignored: this module "
              "measures the adaptive auto path]")
    record = {"device": device_name(device), "not_ported": NOT_PORTED}

    tr = train_retune_section(device)
    record["train_retune"] = tr
    print(f"-- adaptive retune under a scripted degraded link (beta/"
          f"{BETA_SCALE:.0f} on one ring hop; {tr['ranks']} gloo processes, "
          f"{NBYTES} B per rank, {record['device']}) --")
    print(table([[ph, "/".join(tr["by_phase"][ph])] for ph, _, _ in PHASES],
                ["phase", "hpl.panel resolution(s)"]))
    print(f"   detect: degrade +{tr['detect_degrade_steps']} steps, "
          f"heal +{tr['detect_heal_steps']} steps; retune "
          f"{tr['retune_s'] * 1e3:.1f}ms; ranks agree={tr['ranks_agree']}; "
          f"bit-identical={tr['bit_identical']}")

    mr = measured_retune_section(quick, device)
    record["measured_retune"] = mr
    print("\n-- narrow measured ladder, injector active (informational: "
          "the host's timing noise) --")
    print(f"   clean:    {mr['clean_winners']}")
    print(f"   degraded: {mr['degraded_winners']}")
    print(f"   {mr['caveat']}")
    for name, why in NOT_PORTED.items():
        print(f"-- {name}: not ported yet, {why} --")
    save_result("resilience_bench", record)

    bad = gate_train_retune(tr)
    if bad:
        print("TRAIN-RETUNE GATE FAILED:", bad)
        raise SystemExit(1)
    print("[resilience ok: hpl.panel flipped away and back on every rank, "
          "bit-identical]")
    return record


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--schedule", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(args.quick, args.schedule, args.device)
