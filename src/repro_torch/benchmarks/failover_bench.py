"""Hard-failure survival: a severed ring hop rerouted and repaired, a
lost rank survived by elastic resume, and a lost rank survived mid-serve.

Port of ``benchmarks/failover_bench.py``: its link-down, rank-loss and
serve rank-loss sections (``:61-158``, ``:160-241``, ``:251-311``).

    python -m repro_torch.benchmarks.failover_bench [--quick]
        [--device cuda|cpu]

**link-down reroute** (gated, deterministic): four gloo processes form a
ring (on one card they share it, and gloo stages every payload through host
memory). Every rank builds ``CollectiveEngine.for_mesh`` with an explicit
analytic :class:`~repro_torch.comm.autotune.CostModel` on
:data:`~repro_torch.comm.types.H100_80GB` and holds an identical
:class:`~repro_torch.comm.faults.FaultInjector`. It runs ``bcast`` (root 0)
and ``allreduce`` of the reference's int32 ``arange`` payload, and the
allreduce again on the same integers as float32 (exact in any order: the
four-rank sum stays below 2^24), before, during and after hop
:data:`DOWN_HOP` is marked hard-down, landing the health mask on the same
engine object through ``invalidate_resolutions(health=...)``. The cost
model prices every route that crosses the cut at infinity, so both ops
re-resolve onto a route that avoids it. On the ring route (``ring2d`` /
``rs_ag``) the float allreduce adds each hop's chunk with the
``ring_add_step`` kernel on the card; the rank counts those launches per
phase, which shows which route ran.

Recorded: the resolutions per phase (and whether every rank recorded the
same), the reroute latency (down event to the first rerouted collective
done, slowest rank), a :func:`~repro_torch.comm.autotune.route_links` proof
that the chosen routes exclude the cut, bit-identity of the outputs across
the three phases, their correctness against ``x[0]`` and ``x.sum(0)``, and
the kernel launches. Exits 1 unless both ops provably flip away and back,
bit-identically and correctly, on every rank alike. The times are the
host's loopback, not a link rate.

**rank-loss elastic resume** (gated): the same four processes train
reduced qwen3-moe (``tiny(4, layers=2)``, global batch 4 x 16 tokens)
through :func:`~repro_torch.train.loop.train_loop_elastic` under
``step_mode="explicit_tp"``, a checkpoint every 2 steps. The fault
schedule loses the last rank at step 4 of 6 (``--quick``; 6 of 10
otherwise): every process sees ``RankLostError``, the survivors form a
ring of :func:`~repro_torch.train.loop.largest_divisible` (3, 4) = 2
ranks, the first of them snapshots the checkpoint directory, and the
loop resumes on them from the latest checkpoint resharded onto the new
mesh; the other two processes sit out. A control loop on an identically
chosen ring of two restores the snapshot. Gate (the reference's): the
mesh shrank, the resume step is at or before the failure, the resumed run
reached the last step, and its losses equal the control's bit for bit.

**serve rank loss** (gated, reference ``:251-311``): the same four
processes serve reduced llama3.2-3b (2 layers at d_model 32; three
4-token prompts, 8 new tokens each) through a GSPMD
:class:`~repro_torch.serve.ServeEngine` on ``make_mesh((4,), ("x",))``,
each rank decoding its slot of the four and holding the pages its slot
writes. A fault schedule loses rank 3 at step 3 with ``preempt=True``:
every active request with a KV page on it (page ``p`` lives on rank ``p %
4``) drains, is re-queued with its tokens and re-prefilled on surviving
pages. Gate (the reference's): token-identical to the fault-free run, 0
tokens lost, at least one drained request; and every rank agrees.

The rank bodies, :func:`link_down_rank` and :func:`rank_loss_rank`, are
module-level functions, so that spawned processes can import them. Writes
``results/bench/torch_failover_bench.json`` at the root of the checkout.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time
from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.benchmarks.common import save_result, table
from repro_torch.comm.autotune import CostModel, route_links
from repro_torch.comm.engine import CollectiveEngine, schedules_for
from repro_torch.comm.faults import FaultInjector, FaultSchedule
from repro_torch.comm.topology import MeshTopology
from repro_torch.comm.types import H100_80GB
from repro_torch.core.hpcc import device_name, resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.mesh import spawn_mesh

RANKS = 4               # gloo processes on the ring
# per-rank payload of the rerouted collectives. The reference's is 16384
# (16 KiB); on H100_80GB's loopback figures auto already resolves both ops
# to staged at that size on a healthy ring of four, so nothing could
# reroute. At 1 MiB they resolve to ring2d, and to staged with a hop down.
NBYTES = 1 << 20
DOWN_HOP = 3            # the severed ring hop: the wraparound wire 3 -> 0
TIMEOUT = 240.0         # seconds the gloo world may take
OPS = ("bcast", "allreduce")
PHASES = ("before", "during", "after")
# the rank-loss section: (steps, failure step), quick and full, as the
# reference's; the last rank of the ring is lost
RANK_LOSS_STEPS = {True: (6, 4), False: (10, 6)}
# the serve rank loss: (failure step, lost rank), the reference's
SERVE_FAIL_AT, SERVE_LOST_RANK = 3, 3
# every section of the reference's failover_bench is ported
NOT_PORTED: Dict[str, str] = {}


def link_down_rank(mesh, hops: Sequence[int], device) -> Dict[int, Dict]:
    """Runs on every rank of a gloo ring: for each hop of ``hops``, the
    link-down section's three phases on one engine object. Returns per hop
    this rank's resolutions, routes, reroute latency, output checks and
    ``ring_add_step`` launches per phase."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(0)
    ax = mesh.axis("x")
    axes = (MeshTopology.from_mesh(mesh).axis("x"),)
    # the reference's int32 arange, one row of NBYTES per rank
    x = np.arange(ax.size * (NBYTES // 4), dtype=np.int32).reshape(ax.size,
                                                                   -1)
    local = torch.from_numpy(x[ax.index].copy()).to(device)
    local_f32 = local.float()
    ref_b, ref_a = x[0], x.sum(axis=0)
    # explicit analytic cost model: isolated from any measured table
    engine = CollectiveEngine.for_mesh(mesh,
                                       cost_model=CostModel(hw=H100_80GB))
    inj = FaultInjector(hw=H100_80GB)

    def run():
        ops.reset_launch_counts()
        outs = (engine.bcast(local, "x", 0), engine.allreduce(local, "x"),
                engine.allreduce(local_f32, "x"))
        outs = [t.cpu().numpy() for t in outs]
        return outs, ops.launch_counts()["ring_add_step"]

    def resolved():
        return {op: engine.schedule_for(op, nbytes=NBYTES, axis="x")
                for op in OPS}

    out = {}
    for hop in hops:
        res, got, launches = {}, {}, {}
        res["before"] = resolved()
        got["before"], launches["before"] = run()

        t0 = time.perf_counter()
        inj.down_link("x", hop)
        down = inj.down_links()
        engine.invalidate_resolutions(health=down)
        res["during"] = resolved()
        got["during"], launches["during"] = run()  # first rerouted run
        recovery_s = time.perf_counter() - t0
        routes = {op: route_links(op, res["during"][op], axes, health=down)
                  for op in OPS}

        inj.heal("x", hop)
        engine.invalidate_resolutions(health=inj.down_links())
        res["after"] = resolved()
        got["after"], launches["after"] = run()

        b, a, af = got["before"]
        out[hop] = {
            "device": str(local.device),
            **{f"resolved_{ph}": res[ph] for ph in PHASES},
            "route_during": {op: sorted(map(list, r)) if r is not None
                             else None for op, r in routes.items()},
            "route_excludes_cut": all(r is not None and not (r & down)
                                      for r in routes.values()),
            "recovery_s": recovery_s,
            "bit_identical": all(
                np.array_equal(got["before"][i], got[ph][i])
                for ph in PHASES for i in range(3)),
            "bcast_correct": bool(np.array_equal(b, ref_b)),
            "allreduce_correct": bool(np.array_equal(a, ref_a)
                                      and np.array_equal(af, ref_a)),
            "ring_add_step": launches,
        }
    return out


def link_down_record(per_rank, hop: int) -> Dict:
    """One hop's section record from every rank's :func:`link_down_rank`
    result: rank 0's resolutions and routes, and each check over all
    ranks."""
    recs = [r[hop] for r in per_rank]
    first = recs[0]
    keys = [f"resolved_{ph}" for ph in PHASES] + ["route_during"]
    recovery = max(r["recovery_s"] for r in recs)
    return {
        "ranks": len(recs), "nbytes": NBYTES, "down_hop": hop,
        "device": first["device"],
        **{k: first[k] for k in keys},
        "ranks_agree": all(r[k] == first[k] for r in recs for k in keys),
        "route_excludes_cut": all(r["route_excludes_cut"] for r in recs),
        "recovery_s": recovery,
        "bit_identical": all(r["bit_identical"] for r in recs),
        "bcast_correct": all(r["bcast_correct"] for r in recs),
        "allreduce_correct": all(r["allreduce_correct"] for r in recs),
        "ring_add_step_per_rank": {ph: [r["ring_add_step"][ph] for r in recs]
                                   for ph in PHASES},
        "time": recovery,
        "schedule": first["resolved_during"]["bcast"],
    }


def link_down_section(device) -> Dict:
    """The section on a gloo ring of :data:`RANKS` processes, payloads on
    ``device``."""
    per_rank = spawn_mesh(RANKS, link_down_rank, (DOWN_HOP,), str(device),
                          axes=("x",), timeout=TIMEOUT)
    return link_down_record(per_rank, DOWN_HOP)


def gate_link_down(sec) -> list:
    """The reference's gate (``_gate_link_down``), plus agreement of every
    rank's resolutions: what fails in ``sec``."""
    bad = []
    for op in OPS:
        if sec["resolved_during"][op] == sec["resolved_before"][op]:
            bad.append(f"{op} never rerouted off the severed link")
        if sec["resolved_after"][op] != sec["resolved_before"][op]:
            bad.append(f"{op} never flipped back after the repair")
        if sec["resolved_during"][op] not in schedules_for(op):
            bad.append(f"unregistered {op} resolution "
                       f"{sec['resolved_during'][op]!r}")
    if not sec["ranks_agree"]:
        bad.append("the ranks resolved different schedules")
    if not sec["route_excludes_cut"]:
        bad.append("a resolved route traverses the down link")
    if not sec["bit_identical"]:
        bad.append("outputs diverged across the reroute")
    if not (sec["bcast_correct"] and sec["allreduce_correct"]):
        bad.append("collective output wrong vs the reference")
    return bad


def rank_loss_rank(mesh, root: str, quick: bool, device) -> Dict:
    """Runs on every rank of a gloo ring: the elastic run that loses the
    last rank, then the control on a ring of the same survivors restoring
    the snapshot (``None`` where this process is outside it). Checkpoints
    and the snapshot live under ``root``, which every rank shares."""
    from repro_torch.configs import RunConfig
    from repro_torch.configs.qwen3_moe_235b_a22b import tiny
    from repro_torch.data import DataConfig
    from repro_torch.launch.mesh import sub_ring_mesh
    from repro_torch.train.loop import (TrainLoopConfig, train_loop,
                                        train_loop_elastic)

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
    ax = mesh.axis("x")
    steps, fail_at = RANK_LOSS_STEPS[quick]
    lost = ax.size - 1
    cfg = tiny(ax.size, layers=2)
    data = DataConfig(cfg.vocab_size, ax.size, 16)
    ck, snap = os.path.join(root, "ck"), os.path.join(root, "snap")

    def run(directory):
        return RunConfig(checkpoint_dir=directory, checkpoint_every=2,
                         learning_rate=1e-3, warmup_steps=1)

    fault = FaultSchedule.rank_loss(FaultInjector(hw=H100_80GB), fail_at,
                                    rank=lost)
    hist, rec = train_loop_elastic(
        cfg, run(ck), data, TrainLoopConfig(steps=steps,
                                            step_mode="explicit_tp",
                                            fault_schedule=fault),
        mesh=mesh, snapshot_dir=snap, device=device)
    # the control: a fresh loop restoring the snapshot the recovery used,
    # on an identically chosen ring (every process enters its group)
    survivors = [g for i, g in enumerate(ax.ranks) if i != lost]
    ctrl_mesh = sub_ring_mesh(survivors[:rec["new_size"]])
    ctrl = None
    if ctrl_mesh is not None:
        ctrl = train_loop(cfg, run(snap), data,
                          TrainLoopConfig(steps=steps,
                                          step_mode="explicit_tp"),
                          mesh=ctrl_mesh, device=device)["loss"]
    return {"recovery": rec, "step": hist["step"], "loss": hist["loss"],
            "control_losses": ctrl, "steps": steps, "fail_at": fail_at,
            "lost_rank": lost, "device": str(device)}


def rank_loss_record(per_rank) -> Dict:
    """The section's record from every rank's :func:`rank_loss_rank`:
    rank 0's recovery and losses (the new mesh's first rank), and whether
    every resumed rank and every control rank agree with it."""
    first = per_rank[0]
    rec = first["recovery"]
    resumed = [r for r in per_rank if not r["recovery"]["sat_out"]]
    i = first["step"].index(rec["resume_step"])
    losses = first["loss"][i:]
    ctrl = first["control_losses"]
    return {
        "ranks": len(per_rank), "steps": first["steps"],
        "fail_at": first["fail_at"], "lost_rank": first["lost_rank"],
        "device": first["device"], "recovery": rec,
        "sat_out": [r["recovery"]["sat_out"] for r in per_rank],
        "completed": bool(first["step"])
        and first["step"][-1] == first["steps"] - 1,
        "resumed_losses": losses, "control_losses": ctrl,
        "loss_bitwise": losses == ctrl,
        "ranks_agree": all(r["loss"] == first["loss"] for r in resumed)
        and all(r["control_losses"] in (None, ctrl) for r in per_rank),
        "recovery_s": rec["recovery_s"], "time": rec["recovery_s"],
    }


def rank_loss_section(device, quick: bool = True) -> Dict:
    """The section on a gloo ring of :data:`RANKS` processes, the state
    on ``device``; its checkpoints in a temporary directory, removed
    after."""
    root = tempfile.mkdtemp(prefix="torch_failover_")
    try:
        per_rank = spawn_mesh(RANKS, rank_loss_rank, root, quick,
                              str(device), axes=("x",), timeout=TIMEOUT)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return rank_loss_record(per_rank)


def gate_rank_loss(sec) -> list:
    """The reference's gate (``_gate_rank_loss``), plus agreement of the
    ranks: what fails in ``sec``."""
    bad = []
    rec = sec["recovery"]
    if rec is None:
        bad.append("rank loss never triggered elastic recovery")
    else:
        if rec["new_size"] >= rec["old_size"]:
            bad.append(f"survivor mesh did not shrink ({rec['old_size']} -> "
                       f"{rec['new_size']})")
        if rec["resume_step"] > rec["fail_step"]:
            bad.append(f"resume step {rec['resume_step']} past the failure "
                       f"at {rec['fail_step']}")
    if not sec["completed"]:
        bad.append("the resumed run never reached the final step")
    if not sec["loss_bitwise"]:
        bad.append("resumed losses diverge from the from-checkpoint control")
    if not sec["ranks_agree"]:
        bad.append("the resumed ranks disagree")
    return bad


def serve_rank_loss_rank(mesh, device) -> Dict:
    """Runs on every rank of a gloo ring: the fault-free GSPMD engine on
    ``make_mesh((n,), ("x",))``, then the same workload losing rank
    :data:`SERVE_LOST_RANK` at step :data:`SERVE_FAIL_AT` with
    ``preempt=True`` (reference ``_serve_rank_loss_section``). Weights
    from seed 0, prompts from numpy seed 11."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.kvcache import PagedCacheConfig
    from repro_torch.models.model import build_model
    from repro_torch.serve import ServeEngine

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
    n = mesh.axis("x").size
    ring = make_mesh((n,), ("x",))
    cfg = reduced(get_config("llama3.2-3b"), layers=2, d_model=32)
    model = build_model(cfg)
    params = model.init(0, device=device)
    rng = np.random.default_rng(11)
    n_req, max_new = 3, 8
    prompts = [rng.integers(0, cfg.vocab_size, size=(4,)).astype(np.int32)
               for _ in range(n_req)]
    pcfg = PagedCacheConfig(page_size=4, num_pages=16, max_slots=4,
                            max_seq=16)

    ref_eng = ServeEngine(model, params, pcfg, mesh=ring)
    for p in prompts:
        ref_eng.submit(p, max_new)
    ref = ref_eng.run()

    inj = FaultInjector(hw=H100_80GB)
    fault = FaultSchedule.rank_loss(inj, SERVE_FAIL_AT, rank=SERVE_LOST_RANK)
    eng = ServeEngine(model, params, pcfg, mesh=ring, preempt=True,
                      fault_schedule=fault)
    for p in prompts:
        eng.submit(p, max_new)
    out, stats = eng.run(collect_stats=True)
    return {"ref": {r: v.tolist() for r, v in ref.items()},
            "out": {r: v.tolist() for r, v in out.items()},
            "stats": stats, "requests": n_req, "max_new": max_new,
            "ranks": n, "device": str(params.embed.device)}


def serve_rank_loss_record(per_rank) -> Dict:
    """The section's record (the reference's keys) from every rank's
    :func:`serve_rank_loss_rank`: rank 0's streams and step stats, and
    whether every rank served the same streams."""
    from repro_torch.benchmarks.resilience_bench import _tok_per_s

    first = per_rank[0]
    ref = {r: np.asarray(v) for r, v in first["ref"].items()}
    out = {r: np.asarray(v) for r, v in first["out"].items()}
    stats = first["stats"]
    fail_at = SERVE_FAIL_AT
    return {
        "devices": first["ranks"], "requests": first["requests"],
        "max_new": first["max_new"], "fail_at": fail_at,
        "lost_rank": SERVE_LOST_RANK, "device": first["device"],
        "steps": len(stats), "drained": sum(s["drained"] for s in stats),
        "tok_per_s_before": _tok_per_s(stats, 1, fail_at),
        "tok_per_s_during": _tok_per_s(stats, fail_at, fail_at + 2),
        "tok_per_s_after": _tok_per_s(stats, fail_at + 2, len(stats)),
        "tokens_lost": sum(int(ref[r].shape[0] - out[r].shape[0])
                           for r in ref),
        "token_identical": set(ref) == set(out)
        and all(np.array_equal(ref[r], out[r]) for r in ref),
        "ranks_agree": all(r["out"] == first["out"]
                           and r["ref"] == first["ref"] for r in per_rank),
        "time": sum(s["decode_s"] for s in stats),
    }


def serve_rank_loss_section(device) -> Dict:
    """The section on a gloo ring of :data:`RANKS` processes, the weights
    and pools on ``device``."""
    per_rank = spawn_mesh(RANKS, serve_rank_loss_rank, str(device),
                          axes=("x",), timeout=TIMEOUT)
    return serve_rank_loss_record(per_rank)


def gate_serve_rank_loss(sec) -> list:
    """The reference's gate (``_gate_serve_rank_loss``), plus agreement of
    the ranks: what fails in ``sec``."""
    bad = []
    if not sec["token_identical"] or sec["tokens_lost"]:
        bad.append(f"rank loss lost tokens (lost={sec['tokens_lost']})")
    if sec["drained"] < 1:
        bad.append("the lost rank's pages never drained a request")
    if not sec["ranks_agree"]:
        bad.append("the ranks served different streams")
    return bad


def main(quick: bool = False, schedule=None, device=None) -> dict:
    device = resolve_device(device)
    if schedule not in (None, "auto"):
        print(f"[failover: --schedule {schedule} ignored: this module "
              "measures the health-masked auto path]")
    ld = link_down_section(device)
    record = {"device": device_name(device), "link_down": ld}
    print(f"-- reroute around a severed ring hop (hop {DOWN_HOP} "
          f"hard-down; {ld['ranks']} gloo processes, {NBYTES} B per rank, "
          f"{record['device']}) --")
    print(table(
        [[op] + [ld[f"resolved_{ph}"][op] for ph in PHASES] for op in OPS],
        ["op", "healthy", "severed", "repaired"]))
    print(f"   reroute latency {ld['recovery_s'] * 1e3:.1f}ms (the host's "
          f"loopback); route excludes cut={ld['route_excludes_cut']}; "
          f"bit-identical={ld['bit_identical']}; ring_add_step per rank "
          f"{ld['ring_add_step_per_rank']}")
    bad = gate_link_down(ld)
    if bad:
        save_result("failover_bench", record)
        print("LINK-DOWN GATE FAILED:", bad)
        raise SystemExit(1)

    rl = rank_loss_section(device, quick)
    record["rank_loss"] = rl
    rec = rl["recovery"]
    print(f"\n-- elastic resume after losing rank {rl['lost_rank']} at step "
          f"{rl['fail_at']} (explicit_tp, {rl['ranks']} gloo processes) --")
    print(table([[rec["old_size"], rec["new_size"], rec["fail_step"],
                  rec["resume_step"], f"{rec['recovery_s']:.2f}s",
                  rl["loss_bitwise"]]],
                ["mesh", "survivors", "fail step", "resume step",
                 "recovery", "loss bitwise"]))
    bad = gate_rank_loss(rl)
    if bad:
        save_result("failover_bench", record)
        print("RANK-LOSS GATE FAILED:", bad)
        raise SystemExit(1)

    sr = serve_rank_loss_section(device)
    record["serve_rank_loss"] = sr
    print(f"\n-- serve through losing rank {sr['lost_rank']} at step "
          f"{sr['fail_at']} (GSPMD engine on a ring of {sr['devices']} gloo "
          "processes) --")
    print(table([[sr["requests"], sr["steps"], sr["drained"],
                  f"{sr['tok_per_s_before']:.1f}",
                  f"{sr['tok_per_s_during']:.1f}",
                  f"{sr['tok_per_s_after']:.1f}", sr["tokens_lost"],
                  sr["token_identical"]]],
                ["requests", "steps", "drained", "tok/s before",
                 "tok/s during", "tok/s after", "lost", "identical"]))
    save_result("failover_bench", record)
    bad = gate_serve_rank_loss(sr)
    if bad:
        print("SERVE-RANK-LOSS GATE FAILED:", bad)
        raise SystemExit(1)
    print("[failover ok: both ops rerouted off the cut and back, "
          "bit-identical on every rank; the rank loss resumed on the "
          "survivors bit for bit as the control; the serve rank loss "
          "drained and re-prefilled with no token lost]")
    return record


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--schedule", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(args.quick, args.schedule, args.device)
