"""Hard-failure survival: a severed ring hop, rerouted and repaired.

Port of the link-down section of ``benchmarks/failover_bench.py``
(``:61-158``).

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

The reference's other two sections wait for later slices of the port and
are named in the printed record under ``not_ported``: rank-loss elastic
resume (``:160-241``) needs ``train_loop_elastic`` and the
``explicit_tp`` step (ROADMAP A12's second half); serve rank loss
(``:251``) runs the serving engine on a GSPMD mesh of several ranks, which
the port's ``sharding.make_shard_fn`` refuses until the parallel model
(A12's second half).

The rank body, :func:`link_down_rank`, is a module-level function, so that
spawned processes can import it. Writes
``results/bench/torch_failover_bench.json`` at the root of the checkout.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.benchmarks.common import save_result, table
from repro_torch.comm.autotune import CostModel, route_links
from repro_torch.comm.engine import CollectiveEngine, schedules_for
from repro_torch.comm.faults import FaultInjector
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
NOT_PORTED = {
    "rank_loss": "needs train_loop_elastic and the explicit_tp step, "
                 "ROADMAP A12's second half "
                 "(benchmarks/failover_bench.py:160-241)",
    "serve_rank_loss": "needs a GSPMD mesh of several ranks, which "
                       "sharding.make_shard_fn refuses until ROADMAP A12's "
                       "second half "
                       "(benchmarks/failover_bench.py:251)",
}


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


def main(quick: bool = False, schedule=None, device=None) -> dict:
    device = resolve_device(device)
    if schedule not in (None, "auto"):
        print(f"[failover: --schedule {schedule} ignored: this module "
              "measures the health-masked auto path]")
    ld = link_down_section(device)
    record = {"device": device_name(device), "link_down": ld,
              "not_ported": NOT_PORTED}
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
    for name, why in NOT_PORTED.items():
        print(f"-- {name}: not ported yet, {why} --")
    save_result("failover_bench", record)

    bad = gate_link_down(ld)
    if bad:
        print("LINK-DOWN GATE FAILED:", bad)
        raise SystemExit(1)
    print("[failover ok: both ops rerouted off the cut and back, "
          "bit-identical on every rank]")
    return record


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--schedule", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(args.quick, args.schedule, args.device)
