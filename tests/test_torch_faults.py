"""The port's fault layer (``repro_torch/comm/faults.py``,
``repro_torch/comm/retune.py``, the measured-mode fault hook and
``TuningTable.merge`` of ``comm/autotune.py``) and its two benchmarks
(``benchmarks/failover_bench.py``, ``benchmarks/resilience_bench.py``)
against the reference's, on shared constants.

Both packages get the same hardware figures: the port's ``H100_80GB``
handed to the reference's ``HardwareModel``, and the reference's
``TPU_V5E`` handed to the port's. Every test of ``tests/test_faults.py``
runs as a scenario on both packages and must observe the same values
(floats compare with ``==``). ``extra_time`` equals the reference's for
every registered (op, schedule) on a ring of four and a 2x2 torus, with
and without seeded jitter. One four-rank gloo world runs the link-down
section at hops 0, 2 and 3, another the train-retune section; the
measured-mode hook is held to the reference's order of jittered draws
with the gloo worlds replaced by fixed times.
"""
from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest

from repro.comm import autotune as jautotune
from repro.comm import engine as jengine
from repro.comm import faults as jfaults
from repro.comm import retune as jretune
from repro.comm import topology as jtopology
from repro.comm import types as jtypes
from repro_torch.benchmarks import failover_bench, resilience_bench
from repro_torch.benchmarks import run as bench_run
from repro_torch.comm import autotune, engine, faults, retune, topology
from repro_torch.comm.callsites import HPL_PANEL
from repro_torch.comm.types import H100_80GB, HardwareModel
from repro_torch.launch.mesh import spawn_mesh

NBYTES = 16384
RING8 = (("x", 8, "ring"),)
RING4 = (("x", 4, "ring"),)
TORUS2 = (("rows", 2, "torus_row"), ("cols", 2, "torus_col"))
HARDWARE = ("h100_80gb", "tpu_v5e")
LINK_DOWN_HOPS = (0, 2, 3)


def _hw(name: str):
    """(port model, reference model) on the same constants."""
    if name == "h100_80gb":
        return H100_80GB, jtypes.HardwareModel(**dataclasses.asdict(H100_80GB))
    return HardwareModel(**dataclasses.asdict(jtypes.TPU_V5E)), jtypes.TPU_V5E


def _pkgs(hw: str):
    """The port's and the reference's modules, each with its hardware
    model on the shared constants."""
    port_hw, ref_hw = _hw(hw)
    port = SimpleNamespace(faults=faults, retune=retune, autotune=autotune,
                           engine=engine, topology=topology, hw=port_hw)
    ref = SimpleNamespace(faults=jfaults, retune=jretune, autotune=jautotune,
                          engine=jengine, topology=jtopology, hw=ref_hw)
    return port, ref


def _axes(m, spec):
    return tuple(m.topology.AxisTopology(*s) for s in spec)


def _engine(m, spec=RING8):
    """Host-side engine over a ring with an isolated analytic model: no
    live mesh needed for schedule resolution."""
    return m.engine.CollectiveEngine(
        schedule="auto", topology=m.topology.MeshTopology(axes=_axes(m, spec)),
        cost_model=m.autotune.CostModel(hw=m.hw, table=None))


def _raised(fn):
    """The exception ``fn()`` raises, as (type name, message); None when it
    returns."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the observation itself
        return type(e).__name__, str(e)
    return None


# ---------------------------------------------------------------------------
# every test of tests/test_faults.py as a scenario on both packages
# ---------------------------------------------------------------------------


def _link_fault_rejects_speedups(m):
    F = m.faults.LinkFault
    return [_raised(lambda: F("x", 0, alpha_scale=0.5)),
            _raised(lambda: F("x", 0, beta_scale=0.0)),
            dataclasses.asdict(F("x", 0, alpha_scale=1.0, beta_scale=64.0))]


def _injector_degrade_heal_roundtrip(m):
    inj = m.faults.FaultInjector(hw=m.hw)
    obs = [inj.active, inj.hardware_view() is m.hw]
    inj.degrade_link("x", 0, alpha_scale=2.0, beta_scale=8.0)
    obs += [inj.active, inj.scales(("x",)), inj.scales(("y",)),
            dataclasses.asdict(inj.hardware_view())]
    inj.heal("x", 0)
    return obs + [inj.active, inj.hardware_view() is m.hw]


def _extra_time_charges_only_link_bound_schedules(m):
    ring = _axes(m, RING8)
    inj = m.faults.FaultInjector(hw=m.hw)
    inj.degrade_link("x", 0, beta_scale=64.0)
    obs = [inj.extra_time("bcast", s, NBYTES, ring)
           for s in ("chain", "staged")]
    inj.heal()
    return obs + [inj.extra_time("bcast", "chain", NBYTES, ring)]


def _host_delays_compose_and_clear(m):
    inj = m.faults.FaultInjector(hw=m.hw)
    inj.add_host_delay(None, 0.005)
    inj.add_host_delay("train.step", 0.010)
    obs = [inj.host_delay("train.step"), inj.host_delay("serve.step")]
    inj.clear_host_delay("train.step")
    obs.append(inj.host_delay("train.step"))
    inj.clear_host_delay(None)
    return obs + [inj.host_delay("train.step"), inj.sleep("serve.step")]


def _injected_context_sets_and_restores(m):
    ring = _axes(m, RING8)
    inj = m.faults.FaultInjector(hw=m.hw)
    inj.degrade_link("x", 0, beta_scale=4.0)
    obs = [m.faults.active_injector() is None,
           m.faults.measured_extra_time("bcast", "chain", NBYTES, ring)]
    with m.faults.injected(inj):
        obs += [m.faults.active_injector() is inj,
                m.faults.measured_extra_time("bcast", "chain", NBYTES, ring)]
    m.faults.activate(inj)
    obs.append(m.faults.active_injector() is inj)
    m.faults.deactivate()
    return obs + [m.faults.active_injector() is None]


def _fault_event_validates_action(m):
    return ([dataclasses.asdict(m.faults.FaultEvent(0, a))
             for a in m.faults.FAULT_ACTIONS]
            + [_raised(lambda: m.faults.FaultEvent(0, "explode"))])


def _degrade_window_rejects_empty(m):
    inj = m.faults.FaultInjector(hw=m.hw)
    S = m.faults.FaultSchedule
    return [_raised(lambda: S.degrade_window(inj, 5, 5, beta_scale=2.0)),
            _raised(lambda: S.down_window(inj, 5, 4))]


def _schedule_applies_at_exact_steps(m):
    inj = m.faults.FaultInjector(hw=m.hw)
    sched = m.faults.FaultSchedule.degrade_window(
        inj, 3, 6, axis="x", beta_scale=16.0, host_delay_s=0.01,
        callsite="c")
    obs = [sched.span]
    for step in range(8):
        fired = sched.apply(step)
        obs.append((step, [e.action for e in fired], inj.active,
                    inj.host_delay("c")))
    sched.apply(3)
    sched.apply(3)
    obs += [inj.active, inj.scales(("x",))]
    sched.apply(6)
    return obs + [inj.active, inj.host_delay("c"), len(sched.applied)]


def _down_link_mask_and_heal(m):
    ring = _axes(m, RING8)
    inj = m.faults.FaultInjector(hw=m.hw)
    obs = [inj.down_links()]
    inj.down_link("x", 3)
    inj.degrade_link("y", 0, beta_scale=4.0)
    obs += [inj.active, inj.down_links(), inj.down_links((ring[0],)),
            inj.down_links(("y",)), inj.scales(("x",)),
            [dataclasses.asdict(f) for f in inj.faults]]
    inj.heal("x", 3)
    return obs + [inj.down_links()]


def _down_link_extra_time_is_infinite_on_crossing_routes(m):
    ring = _axes(m, RING8)
    inj = m.faults.FaultInjector(hw=m.hw)
    inj.down_link("x", 3)
    return [inj.extra_time("bcast", s, NBYTES, ring)
            for s in ("chain", "staged", "chain_rooted")]


def _health_mask_reroutes_resolution_on_same_engine(m):
    ring = _axes(m, RING8)
    inj = m.faults.FaultInjector(hw=m.hw)
    eng = _engine(m)
    before = eng.schedule_for("bcast", nbytes=NBYTES, axis="x")
    inj.down_link("x", 3)
    eng.invalidate_resolutions(health=inj.down_links())
    during = eng.schedule_for("bcast", nbytes=NBYTES, axis="x")
    route = m.autotune.route_links("bcast", during, ring,
                                   health=frozenset({("x", 3)}))
    inj.heal()
    eng.invalidate_resolutions(health=inj.down_links())
    after = eng.schedule_for("bcast", nbytes=NBYTES, axis="x")
    return [before, during, after, route]


def _health_mask_rejects_stale_measured_winner(m):
    t = m.autotune.TuningTable(hw="test")
    t.set("bcast", "ring[8]", [(None, "chain")])
    model = m.autotune.CostModel(hw=m.hw, table=t,
                                 health=frozenset({("x", 2)}))
    return model.choose("bcast", NBYTES, _axes(m, RING8))


def _doubly_broken_ring_falls_back_to_staged(m):
    ring = _axes(m, RING8)
    health = frozenset({("x", 1), ("x", 5)})
    model = m.autotune.CostModel(hw=m.hw, table=None, health=health)
    winner = model.choose("bcast", NBYTES, ring)
    return [winner, m.autotune.route_links("bcast", winner, ring,
                                           health=health)]


def _rank_loss_lifecycle(m):
    inj = m.faults.FaultInjector(hw=m.hw)
    obs = [inj.lost_ranks]
    inj.fail_rank(3)
    inj.fail_rank(5)
    obs += [inj.active, inj.lost_ranks]
    inj.restore_ranks()
    obs += [inj.lost_ranks, inj.active]
    err = m.faults.RankLostError({5, 3}, 12)
    return obs + [err.ranks, err.step, str(err),
                  isinstance(err, RuntimeError)]


def _fault_schedule_fail_rank_is_one_shot(m):
    inj = m.faults.FaultInjector(hw=m.hw)
    sched = m.faults.FaultSchedule.rank_loss(inj, 4, rank=7)
    sched.apply(4)
    obs = [inj.lost_ranks]
    inj.restore_ranks()
    sched.apply(4)
    return obs + [inj.lost_ranks, sched.span]


def _down_window_round_trip(m):
    inj = m.faults.FaultInjector(hw=m.hw)
    sched = m.faults.FaultSchedule.down_window(inj, 3, 6, axis="x", hop=2)
    obs = []
    for step in range(8):
        sched.apply(step)
        obs.append(inj.down_links())
    return obs


def _fault_schedule_parse(m):
    inj = m.faults.FaultInjector(hw=m.hw)
    S = m.faults.FaultSchedule
    sched = S.parse(inj, "degrade@5-20:axis=x,hop=1,beta_scale=64;"
                         "down@8-12:axis=x,hop=3;"
                         "delay@5-9:seconds=0.05,callsite=train.step;"
                         "fail_rank@12:rank=3")
    obs = [[dataclasses.asdict(e) for e in sched.events]]
    sched.apply(8)
    obs.append(inj.down_links())
    sched.apply(12)
    obs += [inj.down_links(), inj.lost_ranks]
    return obs + [_raised(lambda: S.parse(inj, "explode@3")),
                  _raised(lambda: S.parse(inj, "fail_rank@3-5:rank=1")),
                  _raised(lambda: S.parse(inj, "down@3:speed=2"))]


def _tuning_table_merge_overrides_per_signature(m):
    T = m.autotune.TuningTable
    base = T(hw="a", meta={"k": 1, "keep": True})
    base.set("bcast", "ring[8]", [(None, "chain")])
    base.set("allreduce", "ring[8]", [(None, "rs_ag")])
    other = T(hw="b", meta={"k": 2})
    other.set("bcast", "ring[8]", [(4096, "native"), (None, "staged")])
    merged = base.merge(other)
    return [merged.to_json(), base.to_json(), other.to_json()]


def _invalidate_resolutions_swaps_without_rebuild(m):
    inj = m.faults.FaultInjector(hw=m.hw)
    eng = _engine(m)

    def res():
        return eng.schedule_for("bcast", nbytes=NBYTES, axis="x",
                                callsite="hpl.panel")
    before = res()
    inj.degrade_link("x", 0, beta_scale=64.0)
    eng.invalidate_resolutions(hw=inj.hardware_view())
    during = res()
    inj.heal()
    eng.invalidate_resolutions(hw=inj.hardware_view())
    return [before, during, res()]


def _invalidate_resolutions_swaps_table(m):
    eng = _engine(m)
    t = m.autotune.TuningTable(hw="test")
    t.set("bcast", "ring[8]", [(None, "native")])
    eng.invalidate_resolutions(table=t)
    return eng.schedule_for("bcast", nbytes=NBYTES, axis="x")


def _controller(m, eng, inj, **kw):
    kw.setdefault("drift_factor", 1.75)
    kw.setdefault("recent", 2)
    kw.setdefault("min_baseline", 3)
    kw.setdefault("cooldown", 2)
    return m.retune.RetuneController(
        eng, [m.retune.Watched("hpl.panel", "bcast", NBYTES, "x")],
        hw_probe=inj.hardware_view, **kw)


def _event_obs(ev):
    if ev is None:
        return None
    return (ev.step, ev.trigger, ev.hot, ev.detect_steps, ev.before,
            ev.after, ev.changed)


def _controller_validation(m):
    eng = _engine(m)
    inj = m.faults.FaultInjector(hw=m.hw)
    R, W = m.retune.RetuneController, m.retune.Watched
    ctrl = _controller(m, eng, inj)
    return [_raised(lambda: R(eng, [W("c", "bcast", 1, "x")],
                              drift_factor=1.0)),
            _raised(lambda: R(eng, [])),
            _raised(lambda: ctrl.retune(0, trigger="panic")),
            m.retune.RETUNE_TRIGGERS]


def _controller_detects_degrade_and_heal(m):
    eng = _engine(m)
    inj = m.faults.FaultInjector(hw=m.hw)
    ctrl = _controller(m, eng, inj)
    obs = [_event_obs(ctrl.observe(step, 1.0)) for step in range(6)]
    inj.degrade_link("x", 0, beta_scale=64.0)
    obs += [_event_obs(ctrl.observe(step, 16.0)) for step in range(6, 12)]
    inj.heal()
    obs += [_event_obs(ctrl.observe(step, 1.0)) for step in range(12, 24)]
    return obs + [len(ctrl.events), ctrl.resolutions()]


def _controller_straggler_trigger_and_cooldown(m):
    eng = _engine(m)
    inj = m.faults.FaultInjector(hw=m.hw)
    ctrl = _controller(m, eng, inj, cooldown=5)
    inj.degrade_link("x", 0, beta_scale=64.0)
    return [_event_obs(ctrl.on_straggler(7)),
            _event_obs(ctrl.on_straggler(8)),
            _event_obs(ctrl.observe(9, 100.0)), len(ctrl.events)]


def _controller_callsite_stream_narrows_hot_set(m):
    eng = _engine(m)
    inj = m.faults.FaultInjector(hw=m.hw)
    W = m.retune.Watched
    ctrl = m.retune.RetuneController(
        eng, [W("hpl.panel", "bcast", NBYTES, "x"),
              W("dp.grads", "allreduce", NBYTES, "x")],
        drift_factor=1.75, recent=2, min_baseline=3, cooldown=2,
        hw_probe=inj.hardware_view)
    inj.degrade_link("x", 0, beta_scale=64.0)
    return [_event_obs(ctrl.observe(step, 16.0 if step >= 5 else 1.0,
                                    callsite="hpl.panel"))
            for step in range(10)]


SCENARIOS = {f.__name__[1:]: f for f in (
    _link_fault_rejects_speedups, _injector_degrade_heal_roundtrip,
    _extra_time_charges_only_link_bound_schedules,
    _host_delays_compose_and_clear, _injected_context_sets_and_restores,
    _fault_event_validates_action, _degrade_window_rejects_empty,
    _schedule_applies_at_exact_steps, _down_link_mask_and_heal,
    _down_link_extra_time_is_infinite_on_crossing_routes,
    _health_mask_reroutes_resolution_on_same_engine,
    _health_mask_rejects_stale_measured_winner,
    _doubly_broken_ring_falls_back_to_staged, _rank_loss_lifecycle,
    _fault_schedule_fail_rank_is_one_shot, _down_window_round_trip,
    _fault_schedule_parse, _tuning_table_merge_overrides_per_signature,
    _invalidate_resolutions_swaps_without_rebuild,
    _invalidate_resolutions_swaps_table, _controller_validation,
    _controller_detects_degrade_and_heal,
    _controller_straggler_trigger_and_cooldown,
    _controller_callsite_stream_narrows_hot_set)}


@pytest.mark.parametrize("hw", HARDWARE)
@pytest.mark.parametrize("case", sorted(SCENARIOS))
def test_mirrors_reference_test(case, hw):
    """The scenario of ``tests/test_faults.py::test_<case>`` observes the
    same values on the port as on the reference, on the same figures."""
    port, ref = _pkgs(hw)
    got, want = SCENARIOS[case](port), SCENARIOS[case](ref)
    assert got == want


def test_reference_expectations_hold_on_tpu_figures():
    """On the reference's own figures the port reaches the values
    ``tests/test_faults.py`` pins for the reference."""
    port, _ = _pkgs("tpu_v5e")
    assert _health_mask_reroutes_resolution_on_same_engine(port)[:3] == \
        ["chain", "chain_rooted", "chain"]
    assert _invalidate_resolutions_swaps_without_rebuild(port) == \
        ["chain", "staged", "chain"]
    assert _doubly_broken_ring_falls_back_to_staged(port) == \
        ["staged", frozenset()]
    events = [e for e in _controller_detects_degrade_and_heal(port)[:-2]
              if e is not None]
    assert [e[-1] for e in events] == [
        {"hpl.panel": ("chain", "staged")},
        {"hpl.panel": ("staged", "chain")}]


# ---------------------------------------------------------------------------
# extra_time over every registered (op, schedule), with and without jitter
# ---------------------------------------------------------------------------

FAULT_STATES = {
    "degraded": [("degrade", "x", 0, 2.0, 8.0), ("degrade", "rows", 1, 1.0,
                                                 64.0)],
    "down": [("down", "x", 3), ("down", "cols", 0)],
    "both": [("degrade", "x", 1, 4.0, 2.0), ("down", "x", 2),
             ("degrade", "cols", 0, 1.5, 16.0), ("down", "rows", 1)],
}


def _install(inj, state):
    for f in FAULT_STATES[state]:
        if f[0] == "degrade":
            inj.degrade_link(f[1], f[2], alpha_scale=f[3], beta_scale=f[4])
        else:
            inj.down_link(f[1], f[2])


@pytest.mark.parametrize("jitter", [0.0, 0.3])
@pytest.mark.parametrize("state", sorted(FAULT_STATES))
@pytest.mark.parametrize("topo", ["ring4", "torus2x2"])
def test_extra_time_equals_reference(topo, state, jitter):
    port, ref = _pkgs("h100_80gb")
    spec = RING4 if topo == "ring4" else TORUS2
    variants = [spec] + ([spec[:1], spec[1:]] if len(spec) > 1 else [])
    injs = [m.faults.FaultInjector(hw=m.hw, seed=11, delay_scale=1e4,
                                   jitter=jitter) for m in (port, ref)]
    for inj in injs:
        _install(inj, state)
    got, want = [], []
    for v in variants:
        for op in engine.OPS:
            for name in engine.schedules_for(op):
                for S in (1 << 10, NBYTES, 1 << 20, 1 << 24):
                    got.append(injs[0].extra_time(op, name, S,
                                                  _axes(port, v)))
                    want.append(injs[1].extra_time(op, name, S,
                                                   _axes(ref, v)))
    assert got == want
    if state != "down":
        assert any(math.isfinite(t) and t > 0 for t in got)
    if state != "degraded":
        assert any(math.isinf(t) for t in got)


@pytest.mark.parametrize("state", sorted(FAULT_STATES))
def test_views_equal_reference(state):
    """``scales``, ``hardware_view``, ``down_links`` and
    ``cost_model_view`` over every axis selection."""
    port, ref = _pkgs("h100_80gb")
    injs = [m.faults.FaultInjector(hw=m.hw) for m in (port, ref)]
    for inj in injs:
        _install(inj, state)
    for sel in (None, ("x",), ("rows",), ("cols",), ("rows", "cols"),
                ("y",)):
        a, b = (inj.scales(sel) for inj in injs)
        assert a == b
        assert dataclasses.asdict(injs[0].hardware_view(axes=sel)) == \
            dataclasses.asdict(injs[1].hardware_view(axes=sel))
        assert injs[0].down_links(sel) == injs[1].down_links(sel)
    pm, rm = (inj.cost_model_view() for inj in injs)
    assert isinstance(pm, autotune.CostModel) and pm.table is None
    assert dataclasses.asdict(pm.hw) == dataclasses.asdict(rm.hw) and pm.health == rm.health
    for spec in (RING4, TORUS2):
        for op in engine.OPS:
            assert pm.choose(op, 1 << 20, _axes(port, spec)) == \
                rm.choose(op, 1 << 20, _axes(ref, spec))


SPECS = ["degrade@5-20:axis=x,hop=1,beta_scale=64",
         "down@8-12:axis=x,hop=3",
         "delay@5-9:seconds=0.05,callsite=train.step",
         "fail_rank@12:rank=3",
         "degrade@5-20:axis=x,hop=1,beta_scale=64;down@8-12:axis=x,hop=3;"
         "delay@5-9:seconds=0.05,callsite=train.step;fail_rank@12:rank=3",
         "degrade@2:alpha_scale=3,beta_scale=2 ; heal@4:axis=x ;"
         "clear_delay@6:callsite=serve.step",
         "down@1-3:axis=rows,hop=1;degrade@2-5:axis=cols,beta_scale=8"]


@pytest.mark.parametrize("spec", range(len(SPECS)))
def test_schedule_parse_and_apply_equal_reference(spec):
    port, ref = _pkgs("h100_80gb")
    scheds = []
    for m in (port, ref):
        inj = m.faults.FaultInjector(hw=m.hw)
        scheds.append(m.faults.FaultSchedule.parse(inj, SPECS[spec]))
    assert [dataclasses.asdict(e) for e in scheds[0].events] == \
        [dataclasses.asdict(e) for e in scheds[1].events]
    assert scheds[0].span == scheds[1].span
    for step in range(-1, 25):
        fired = [[dataclasses.asdict(e) for e in s.apply(step)]
                 for s in scheds]
        assert fired[0] == fired[1]
        a, b = (s.injector for s in scheds)
        assert [dataclasses.asdict(f) for f in a.faults] == \
            [dataclasses.asdict(f) for f in b.faults]
        assert (a.active, a.down_links(), a.lost_ranks,
                a.host_delay("train.step"), a.host_delay("serve.step")) == \
            (b.active, b.down_links(), b.lost_ranks,
             b.host_delay("train.step"), b.host_delay("serve.step"))


def test_merge_equals_reference_on_measured_shapes():
    """``TuningTable.merge`` of tables with callsite keys and several
    signatures, as a narrow re-measurement merges over a full table."""
    tables = []
    for m in _pkgs("h100_80gb"):
        base = m.autotune.TuningTable(hw="h100_80gb",
                                      meta={"ranks": 4, "sizes": [1, 2]})
        base.set("bcast", "ring[4]", [(1024, "chain"), (None, "native")])
        base.set("bcast@hpl.panel", "torus_row[2]", [(None, "native")])
        base.set("bcast@hpl.panel", "torus_col[2]", [(None, "native")])
        fresh = m.autotune.TuningTable(hw="fresh", meta={"sizes": [3]})
        fresh.set("bcast@hpl.panel", "torus_row[2]", [(None, "chain")])
        fresh.set("allreduce", "ring[4]", [(None, "rs_ag")])
        tables.append(base.merge(fresh).to_json())
    assert tables[0] == tables[1]
    assert tables[0]["meta"] == {"ranks": 4, "sizes": [3]}


# ---------------------------------------------------------------------------
# reroute parity: single down hops on a ring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nbytes", [NBYTES, 1 << 20])
@pytest.mark.parametrize("ring", [4, 8])
@pytest.mark.parametrize("hw", HARDWARE)
def test_reroute_equals_reference(hw, ring, nbytes):
    """Under each single down hop both packages resolve the same names:
    ``staged`` on the H100 model (its loopback figures price the staged
    route below the rooted chain), ``chain_rooted`` on the TPU figures, as
    ``tests/dist/test_resilience.py:144`` asserts for the reference."""
    port, ref = _pkgs(hw)
    spec = (("x", ring, "ring"),)
    for hop in range(ring):
        health = frozenset({("x", hop)})
        got = {op: autotune.CostModel(hw=port.hw, health=health).choose(
            op, nbytes, _axes(port, spec)) for op in ("bcast", "allreduce")}
        want = {op: jautotune.CostModel(hw=ref.hw, health=health).choose(
            op, nbytes, _axes(ref, spec)) for op in ("bcast", "allreduce")}
        assert got == want
        expect = "staged" if hw == "h100_80gb" else "chain_rooted"
        assert set(got.values()) == {expect}, (hop, got)
        for op, name in got.items():
            route = autotune.route_links(op, name, _axes(port, spec),
                                         health=health)
            assert route is not None and ("x", hop) not in route


def test_payload_size_makes_the_reroute_visible():
    """Why the port's benchmarks run 1 MiB, not the reference's 16 KiB: on the
    H100 model the healthy ring already resolves to ``staged`` at 16 KiB,
    and to ``ring2d`` at 1 MiB."""
    ring = _axes(_pkgs("h100_80gb")[0], RING4)
    model = autotune.CostModel(hw=H100_80GB)
    for op in ("bcast", "allreduce"):
        assert model.choose(op, NBYTES, ring) == "staged"
        assert model.choose(op, failover_bench.NBYTES, ring) == "ring2d"
    assert failover_bench.NBYTES == resilience_bench.NBYTES == 1 << 20


# ---------------------------------------------------------------------------
# the link-down section on a four-rank gloo ring, hops 0, 2 and 3
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def link_down():
    per_rank = spawn_mesh(failover_bench.RANKS, failover_bench.link_down_rank,
                          LINK_DOWN_HOPS, "cpu", axes=("x",), timeout=240)
    return {hop: (failover_bench.link_down_record(per_rank, hop),
                  [r[hop] for r in per_rank]) for hop in LINK_DOWN_HOPS}


@pytest.mark.parametrize("hop", LINK_DOWN_HOPS)
def test_link_down_outputs_bitwise(link_down, hop):
    """bcast and both allreduces equal the healthy run's bits in every
    phase and numpy's ``x[0]`` / ``x.sum(0)`` on every rank; the CPU route
    launches no kernel."""
    sec, recs = link_down[hop]
    assert sec["ranks"] == 4 and sec["device"] == "cpu"
    for rec in recs:
        assert rec["bit_identical"]
        assert rec["bcast_correct"] and rec["allreduce_correct"]
        assert rec["ring_add_step"] == dict.fromkeys(
            failover_bench.PHASES, 0)


@pytest.mark.parametrize("hop", LINK_DOWN_HOPS)
def test_link_down_routes_avoid_cut(link_down, hop):
    """Every rank resolves what the reference's ``CostModel`` resolves on
    the same figures and health, and the rerouted routes exclude the
    cut."""
    sec, recs = link_down[hop]
    _, ref_hw = _hw("h100_80gb")
    ref_ring = tuple(jtopology.AxisTopology(*s) for s in RING4)
    for ph, health in (("before", frozenset()),
                       ("during", frozenset({("x", hop)})),
                       ("after", frozenset())):
        want = {op: jautotune.CostModel(hw=ref_hw, health=health).choose(
            op, failover_bench.NBYTES, ref_ring) for op in ("bcast",
                                                            "allreduce")}
        assert all(r[f"resolved_{ph}"] == want for r in recs), ph
    assert sec["resolved_before"] == {"bcast": "ring2d", "allreduce": "ring2d"}
    assert sec["resolved_during"] == {"bcast": "staged", "allreduce": "staged"}
    assert sec["route_excludes_cut"] and sec["ranks_agree"]
    assert sec["route_during"] == {"bcast": [], "allreduce": []}


@pytest.mark.parametrize("hop", LINK_DOWN_HOPS)
def test_link_down_gate_passes(link_down, hop):
    sec, _ = link_down[hop]
    assert failover_bench.gate_link_down(sec) == []
    assert sec["recovery_s"] > 0 and sec["schedule"] == "staged"


@pytest.mark.parametrize("fault", ["no_reroute", "no_flip_back",
                                   "ranks_disagree", "crosses_cut",
                                   "diverged", "wrong"])
def test_link_down_gate_refuses(link_down, fault):
    sec = dict(link_down[failover_bench.DOWN_HOP][0])
    if fault == "no_reroute":
        sec["resolved_during"] = dict(sec["resolved_before"])
    elif fault == "no_flip_back":
        sec["resolved_after"] = dict(sec["resolved_during"])
    elif fault == "ranks_disagree":
        sec["ranks_agree"] = False
    elif fault == "crosses_cut":
        sec["route_excludes_cut"] = False
    elif fault == "diverged":
        sec["bit_identical"] = False
    else:
        sec["allreduce_correct"] = False
    assert failover_bench.gate_link_down(sec)


# ---------------------------------------------------------------------------
# the train-retune section on a four-rank gloo ring
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def train_retune():
    per_rank = spawn_mesh(resilience_bench.RANKS,
                          resilience_bench.train_retune_rank, "cpu",
                          axes=("x",), timeout=240)
    return resilience_bench.train_retune_record(per_rank), per_rank


def test_train_retune_flips_at_8_and_20_on_every_rank(train_retune):
    sec, per_rank = train_retune
    for rec in per_rank:
        flips = [(e["step"], e["changed"]) for e in rec["events"]
                 if e["changed"]]
        assert flips == [
            (resilience_bench.FAULT_AT, {HPL_PANEL: ["ring2d", "staged"]}),
            (resilience_bench.HEAL_AT, {HPL_PANEL: ["staged", "ring2d"]})]
    assert sec["detect_degrade_steps"] == sec["detect_heal_steps"] == 0
    assert sec["flip_events"] == 2 and sec["ranks_agree"]
    assert sec["by_phase"] == {"before": ["ring2d"],
                               "during": ["ring2d", "staged"],
                               "after": ["ring2d", "staged"]}


def test_train_retune_trace_identical_on_every_rank(train_retune):
    sec, per_rank = train_retune
    for rec in per_rank:
        assert rec["trace"] == per_rank[0]["trace"]
        assert rec["bit_identical"] and rec["bcast_correct"]
        assert rec["device"] == "cpu"
    assert resilience_bench.gate_train_retune(sec) == []


def test_train_retune_equals_reference_controller(train_retune):
    """The reference's ``RetuneController`` over a reference engine on the
    same figures, fed the same schedule of faults, prices the same modeled
    step durations (``==``), resolves the same schedule at every step and
    fires the same events."""
    _, per_rank = train_retune
    trace = per_rank[0]["trace"]
    _, ref_hw = _hw("h100_80gb")
    ring = tuple(jtopology.AxisTopology(*s) for s in RING4)
    inj = jfaults.FaultInjector(hw=ref_hw)
    fault = jfaults.FaultSchedule.degrade_window(
        inj, resilience_bench.FAULT_AT, resilience_bench.HEAL_AT, axis="x",
        hop=0, beta_scale=resilience_bench.BETA_SCALE)
    eng = jengine.CollectiveEngine(
        topology=jtopology.MeshTopology(axes=ring),
        cost_model=jautotune.CostModel(hw=ref_hw))
    ctrl = jretune.RetuneController(
        eng, [jretune.Watched(HPL_PANEL, "bcast", resilience_bench.NBYTES,
                              "x")],
        hw_probe=inj.hardware_view, **resilience_bench.CONTROLLER)
    for step in range(resilience_bench.STEPS):
        fault.apply(step)
        resolved = ctrl.resolutions()[HPL_PANEL]
        hw = inj.hardware_view()
        dur = sum(jautotune._seg_time(s, hw)
                  for op, sched in (("bcast", resolved),
                                    ("allreduce", "rs_ag"))
                  for s in jautotune.segments(op, sched,
                                              resilience_bench.NBYTES,
                                              ring, hw))
        event = ctrl.observe(step, dur)
        assert trace[step] == {"step": step, "resolved": resolved,
                               "modeled_s": dur,
                               "retuned": event is not None}
    want = [{"step": e.step, "trigger": e.trigger,
             "detect_steps": e.detect_steps,
             "changed": {k: list(v) for k, v in e.changed.items()}}
            for e in ctrl.events]
    got = [{k: v for k, v in e.items() if k != "duration_s"}
           for e in per_rank[0]["events"]]
    assert got == want


@pytest.mark.parametrize("fault", ["no_flip", "no_flip_back", "one_flip",
                                   "late", "ranks_disagree", "diverged"])
def test_train_retune_gate_refuses(train_retune, fault):
    sec = dict(train_retune[0])
    if fault == "no_flip":
        sec["resolved_during"] = sec["resolved_before"]
    elif fault == "no_flip_back":
        sec["resolved_after"] = sec["resolved_during"]
    elif fault == "one_flip":
        sec["flip_events"] = 1
    elif fault == "late":
        sec["detect_heal_steps"] = 7
    elif fault == "ranks_disagree":
        sec["ranks_agree"] = False
    else:
        sec["bit_identical"] = False
    assert resilience_bench.gate_train_retune(sec)


# ---------------------------------------------------------------------------
# the measured-mode hook and the measured retune
# ---------------------------------------------------------------------------


def _fake_spawn(nprocs, fn, jobs, reps, device, axes, timeout):
    """Fixed per-job times in place of a gloo world: rank r, rep k."""
    return [{job: [1e-3 * (1 + len(job[0]) + len(job[2]) / 8.0
                           + job[1] / 2.0 ** 20) + 1e-6 * (r + k)
                   for k in range(reps)] for job in jobs}
            for r in range(nprocs)]


def test_hook_adds_measured_extra_time_in_reference_order(monkeypatch):
    """Under ``injected(inj)`` every job's time is its ranks' time plus
    exactly what the reference's ``_measure_op`` adds: its injector's
    ``extra_time`` over the world's axes (the first one for an
    ``op@callsite`` pattern), the jittered draws taken job by job in the
    reference's order."""
    from repro_torch.launch import mesh as launch_mesh

    monkeypatch.setattr(launch_mesh, "spawn_mesh", _fake_spawn)
    clean, clean_rec = autotune.autotune_mesh(quick=True, device="cpu",
                                              verbose=False)
    port, ref = _pkgs("h100_80gb")
    injs = [m.faults.FaultInjector(hw=m.hw, seed=5, delay_scale=1e3,
                                   jitter=0.3) for m in (port, ref)]
    for inj in injs:
        inj.degrade_link("x", 0, beta_scale=64.0)
        inj.degrade_link("rows", 1, alpha_scale=3.0)
        inj.degrade_link("cols", 0, beta_scale=8.0)
    with faults.injected(injs[0]):
        _, rec = autotune.autotune_mesh(quick=True, device="cpu",
                                        verbose=False)
    assert faults.active_injector() is None
    worlds = {"ring": (("x", 4, "ring"),), "torus": TORUS2}
    sizes = (1 << 10, 1 << 16)
    n_extra = 0
    for op in autotune.MEASURED_OPS:
        base = op.split("@", 1)[0]
        spec = worlds["torus" if op in autotune._TORUS_OPS else "ring"]
        ref_axes = _axes(ref, spec[:1] if "@" in op else spec)
        names = [s for s in jengine.schedules_for(base)
                 if s not in jautotune.LOSSY_SCHEDULES]
        assert names == autotune.exact_schedules(op)
        for S in autotune.op_sizes(op, sizes):
            key = f"{op}/{autotune.axis_signature(_axes(port, spec[:1] if '@' in op else spec))}/{S}"
            got, base_t = rec[key]["times_s"], clean_rec[key]["times_s"]
            for name in names:
                extra = injs[1].extra_time(base, name, S, ref_axes)
                assert got[name] == base_t[name] + extra, (op, S, name)
                n_extra += extra > 0
    assert n_extra > 0
    assert clean.to_json()["entries"].keys() == \
        set(autotune.table_keys())


def test_hook_leaves_times_alone_without_injector(monkeypatch):
    from repro_torch.launch import mesh as launch_mesh

    monkeypatch.setattr(launch_mesh, "spawn_mesh", _fake_spawn)
    _, a = autotune.autotune_mesh(ops=("bcast",), quick=True, device="cpu",
                                  verbose=False)
    inj = faults.FaultInjector()
    inj.degrade_link("y", 0, beta_scale=64.0)  # touches no measured axis
    with faults.injected(inj):
        _, b = autotune.autotune_mesh(ops=("bcast",), quick=True,
                                      device="cpu", verbose=False)
    assert a == b


def test_measured_retune_merges_like_reference(monkeypatch):
    """``measure=True`` from a process that is not a rank: the narrow
    ladder asks for the same pattern and sizes as the reference's, and the
    merged table it swaps into the engine equals the reference's merge."""
    calls = {}

    def fake(mod):
        def autotune_mesh(*, ops, sizes, reps, quick, verbose, **kw):
            calls[mod.__name__] = (ops, list(sizes), reps, quick)
            t = mod.TuningTable(hw="fresh", meta={"sizes": list(sizes)})
            t.set(ops[0], "ring[8]", [(None, "native")])
            return t, {}
        return autotune_mesh

    monkeypatch.setattr(autotune, "autotune_mesh", fake(autotune))
    monkeypatch.setattr(jautotune, "autotune_mesh", fake(jautotune))
    out = []
    for m in _pkgs("h100_80gb"):
        eng = _engine(m)
        table = m.autotune.TuningTable(hw="base")
        table.set("allreduce", "ring[8]", [(None, "rs_ag")])
        eng.invalidate_resolutions(table=table)
        inj = m.faults.FaultInjector(hw=m.hw)
        ctrl = m.retune.RetuneController(
            eng, [m.retune.Watched(HPL_PANEL, "bcast", NBYTES, "x"),
                  m.retune.Watched("dp.grads", "allreduce", NBYTES, "x")],
            hw_probe=inj.hardware_view, measure=True,
            table_path=None)
        ev = ctrl.retune(3, hot=[HPL_PANEL])
        out.append((eng._model().table.to_json(), _event_obs(ev)))
    assert out[0] == out[1]
    assert calls[autotune.__name__] == calls[jautotune.__name__] == (
        ("bcast@hpl.panel",), [4096, 16384, 65536], 2, True)


def _measured_controller_in_rank(mesh):
    eng = _engine(_pkgs("h100_80gb")[0])
    try:
        retune.RetuneController(eng, [retune.Watched(HPL_PANEL, "bcast",
                                                     NBYTES, "x")],
                                measure=True)
    except RuntimeError as e:
        return str(e)
    return None


def test_measured_retune_refused_inside_a_rank():
    """A rank of a spawned gloo world cannot start the ladder's worlds:
    the controller refuses ``measure=True`` there instead of hanging."""
    msg, = spawn_mesh(1, _measured_controller_in_rank, axes=("x",),
                      timeout=120)
    assert msg is not None and "daemon" in msg and "hw_probe" in msg


def test_run_registers_the_benchmarks():
    for name in ("failover_bench", "resilience_bench"):
        assert name in bench_run.MODULES and name in bench_run._SCHEDULED
    assert bench_run.ALIASES["failover"] == "failover_bench"
    assert bench_run.ALIASES["resilience"] == "resilience_bench"
    # the rank-loss section came with train_loop_elastic, the serve rank
    # loss with the paged decode on a mesh: every section is ported
    assert failover_bench.NOT_PORTED == {}
    assert callable(failover_bench.rank_loss_section)
    assert callable(failover_bench.serve_rank_loss_section)
    # the train-degradation section came with the training loop: every
    # section of the reference's resilience_bench is ported
    assert not hasattr(resilience_bench, "NOT_PORTED")
    assert callable(resilience_bench.train_degradation_section)
    assert "serve_bench" in bench_run.MODULES
    assert "serve_bench" in bench_run._SCHEDULED
    assert bench_run.ALIASES["serve"] == "serve_bench"


def test_benchmarks_without_card_raise(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (failover_bench, resilience_bench):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(quick=True)


def test_modeled_step_collapse_is_visible():
    """At the benchmarks' 1 MiB the 64x collapse moves the modeled step past
    ``drift_factor`` (24x), where at 16 KiB it would not (1.42x)."""
    ring = _axes(_pkgs("h100_80gb")[0], RING4)
    inj = faults.FaultInjector()
    clean = resilience_bench.modeled_step(inj, ring, "ring2d")
    inj.degrade_link("x", 0, beta_scale=resilience_bench.BETA_SCALE)
    degraded = resilience_bench.modeled_step(inj, ring, "ring2d")
    assert degraded / clean > 20 > resilience_bench.CONTROLLER[
        "drift_factor"]
    assert np.isfinite(clean) and clean > 0
