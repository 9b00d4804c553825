"""The port's cost model and autotuner (``repro_torch/comm/autotune.py``,
``repro_torch/roofline.py``) against the reference's, bit for bit.

Both packages get the same constants: ``BITTWARE_520N``, which both
define, and the port's ``H100_80GB`` handed to the reference's
``HardwareModel``. Over rings of 1, 2, 4, 8 and 26 ranks (the paper's
largest run) and tori of 1x1, 2x2, 4x4 and 5x5, at message sizes 2^0 to
2^30, every function of the analytic model returns the reference's value
exactly: floats compare with ``==``. The engine resolves ``auto``,
``nchunks="auto"`` and the bucket as the reference's engine does on the
same topology and an explicit model on the same constants
(``tests/test_autotune.py:568-645``). One 4-rank gloo world runs the quick
measured mode and the ``--autotune`` gate, writing only under
``tmp_path``.
"""
from __future__ import annotations

import dataclasses
import json
import math

import pytest
import torch

from repro import roofline as jroofline
from repro.comm import autotune as jautotune
from repro.comm import engine as jengine
from repro.comm import topology as jtopology
from repro.comm import types as jtypes
from repro_torch import roofline
from repro_torch.benchmarks import common, hpl_scaling
from repro_torch.benchmarks import run as bench_run
from repro_torch.comm import autotune, engine, topology
from repro_torch.comm.engine import CollectiveEngine
from repro_torch.comm.types import BITTWARE_520N, H100_80GB
from repro_torch.launch.mesh import MeshAxis

SIZES = tuple(1 << k for k in range(31))
RINGS = (1, 2, 4, 8, 26)
TORI = (1, 2, 4, 5)
TOPOLOGIES = ([f"ring{n}" for n in RINGS] + [f"torus{p}x{p}" for p in TORI])
HARDWARE = ("bittware_520n", "h100_80gb")
CALLSITES = (None, "hpl.block", "hpl.panel", "ptrans.exchange",
             "ra.updates", "fft.transpose")
MiB = 1 << 20


def _hw(name: str):
    """(port model, reference model) on the same constants."""
    if name == "bittware_520n":
        assert dataclasses.asdict(BITTWARE_520N) == \
            dataclasses.asdict(jtypes.BITTWARE_520N)
        return BITTWARE_520N, jtypes.BITTWARE_520N
    return H100_80GB, jtypes.HardwareModel(**dataclasses.asdict(H100_80GB))


def _axes(name: str):
    """(port axes, reference axes) of a topology id."""
    if name.startswith("ring"):
        spec = [("x", int(name[4:]), "ring")]
    else:
        p = int(name[5:].split("x")[0])
        spec = [("rows", p, "torus_row"), ("cols", p, "torus_col")]
    return (tuple(topology.AxisTopology(*s) for s in spec),
            tuple(jtopology.AxisTopology(*s) for s in spec))


def _variants(name: str):
    """The whole axis tuple, and each axis alone on a torus (HPL's row and
    column broadcasts price one axis)."""
    port, ref = _axes(name)
    out = [(port, ref)]
    if len(port) > 1:
        out += [((p,), (r,)) for p, r in zip(port, ref)]
    return out


def _healths(name: str):
    port, _ = _axes(name)
    first, last = port[0], port[-1]
    return [frozenset(), frozenset({(first.name, 0)}),
            frozenset({(last.name, last.size - 1)}),
            frozenset({(first.name, 0), (first.name, 1)})]


PAIRS = sorted(autotune._SEGS)


# ---------------------------------------------------------------------------
# roofline: the alpha-beta terms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("hw", HARDWARE)
def test_alpha_beta_time_equals_reference(hw, staged):
    port, ref = _hw(hw)
    for hops in (0, 0.5, 1, 3, 6.0, 25, 325):
        for wire in (0.0, 1.0, 4096.0, 3.5 * MiB, 2.0 ** 30):
            assert roofline.alpha_beta_time(hops, wire, port,
                                            staged=staged) == \
                jroofline.alpha_beta_time(hops, wire, ref, staged=staged)


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("hw", HARDWARE)
def test_pipelined_alpha_beta_time_equals_reference(hw, staged):
    port, ref = _hw(hw)
    for hops in (0, 0.5, 1, 3, 6.0, 25, 325):
        for wire in (0.0, 1.0, 4096.0, 3.5 * MiB, 2.0 ** 30):
            for s in (0, 1, 2, 3, 16):
                got = roofline.pipelined_alpha_beta_time(hops, wire, s, port,
                                                         staged=staged)
                assert got == jroofline.pipelined_alpha_beta_time(
                    hops, wire, s, ref, staged=staged)
            # one chunk is the monolithic term, up to the order of its
            # floating-point operations
            assert math.isclose(
                roofline.pipelined_alpha_beta_time(hops, wire, 1, port,
                                                   staged=staged),
                roofline.alpha_beta_time(hops, wire, port, staged=staged),
                rel_tol=1e-12, abs_tol=0.0)


# ---------------------------------------------------------------------------
# the analytic model, bit for bit
# ---------------------------------------------------------------------------


def test_model_tables_equal_reference():
    assert autotune._SEGS.keys() == jautotune._SEGS.keys()
    for name in ("NATIVE_SYNC_HOPS", "INT8_WIRE_RATIO", "LOSSY_SCHEDULES",
                 "MAX_PIPELINE_CHUNKS", "MAX_LOOKAHEAD_DEPTH",
                 "PIPELINE_DEPTH", "MIN_BUCKET_BYTES", "MAX_BUCKET_BYTES"):
        assert getattr(autotune, name) == getattr(jautotune, name), name
    for op in engine.OPS:
        assert engine.schedules_for(op) == jengine.schedules_for(op)
    assert engine._AUTO == jengine._AUTO
    assert autotune.DEFAULT_TABLE_PATH.name == "tuning_torch.json"
    assert autotune.DEFAULT_TABLE_PATH.parent == \
        jautotune.DEFAULT_TABLE_PATH.parent


@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("hw", HARDWARE)
def test_segments_equal_reference(hw, topo):
    port_hw, ref_hw = _hw(hw)
    for port, ref in _variants(topo):
        assert autotune.axis_signature(port) == jautotune.axis_signature(ref)
        for op, sched in PAIRS + [("bcast", "nope")]:
            for S in SIZES:
                assert autotune.segments(op, sched, S, port, port_hw) == \
                    jautotune.segments(op, sched, S, ref, ref_hw)
            assert autotune.route_links(op, sched, port) == \
                jautotune.route_links(op, sched, ref)


@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("hw", HARDWARE)
def test_cost_and_rank_equal_reference(hw, topo):
    port_hw, ref_hw = _hw(hw)
    for health in _healths(topo):
        pm = autotune.CostModel(hw=port_hw, health=health)
        rm = jautotune.CostModel(hw=ref_hw, health=health)
        for port, ref in _variants(topo):
            for S in SIZES:
                for op, sched in PAIRS:
                    assert pm.cost(op, sched, S, port) == \
                        rm.cost(op, sched, S, ref)
                for op in engine.OPS:
                    assert pm.rank(op, S, port) == rm.rank(op, S, ref)
                    assert pm.rank(op, S, port, include_lossy=True) == \
                        rm.rank(op, S, ref, include_lossy=True)


@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("hw", HARDWARE)
def test_choose_equal_reference(hw, topo):
    """Analytic choices under every health mask, then a measured table with
    tagged and untagged bands, one stale entry and one lossy entry, over
    the callsites."""
    port_hw, ref_hw = _hw(hw)
    port_axes, ref_axes = _axes(topo)
    sig = autotune.axis_signature(port_axes)
    bands = {"bcast": [(4096, "native"), (None, "ring2d")],
             "bcast@hpl.panel": [(None, "chain_rooted")],
             "allreduce": [(1 << 16, "int8_ef"), (None, "staged")],
             "all_to_all_tiles@ra.updates": [(None, "staged")],
             "ring_exchange": [(None, "gone")]}
    tables = [None]
    for mod in (autotune, jautotune):
        t = mod.TuningTable()
        for op, rows in bands.items():
            t.set(op, sig, rows)
            for a in port_axes:
                t.set(op, autotune.axis_signature((a,)), rows)
        tables.append(t)
    for table_pair in ((None, None), (tables[1], tables[2])):
        for health in _healths(topo):
            pm = autotune.CostModel(hw=port_hw, table=table_pair[0],
                                    health=health)
            rm = jautotune.CostModel(hw=ref_hw, table=table_pair[1],
                                     health=health)
            for port, ref in _variants(topo):
                for S in SIZES:
                    for op in engine.OPS:
                        for cs in CALLSITES:
                            got = pm.choose(op, S, port, callsite=cs)
                            assert got == rm.choose(op, S, ref, callsite=cs)
                            assert got is None or \
                                got not in autotune.LOSSY_SCHEDULES


@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("hw", HARDWARE)
def test_best_nchunks_equal_reference(hw, topo):
    port_hw, ref_hw = _hw(hw)
    for port, ref in _variants(topo):
        for op, sched in PAIRS:
            for S in SIZES:
                got = autotune.best_nchunks(op, sched, S, port, port_hw)
                assert got == jautotune.best_nchunks(op, sched, S, ref,
                                                     ref_hw)
                assert 1 <= got[0] <= autotune.MAX_PIPELINE_CHUNKS
                for k in (1, 3, 8):
                    assert autotune.pipelined_cost(op, sched, S, port, k,
                                                   port_hw) == \
                        jautotune.pipelined_cost(op, sched, S, ref, k,
                                                 ref_hw)
            assert autotune.best_nchunks(op, sched, 1 << 26, port, port_hw,
                                         max_chunks=4) == \
                jautotune.best_nchunks(op, sched, 1 << 26, ref, ref_hw,
                                       max_chunks=4)


@pytest.mark.parametrize("topo", [t for t in TOPOLOGIES
                                  if t.startswith("torus")])
@pytest.mark.parametrize("hw", HARDWARE)
def test_choose_hpl_depth_equal_reference(hw, topo):
    """The model's own choice, a forced schedule through ``resolve``, and an
    unpriceable one (the ceiling), for HPL's block sizes and local
    matrices."""
    port_hw, ref_hw = _hw(hw)
    port, ref = _axes(topo)
    for forced in (None, "chain", "staged", "ring2d", "nope"):
        def resolve(op, nbytes, ax, callsite, forced=forced):
            return forced
        for b in (16, 32, 64, 128, 256):
            for lb in (1, 2, 8, 64, 256):
                kw = dict(b=b, m=lb * b, max_depth=3)
                if forced is not None:
                    kw["resolve"] = resolve
                got = autotune.choose_hpl_depth(
                    axes=port, model=autotune.CostModel(hw=port_hw), **kw)
                assert got == jautotune.choose_hpl_depth(
                    axes=ref, model=jautotune.CostModel(hw=ref_hw), **kw)
                assert 1 <= got <= 3


@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("hw", HARDWARE)
def test_derive_bucket_bytes_equal_reference(hw, topo):
    port_hw, ref_hw = _hw(hw)
    for port, ref in _variants(topo):
        for depth in (1, 2, autotune.PIPELINE_DEPTH, 16, 1 << 12):
            got = autotune.derive_bucket_bytes(port, port_hw, depth=depth)
            assert got == jautotune.derive_bucket_bytes(ref, ref_hw,
                                                        depth=depth)
            assert autotune.MIN_BUCKET_BYTES <= got <= \
                autotune.MAX_BUCKET_BYTES
            assert got & (got - 1) == 0


# ---------------------------------------------------------------------------
# the tuning table
# ---------------------------------------------------------------------------


def _table(mod):
    t = mod.TuningTable(hw="h100_80gb", meta={"ranks": 4, "sizes": [1024]})
    t.set("bcast", "ring[4]", [(4096, "chain"), (None, "native")])
    t.set("bcast@hpl.panel", "torus_row[2]", [(None, "ring2d")])
    t.set("all_to_all_tiles@fft.transpose", "ring[4]",
          [(1 << 16, "native"), (None, "chain")])
    return t


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_tuning_table_json_round_trip(direction, tmp_path):
    src, dst = ((autotune, jautotune) if direction == "port_to_reference"
                else (jautotune, autotune))
    t = _table(src)
    path = t.save(tmp_path / "t.json")
    assert path.parent == tmp_path
    back = dst.TuningTable.load(path)
    assert back.to_json() == t.to_json()
    assert dst.TuningTable.from_json(json.loads(json.dumps(t.to_json()))) \
        .entries == t.entries
    for sig, S, cs in (("ring[4]", 100, None), ("ring[4]", 5000, "hpl.panel"),
                       ("torus_row[2]", 1, "hpl.panel"),
                       ("torus_row[2]", 1, None),
                       ("ring[4]", 1 << 20, "fft.transpose")):
        for op in ("bcast", "all_to_all_tiles"):
            assert back.lookup(op, sig, S, cs) == t.lookup(op, sig, S, cs)
    assert dst.TuningTable.load(tmp_path / "missing.json") is None


@pytest.mark.parametrize("case", range(6))
def test_winner_bounds_equal_reference(case):
    sizes = [1 << k for k in range(10, 10 + 2 * (case + 1), 2)]
    names = ["chain", "native", "staged"]
    winners = [names[(i * (case + 1)) % 3] if case % 2 else names[i // 3 % 3]
               for i in range(len(sizes))]
    got = autotune._winner_bounds(sizes, winners)
    assert got == jautotune._winner_bounds(sizes, winners)
    assert got[-1][0] is None


@pytest.mark.parametrize("case", ["hand_written", "same_device",
                                  "other_device", "same_backend",
                                  "other_backend", "missing"])
def test_table_backend_guard(case, monkeypatch, tmp_path):
    """A measured table applies only where it was measured: the device type
    always, the process group's backend inside one. The default model
    loads ``results/tuning_torch.json`` only through that guard (here a
    file under tmp_path; the process default is restored after)."""
    now = {"backend": "gloo" if "backend" in case else None,
           "device": "cpu"}
    monkeypatch.setattr(autotune, "runtime_backend", lambda: now)
    meta = {"hand_written": {},
            "same_device": {"backend": "gloo", "device": "cpu"},
            "other_device": {"backend": "gloo", "device": "cuda"},
            "same_backend": {"backend": "gloo", "device": "cpu"},
            "other_backend": {"backend": "nccl", "device": "cpu"},
            "missing": None}[case]
    want = case in ("hand_written", "same_device", "same_backend")
    path = tmp_path / "tuning_torch.json"
    t = None
    if meta is not None:
        t = _table(autotune)
        t.meta = meta
        t.save(path)
    assert autotune._table_matches_runtime(t) is want
    monkeypatch.setattr(autotune, "DEFAULT_TABLE_PATH", path)
    monkeypatch.setattr(autotune, "_DEFAULT_MODEL", None)
    model = autotune.default_cost_model()
    assert model is autotune.default_cost_model()
    assert model.hw == H100_80GB
    assert (model.table is not None) is want
    if want:
        assert model.choose("bcast", 100, (topology.AxisTopology(
            "x", 4, "ring"),)) == "chain"


# ---------------------------------------------------------------------------
# engine resolution on a topology with an explicit model
# ---------------------------------------------------------------------------


RING8 = (("x", 8, "ring"),)


def _engines(hw="h100_80gb", spec=RING8, table=None, **kw):
    """(port engine, reference engine) on one topology, each with its own
    explicit cost model on the same constants."""
    port_hw, ref_hw = _hw(hw)
    ptable, rtable = table or (None, None)
    port = CollectiveEngine(
        topology=topology.MeshTopology(
            axes=tuple(topology.AxisTopology(*s) for s in spec)),
        cost_model=autotune.CostModel(hw=port_hw, table=ptable), **kw)
    ref = jengine.CollectiveEngine(
        topology=jtopology.MeshTopology(
            axes=tuple(jtopology.AxisTopology(*s) for s in spec)),
        cost_model=jautotune.CostModel(hw=ref_hw, table=rtable), **kw)
    return port, ref


ENGINE_CASES = ("auto_through_model", "no_payload_static", "unknown_axis",
                "partial_name", "bucket_bytes", "override", "callsite_table",
                "pipeline_chunks", "host_staged", "health", "describe",
                "torus")


@pytest.mark.parametrize("hw", HARDWARE)
@pytest.mark.parametrize("case", ENGINE_CASES)
def test_engine_resolution_equals_reference(case, hw):
    """tests/test_autotune.py:568-645 on both packages."""
    sizes = (256, 1 << 10, 1 << 16, MiB, 64 * MiB)
    if case == "auto_through_model":
        port, ref = _engines(hw)
        for op in engine.OPS:
            for S in sizes:
                got = port.schedule_for(op, nbytes=S, axis="x")
                assert got == ref.schedule_for(op, nbytes=S, axis="x")
                assert got != "auto" and got in engine.schedules_for(op)
    elif case == "no_payload_static":
        port, ref = _engines(hw)
        for op in engine.OPS:
            assert port.schedule_for(op) == ref.schedule_for(op) \
                == engine._AUTO[op]
            assert port.schedule_for(op, nbytes=1024, axis=None) == \
                engine._AUTO[op]
    elif case == "unknown_axis":
        port, ref = _engines(hw)
        assert port.schedule_for("allreduce", nbytes=1024, axis="bogus") \
            == ref.schedule_for("allreduce", nbytes=1024, axis="bogus") \
            == "native"
    elif case == "partial_name":
        port, ref = _engines(hw, schedule="rs_ag")
        for op in engine.OPS:
            for S in sizes:
                assert port.schedule_for(op, nbytes=S, axis="x") == \
                    ref.schedule_for(op, nbytes=S, axis="x")
        assert port.schedule_for("allreduce", nbytes=1024, axis="x") \
            == "rs_ag"
    elif case == "bucket_bytes":
        port, ref = _engines(hw)
        assert port.bucket_bytes_for("x") == ref.bucket_bytes_for("x") \
            == autotune.derive_bucket_bytes(port.topology.axes, _hw(hw)[0])
        with pytest.raises(KeyError):
            port.bucket_bytes_for("bogus")
    elif case == "override":
        port, ref = _engines(hw)
        for S in sizes:
            assert port.schedule_for("allreduce", "chain", nbytes=S,
                                     axis="x") == "chain"
        with pytest.raises(engine.UnknownScheduleError):
            port.schedule_for("allreduce", "nope", nbytes=1024, axis="x")
    elif case == "callsite_table":
        tables = []
        for mod in (autotune, jautotune):
            t = mod.TuningTable()
            t.set("bcast@hpl.panel", "ring[8]", [(None, "ring2d")])
            tables.append(t)
        port, ref = _engines(hw, table=tables)
        for cs in CALLSITES:
            for S in sizes:
                assert port.schedule_for("bcast", nbytes=S, axis="x",
                                         callsite=cs) == \
                    ref.schedule_for("bcast", nbytes=S, axis="x", callsite=cs)
        assert port.schedule_for("bcast", nbytes=1024, axis="x",
                                 callsite="hpl.panel") == "ring2d"
    elif case == "pipeline_chunks":
        port, ref = _engines(hw)
        for op in ("bcast", "allreduce", "all_to_all_tiles"):
            for S in sizes:
                assert port.pipeline_chunks(op, nbytes=S, axis="x") == \
                    ref.pipeline_chunks(op, nbytes=S, axis="x")
        assert port.pipeline_chunks("bcast", nbytes=64 * MiB,
                                    axis="bogus") == 1
        assert port.pipeline_chunks("bcast") == 1
    elif case == "host_staged":
        port, ref = _engines(hw, comm="host_staged")
        for op in engine.OPS:
            assert port.schedule_for(op, nbytes=MiB, axis="x") == \
                ref.schedule_for(op, nbytes=MiB, axis="x") == "staged"
    elif case == "health":
        port, ref = _engines(hw)
        for eng in (port, ref):
            eng.invalidate_resolutions(health={("x", 3)})
        ax = MeshAxis("x", 8, 0, tuple(range(8)))
        assert engine._cut_hop(port, ax) == jengine._cut_hop(ref, "x", 8) \
            == 3
        for op in engine.OPS:
            for S in sizes:
                got = port.schedule_for(op, nbytes=S, axis="x")
                assert got == ref.schedule_for(op, nbytes=S, axis="x")
        assert port.schedule_for("bcast", nbytes=MiB, axis="x") in \
            ("chain_rooted", "staged")
        for eng in (port, ref):
            eng.invalidate_resolutions(health=frozenset())
        assert engine._cut_hop(port, ax) == 7
        assert port.schedule_for("bcast", nbytes=MiB, axis="x") == \
            ref.schedule_for("bcast", nbytes=MiB, axis="x")
    elif case == "describe":
        for kw in ({}, {"schedule": "chain"}, {"comm": "host_staged"}):
            port, ref = _engines(hw, **kw)
            assert port.describe() == ref.describe()
        assert CollectiveEngine().describe()["auto_resolver"] == "static"
    else:  # torus: the row/column broadcasts and the grid ops
        spec = (("rows", 4, "torus_row"), ("cols", 4, "torus_col"))
        port, ref = _engines(hw, spec=spec)
        for axis in ("rows", "cols", ("rows", "cols")):
            for op in engine.OPS:
                for S in sizes:
                    assert port.schedule_for(op, nbytes=S, axis=axis) == \
                        ref.schedule_for(op, nbytes=S, axis=axis)
            assert port.bucket_bytes_for(axis) == ref.bucket_bytes_for(axis)


def test_default_model_is_the_h100_one():
    """Without an explicit model the engine prices on the H100 constants,
    and ``invalidate_resolutions`` on an engine with its own model leaves
    the process default alone."""
    eng, _ = _engines()
    default = autotune.default_cost_model()
    eng.invalidate_resolutions(health={("x", 0)})
    assert autotune.default_cost_model() is default
    assert not default.health
    assert CollectiveEngine()._model() is default
    assert default.hw == H100_80GB


# ---------------------------------------------------------------------------
# measured mode and the --autotune gate on a 4-rank gloo world
# ---------------------------------------------------------------------------


def test_autotune_mesh_and_gate_on_gloo_ring(monkeypatch, tmp_path):
    monkeypatch.setattr(common, "RESULTS", tmp_path / "bench")
    default = autotune._DEFAULT_MODEL
    path = tmp_path / "tuning_torch.json"
    out = bench_run.autotune_gate(True, device="cpu", path=path,
                                  timeout=240)
    assert out["path"] == str(path) and path.is_file()
    assert autotune._DEFAULT_MODEL is default
    table = autotune.TuningTable.load(path)
    assert table.meta["backend"] == "gloo" and table.meta["device"] == "cpu"
    assert table.meta["sizes"] == [1 << 10, 1 << 16]
    assert set(table.entries) == set(autotune.table_keys())
    assert table.entries["all_to_all_tiles@moe.combine"] == \
        table.entries["all_to_all_tiles@moe.dispatch"]
    assert set(table.entries["bcast@hpl.panel"]) == {"torus_row[2]",
                                                      "torus_col[2]"}
    assert set(table.entries["grid_transpose"]) == \
        {"torus_row[2]+torus_col[2]"}
    for op, sigs in table.entries.items():
        for rows in sigs.values():
            assert rows[-1][0] is None
            for _, name in rows:
                assert name in engine.schedules_for(op.split("@")[0])
                assert name not in autotune.LOSSY_SCHEDULES
    raw = json.loads((tmp_path / "bench" / "torch_autotune_raw.json")
                     .read_text())
    assert len(raw) == 2 * len(autotune.MEASURED_OPS)
    for rec in raw.values():
        assert rec["winner"] == min(rec["times_s"], key=rec["times_s"].get)
        assert all(t > 0 for t in rec["times_s"].values())
        assert rec["failed"] == {}
    assert autotune.untimed(raw, table.meta["sizes"]) == []
    for key, name in out["resolved"].items():
        assert name in engine.schedules_for(key.split("/")[0])


def _full_record(sizes):
    """A record of the measured mode in which every exact registered
    schedule of every measured op was timed at every size."""
    record = {}
    for op in autotune.MEASURED_OPS:
        names = autotune.exact_schedules(op)
        for S in autotune.op_sizes(op, sizes):
            record[f"{op}/sig/{S}"] = {
                "winner": names[0], "failed": {},
                "times_s": {n: 1e-3 * (i + 1) for i, n in enumerate(names)}}
    return record


def _gate_with(monkeypatch, tmp_path, table, record):
    monkeypatch.setattr(common, "RESULTS", tmp_path / "bench")
    monkeypatch.setattr(autotune, "autotune_mesh",
                        lambda **kw: (table, record))
    return bench_run.autotune_gate(True, device="cpu",
                                   path=tmp_path / "t.json")


def _good_table(sizes):
    t = autotune.TuningTable(meta={"backend": "gloo", "device": "cpu",
                                   "sizes": list(sizes)})
    t.set("bcast", "ring[4]", [(None, "native")])
    return t


def test_autotune_gate_refuses_an_unregistered_band(monkeypatch, tmp_path):
    """The gate fails when a measured band names a schedule the registry
    does not hold, though every schedule was timed."""
    sizes = [1 << 10, 1 << 16]
    _gate_with(monkeypatch, tmp_path, _good_table(sizes),
               _full_record(sizes))
    bad = _good_table(sizes)
    bad.set("bcast", "ring[4]", [(None, "gone")])
    with pytest.raises(SystemExit):
        _gate_with(monkeypatch, tmp_path, bad, _full_record(sizes))


@pytest.mark.parametrize("fault", ["raised", "size_missing"])
def test_autotune_gate_refuses_an_untimed_schedule(fault, monkeypatch,
                                                   tmp_path, capsys):
    """The gate fails when a registered schedule raised, or a size went
    unmeasured, though every band it did get names a registered one."""
    sizes = [1 << 10, 1 << 16]
    record = _full_record(sizes)
    key = f"allreduce/sig/{1 << 16}"
    if fault == "raised":
        del record[key]["times_s"]["rs_ag"]
        record[key]["failed"]["rs_ag"] = "RuntimeError: boom"
    else:
        del record[key]
    with pytest.raises(SystemExit):
        _gate_with(monkeypatch, tmp_path, _good_table(sizes), record)
    want = ("RuntimeError: boom" if fault == "raised" else "not measured")
    assert f"UNTIMED allreduce/rs_ag@65536B: {want}" in capsys.readouterr().out


def test_autotune_mesh_records_a_failed_schedule(monkeypatch):
    """A schedule that raises on every rank lands in the record with its
    error, and out of the table's bands; the others still win."""
    from repro_torch.launch import mesh as launch_mesh

    def fake_spawn(nprocs, fn, jobs, reps, device, axes, timeout):
        return [{job: ("RuntimeError: boom" if job == ("bcast", 1024, "chain")
                       else [1e-3 * (1 + job[2].startswith("n"))] * reps)
                 for job in jobs} for _ in range(nprocs)]

    monkeypatch.setattr(launch_mesh, "spawn_mesh", fake_spawn)
    table, record = autotune.autotune_mesh(ops=("bcast",), quick=True,
                                           device="cpu", verbose=False)
    small = record["bcast/ring[4]/1024"]
    assert small["failed"] == {"chain": "RuntimeError: boom"}
    assert "chain" not in small["times_s"] and small["winner"] != "native"
    assert record["bcast/ring[4]/65536"]["failed"] == {}
    assert autotune.untimed(record, [1024, 1 << 16], ops=("bcast",)) == \
        ["bcast/chain@1024B: RuntimeError: boom"]
    assert table.entries["bcast"]["ring[4]"][-1][0] is None


def test_run_rejects_unknown_module_and_schedule():
    with pytest.raises(SystemExit, match="unknown benchmark"):
        bench_run.main(["nope"])
    with pytest.raises(engine.UnknownScheduleError):
        bench_run.main(["--schedule", "nope", "hpl"])


# ---------------------------------------------------------------------------
# the one-card section of hpl_scaling
# ---------------------------------------------------------------------------


@pytest.fixture
def one_thread():
    """One intra-op thread: HPL on the CPU is many small ops, and under six
    test workers a thread per core in every worker oversubscribes the
    cores (this test: 13.6 s alone, 1140 s in a whole run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_hpl_scaling_quick_cpu(monkeypatch, tmp_path, one_thread):
    monkeypatch.setattr(common, "RESULTS", tmp_path)
    rec = hpl_scaling.main(quick=True, device="cpu")
    assert (tmp_path / "torch_hpl_scaling.json").is_file()
    # the reference's depth on the same constants, with the broadcasts
    # priced on what each backend runs: chain on ICI_DIRECT, staged (which
    # the model prices above zero even on one rank) on HOST_STAGED
    _, ref_hw = _hw("h100_80gb")
    _, ref_axes = _axes("torus1x1")
    want = {ct: jautotune.choose_hpl_depth(
        b=hpl_scaling.B, m=1024, axes=ref_axes,
        model=jautotune.CostModel(hw=ref_hw),
        resolve=lambda op, nbytes, ax, cs, s=sched: s)
        for ct, sched in (("ici_direct", "chain"),
                          ("host_staged", "staged"))}
    assert want["ici_direct"] == 1
    for label in ("strong", "weak"):
        for ct in ("ici_direct", "host_staged"):
            eager = rec[f"{label}/{ct}/g1"]
            ahead = rec[f"{label}/{ct}/g1/lookahead"]
            assert eager["err"] < 1.0 and eager["lookahead_depth"] == 0
            assert ahead["lookahead_depth"] == want[ct] and ahead["lookahead"]
            assert ahead["gflops"] > 0 and eager["gflops"] > 0
            assert eager["schedule"] == ("staged" if ct == "host_staged"
                                         else "chain")
    assert list(rec["extrapolation"]) == list(hpl_scaling.DEVICES)
    assert all(math.isfinite(v) and v > 0
               for v in rec["extrapolation"].values())


def test_new_entry_points_without_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (lambda: hpl_scaling.main(quick=True),
                  lambda: autotune.autotune_mesh(quick=True),
                  lambda: bench_run.autotune_gate(True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
