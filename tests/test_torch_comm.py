"""The port's communication layer against the JAX reference.

Tags, topology helpers and the schedule-resolution rules are compared with
``repro.comm`` directly. The bcast schedules run on a 4-rank ring of gloo
processes on the CPU, spawned once for this module; as in
``tests/dist/test_schedules.py`` the payloads are small integers in fp32 and
every schedule only moves bytes, so every schedule must deliver the
source's tensor bit for bit, for every source and a ragged payload.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.comm import callsites as jcs
from repro.comm import engine as jengine
from repro.comm import topology as jtopo
from repro_torch.comm import callsites, engine, topology
from repro_torch.comm.engine import CollectiveEngine, UnknownScheduleError
from repro_torch.comm.types import CommunicationType as CT
from repro_torch.launch.mesh import single_rank_mesh, spawn_mesh

BCAST = ("chain", "chain_rooted", "native", "ring2d", "staged")
RING = 4
SRCS = (0, 1, 3)


# ---------------------------------------------------------------------------
# tags and topology, against the reference
# ---------------------------------------------------------------------------


def test_callsite_tags_equal_reference():
    assert callsites.CALLSITES.keys() == jcs.CALLSITES.keys()
    for tag, cs in callsites.CALLSITES.items():
        ref = jcs.CALLSITES[tag]
        assert (cs.op, cs.module, cs.const, cs.tuned) == \
            (ref.op, ref.module, ref.const, ref.tuned)
        assert getattr(callsites, cs.const) == getattr(jcs, ref.const) == tag


@pytest.mark.parametrize("size", [1, 2, 3, 4, 8])
def test_ring_and_torus_permutations_equal_reference(size):
    for shift in (-1, 1, 2):
        assert topology.ring_perm(size, shift) == jtopo.ring_perm(size, shift)
    assert topology.transpose_perm(size) == jtopo.transpose_perm(size)
    assert topology.torus_neighbors(size, 3) == jtopo.torus_neighbors(size, 3)
    for i, j in ((0, 0), (5, 7), (3, 1)):
        assert topology.pq_owner(i, j, size, size) == \
            jtopo.pq_owner(i, j, size, size)


@pytest.mark.parametrize("n", range(1, 21))
def test_grid_from_devices_equals_reference(n):
    assert topology.grid_from_devices(n) == jtopo.grid_from_devices(n)
    try:
        want = jtopo.grid_from_devices(n, square=True)
    except ValueError:
        with pytest.raises(ValueError, match="square grid"):
            topology.grid_from_devices(n, square=True)
    else:
        assert topology.grid_from_devices(n, square=True) == want


@pytest.mark.parametrize("kind", ["ring", "torus_row", "torus_col", "staging"])
@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_axis_links_equal_reference(kind, size):
    ax = topology.AxisTopology("x", size, kind)
    ref = jtopo.AxisTopology("x", size, kind)
    assert ax.links() == ref.links() and ax.n_links == ref.n_links
    assert ax.wraparound == ref.wraparound
    assert [ax.canonical_hop(h) for h in range(size)] == \
        [ref.canonical_hop(h) for h in range(size)]


def test_mesh_topology_equals_reference():
    class _Shape:  # anything with a ``shape`` mapping, as both accept
        shape = {"pod": 2, "rows": 2, "cols": 2, "x": 3}

    port = topology.MeshTopology.from_mesh(_Shape())
    ref = jtopo.MeshTopology.from_mesh(_Shape())
    assert port.describe() == ref.describe()
    assert port.size(("rows", "cols")) == ref.size(("rows", "cols")) == 4
    with pytest.raises(KeyError):
        port.axis("nope")


# ---------------------------------------------------------------------------
# schedule resolution (reference engine.py:643-686)
# ---------------------------------------------------------------------------


def test_bcast_schedules_equal_reference():
    assert engine.schedules_for("bcast") == jengine.schedules_for("bcast") \
        == BCAST


def test_schedule_for_rules():
    mesh = single_rank_mesh()
    eng = CollectiveEngine.for_mesh(mesh)
    # auto resolves to the static default until the cost model is ported
    assert eng.schedule_for("bcast") == "chain"
    assert eng.schedule_for("bcast", nbytes=4096, axis="rows",
                            callsite=callsites.HPL_PANEL) == "chain"
    # an explicit override must be registered for the op
    assert eng.schedule_for("bcast", "ring2d") == "ring2d"
    with pytest.raises(UnknownScheduleError):
        eng.schedule_for("bcast", "rs_ag")
    # HOST_STAGED forces staged, but a typo'd override still fails first
    staged = CollectiveEngine.for_mesh(mesh, CT.HOST_STAGED, "chain")
    assert staged.schedule_for("bcast") == "staged"
    assert staged.schedule_for("bcast", "native") == "staged"
    with pytest.raises(UnknownScheduleError):
        staged.schedule_for("bcast", "nope")
    # the engine-wide name
    assert CollectiveEngine.for_mesh(mesh, schedule="native") \
        .schedule_for("bcast") == "native"
    with pytest.raises(UnknownScheduleError):
        CollectiveEngine.for_mesh(mesh, schedule="nope")
    with pytest.raises(ValueError):
        eng.schedule_for("gather")
    assert engine.known_schedules() == \
        ("auto", "chain", "chain_rooted", "direct", "int8_ef", "native",
         "ring2d", "rs_ag", "staged")


@pytest.mark.parametrize("op", ["all_to_all_tiles"])
def test_unported_ops_name_their_roadmap_item(op):
    """The last op that was unported (ROADMAP A10) is ported: on the 1x1
    mesh every schedule is the identity, and auto resolves to the
    reference's static default."""
    eng = CollectiveEngine.for_mesh(single_rank_mesh())
    x = torch.arange(8.0).reshape(2, 4)
    for schedule in engine.schedules_for(op):
        assert getattr(eng, op)(x, "rows", split_axis=0, concat_axis=1,
                                schedule=schedule) is x
    assert eng.schedule_for(op) == "native"


@pytest.mark.parametrize("op", ["ring_exchange", "grid_transpose",
                                "allreduce"])
def test_ported_exchanges_on_single_rank_are_identity(op):
    """On the 1x1 mesh (and the size-1 ring) every schedule of the two
    exchanges and of the allreduce returns its input and touches no process
    group."""
    x, y = torch.arange(12.0).reshape(3, 4), torch.arange(5.0)
    for schedule in engine.schedules_for(op):
        if op == "allreduce":
            for mesh, axis in ((single_rank_mesh(("x",)), "x"),
                               (single_rank_mesh(), ("rows", "cols"))):
                eng = CollectiveEngine.for_mesh(mesh, schedule=schedule)
                assert eng.allreduce(x, axis) is x
                tree = eng.allreduce_tree({"w": x, "b": y}, axis,
                                          bucket_bytes=16)
                assert torch.equal(tree["w"], x) and torch.equal(tree["b"], y)
        elif op == "ring_exchange":
            eng = CollectiveEngine.for_mesh(single_rank_mesh(("x",)),
                                            schedule=schedule)
            got = eng.ring_exchange(x, y, "x")
            assert torch.equal(got[0], x) and torch.equal(got[1], y)
        else:
            eng = CollectiveEngine.for_mesh(single_rank_mesh(),
                                            schedule=schedule)
            assert torch.equal(eng.grid_transpose(x, ("rows", "cols"), 1), x)
            with pytest.raises(ValueError, match="not 2x2"):
                eng.grid_transpose(x, ("rows", "cols"), 2)
        assert eng.schedule_for(op) == schedule


@pytest.mark.parametrize("schedule", BCAST)
def test_bcast_on_single_rank_is_identity(schedule):
    eng = CollectiveEngine.for_mesh(single_rank_mesh(), schedule=schedule)
    x = torch.arange(12.0).reshape(3, 4)
    for axis in ("rows", "cols"):
        assert torch.equal(eng.bcast(x, axis, 0), x)
    with pytest.raises(KeyError):
        eng.bcast(x, "x", 0)


# ---------------------------------------------------------------------------
# bcast over a 4-rank gloo ring
# ---------------------------------------------------------------------------


def _ints(shape, seed=0):
    return np.random.default_rng(seed).integers(-8, 8, shape).astype(np.float32)


def _ring_world(mesh):
    """Runs on every rank: each schedule x source, plus a ragged payload."""
    rank = mesh.index("x")
    x = torch.from_numpy(_ints((RING, 4, 128))[rank])
    ragged = torch.from_numpy(_ints((RING, 3, 5), seed=9)[rank])
    out = {}
    for schedule in BCAST:
        eng = CollectiveEngine.for_mesh(mesh, schedule=schedule)
        for src in SRCS:
            out[(schedule, src)] = eng.bcast(x, "x", src).numpy()
        out[(schedule, "ragged")] = eng.bcast(ragged, "x", 2).numpy()
    return out


@pytest.fixture(scope="module")
def ring_results():
    return spawn_mesh(RING, _ring_world, axes=("x",), timeout=180)


@pytest.mark.parametrize("schedule", BCAST)
@pytest.mark.parametrize("src", SRCS)
def test_bcast_schedules_identical_on_gloo_ring(ring_results, schedule, src):
    x = _ints((RING, 4, 128))
    for rank in range(RING):
        got = ring_results[rank][(schedule, src)]
        assert got.tobytes() == x[src].tobytes()
        assert got.tobytes() == ring_results[rank][("chain", src)].tobytes()


@pytest.mark.parametrize("schedule", BCAST)
def test_bcast_ragged_payload_on_gloo_ring(ring_results, schedule):
    """ring2d pads internally: a payload size not divisible by n."""
    x = _ints((RING, 3, 5), seed=9)
    for rank in range(RING):
        got = ring_results[rank][(schedule, "ragged")]
        assert got.shape == (3, 5) and got.tobytes() == x[2].tobytes()
