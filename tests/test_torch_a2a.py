"""The port's ``all_to_all_tiles`` against the JAX reference, on the CPU.

A 4-rank gloo ring, spawned once for this module, runs every schedule
(``native``, ``chain``, ``staged``) on int32, float32 and complex64 tiles
for the tile-axis pairs (0, 0), (0, 1) and (1, 0); each rank's result must
equal, bit for bit, the reference's ``engine.all_to_all_tiles`` run in a
subprocess on four simulated devices (the in-process JAX stays on one
device). ``pipelined`` with 1, 3 and 7 strips must equal the monolithic
exchange bit for bit, as in ``tests/test_engine.py``; on one rank every
schedule and chunking is the identity.
"""
from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.comm import engine as jengine
from repro.compat import make_mesh, shard_map
from repro_torch.comm import collectives, engine
from repro_torch.comm.engine import CollectiveEngine, UnknownScheduleError
from repro_torch.launch.mesh import single_rank_mesh, spawn_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING = 4
SCHEDULES = ("chain", "native", "staged")
PAIRS = ((0, 0), (0, 1), (1, 0))
DTYPES = ("int32", "float32", "complex64")
SHAPE = (8, 12)  # per rank: both axes split into RING tiles
CHUNKS = (1, 3, 7)
# pipelined patterns: (payload shape, dtype, tile split, tile concat, strip
# axis). "gups" is the routed RandomAccess buffer (n_dev, C, 2) stripped
# along C; "pencil" and "unpencil" the FFT's two exchanges stripped along
# the pencil axis
PATTERNS = {"gups": ((RING, 7, 2), "int32", 0, 0, 1),
            "pencil": ((8, 1, 7), "complex64", 0, 1, 2),
            "unpencil": ((2, RING, 7), "complex64", 1, 0, 2)}


def _payload(seed, shape, dtype, rank):
    """Rank ``rank``'s block of a seeded (RING,) + shape array."""
    rng = np.random.default_rng(seed)
    full = (RING,) + tuple(shape)
    if dtype == "int32":
        return rng.integers(-2 ** 31, 2 ** 31, full).astype(np.int32)[rank]
    re = rng.standard_normal(full).astype(np.float32)
    if dtype == "float32":
        return re[rank]
    im = rng.standard_normal(full).astype(np.float32)
    return (re + 1j * im).astype(np.complex64)[rank]


def _bits(a) -> bytes:
    a = np.ascontiguousarray(np.asarray(a))
    return a.dtype.str.encode() + repr(a.shape).encode() + a.tobytes()


# ---------------------------------------------------------------------------
# the reference on four simulated devices, in a subprocess
# ---------------------------------------------------------------------------

_REFERENCE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
sys.path.insert(0, %(tests)r)
from test_torch_a2a import RING, SCHEDULES, PAIRS, DTYPES, SHAPE, _payload
from repro.comm.engine import CollectiveEngine
from repro.compat import make_mesh, shard_map

ring = make_mesh((RING,), ("x",))
out = {}
for s in SCHEDULES:
    eng = CollectiveEngine.for_mesh(ring, schedule=s)
    for sa, ca in PAIRS:
        for dt in DTYPES:
            x = np.stack([_payload(7, SHAPE, dt, r) for r in range(RING)])
            body = lambda v, sa=sa, ca=ca: eng.all_to_all_tiles(
                v[0], "x", split_axis=sa, concat_axis=ca)[None]
            fn = jax.jit(shard_map(body, mesh=ring, in_specs=(P("x"),),
                                   out_specs=P("x"), check_vma=False))
            out["%%s/%%d%%d/%%s" %% (s, sa, ca, dt)] = np.asarray(
                fn(jnp.asarray(x)))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("a2a_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    script = _REFERENCE % {"tests": os.path.join(REPO, "tests")}
    proc = subprocess.run([sys.executable, "-c", script, str(path)],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


# ---------------------------------------------------------------------------
# a 4-rank gloo ring
# ---------------------------------------------------------------------------


def _ring_world(mesh):
    rank = mesh.index("x")
    out = {}
    for s in SCHEDULES:
        eng = CollectiveEngine.for_mesh(mesh, schedule=s)
        for sa, ca in PAIRS:
            for dt in DTYPES:
                x = torch.from_numpy(_payload(7, SHAPE, dt, rank))
                got = eng.all_to_all_tiles(x, "x", split_axis=sa,
                                           concat_axis=ca)
                out["a2a", s, sa, ca, dt] = got.numpy()
        for name, (shape, dt, ts, tc, strip) in PATTERNS.items():
            x = torch.from_numpy(_payload(11, shape, dt, rank))
            mono = eng.all_to_all_tiles(x, "x", split_axis=ts,
                                        concat_axis=tc)
            for k in CHUNKS:
                got = eng.pipelined("all_to_all_tiles", x, "x", nchunks=k,
                                    split_axis=strip, tile_split_axis=ts,
                                    tile_concat_axis=tc)
                out["pipe", s, name, k] = (got.numpy(), mono.numpy())
        try:
            eng.all_to_all_tiles(torch.zeros(6, 4), "x", split_axis=0,
                                 concat_axis=1)
            out["indivisible", s] = None
        except ValueError as e:
            out["indivisible", s] = str(e)
    x = torch.from_numpy(_payload(7, SHAPE, "float32", rank))
    out["compat"] = collectives.all_to_all_tiles(
        x, "x", split_axis=0, concat_axis=1, schedule="chain",
        mesh=mesh).numpy()
    return out


@pytest.fixture(scope="module")
def ring_results():
    return spawn_mesh(RING, _ring_world, axes=("x",), timeout=240)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}to{p[1]}")
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_a2a_equals_reference(ring_results, reference, schedule, pair,
                              dtype):
    """Every rank's tiles, bit for bit the reference's on four devices."""
    sa, ca = pair
    want = reference[f"{schedule}/{sa}{ca}/{dtype}"]
    for rank, res in enumerate(ring_results):
        assert _bits(res["a2a", schedule, sa, ca, dtype]) == \
            _bits(want[rank])


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}to{p[1]}")
def test_a2a_semantics(ring_results, pair):
    """Tile j of rank i lands on rank j, in source order on concat_axis;
    the exchange with its axes swapped is its inverse."""
    sa, ca = pair
    xs = [_payload(7, SHAPE, "int32", r) for r in range(RING)]
    for rank, res in enumerate(ring_results):
        tiles = [np.split(x, RING, axis=sa)[rank] for x in xs]
        want = np.concatenate(tiles, axis=ca)
        for s in SCHEDULES:
            assert _bits(res["a2a", s, sa, ca, "int32"]) == _bits(want)


@pytest.mark.parametrize("nchunks", CHUNKS)
@pytest.mark.parametrize("pattern", list(PATTERNS))
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_pipelined_a2a_equals_monolithic(ring_results, schedule, pattern,
                                         nchunks):
    """tests/test_engine.py: every chunking bit-identical to the monolithic
    exchange (the strip axis rides through untouched)."""
    for res in ring_results:
        got, mono = res["pipe", schedule, pattern, nchunks]
        assert _bits(got) == _bits(mono)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_a2a_rejects_indivisible_split(ring_results, schedule):
    for res in ring_results:
        assert "does not split into 4 tiles" in res["indivisible", schedule]


def test_collectives_a2a_on_ring(ring_results, reference):
    want = reference["chain/01/float32"]
    for rank, res in enumerate(ring_results):
        assert _bits(res["compat"]) == _bits(want[rank])


# ---------------------------------------------------------------------------
# one rank, in process
# ---------------------------------------------------------------------------


def test_a2a_schedules_equal_reference():
    assert engine.schedules_for("all_to_all_tiles") == \
        jengine.schedules_for("all_to_all_tiles") == SCHEDULES
    eng = CollectiveEngine.for_mesh(single_rank_mesh(("x",)))
    assert eng.schedule_for("all_to_all_tiles") == "native"
    with pytest.raises(UnknownScheduleError):
        eng.all_to_all_tiles(torch.zeros(4), "x", split_axis=0,
                             concat_axis=0, schedule="rs_ag")


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_a2a_single_rank_identity(schedule):
    eng = CollectiveEngine.for_mesh(single_rank_mesh(("x",)),
                                    schedule=schedule)
    x = torch.arange(24.0).reshape(2, 3, 4)
    for sa in range(3):
        for ca in range(3):
            assert eng.all_to_all_tiles(x, "x", split_axis=sa,
                                        concat_axis=ca) is x


@pytest.mark.parametrize("nchunks", [1, 2, 3, 64, "auto"])
def test_pipelined_a2a_single_rank_identity(nchunks):
    """tests/test_engine.py:149-160, against the reference on one device."""
    mesh = make_mesh((1,), ("x",))
    jeng = jengine.CollectiveEngine.for_mesh(mesh)
    x = np.random.default_rng(3).standard_normal((1, 2, 6, 4)) \
        .astype(np.float32)

    def body(v):
        return jeng.pipelined("all_to_all_tiles", v[0], "x", nchunks=nchunks,
                              split_axis=2, tile_split_axis=1,
                              tile_concat_axis=0)[None]

    fn = jax.jit(shard_map(body, mesh=mesh,
                           in_specs=(P("x", None, None, None),),
                           out_specs=P("x", None, None, None),
                           check_vma=False))
    want = np.asarray(fn(jnp.asarray(x)))[0]
    eng = CollectiveEngine.for_mesh(single_rank_mesh(("x",)))
    got = eng.pipelined("all_to_all_tiles", torch.from_numpy(x[0]), "x",
                        nchunks=nchunks, split_axis=2, tile_split_axis=1,
                        tile_concat_axis=0)
    assert _bits(got.numpy()) == _bits(want) == _bits(x[0])


@pytest.mark.parametrize("bad", [0, 1])
def test_pipelined_a2a_rejects_strip_on_tile_axis(bad):
    """The strip axis must be a third axis: slicing along a tile axis would
    change the tiles the exchange moves."""
    eng = CollectiveEngine.for_mesh(single_rank_mesh(("x",)))
    with pytest.raises(ValueError, match="tile axis"):
        eng.pipelined("all_to_all_tiles", torch.zeros(4, 4, 4), "x",
                      nchunks=2, split_axis=bad, tile_split_axis=0,
                      tile_concat_axis=1)


def test_pipelined_a2a_requires_tile_axes():
    eng = CollectiveEngine.for_mesh(single_rank_mesh(("x",)))
    with pytest.raises(ValueError, match="tile_concat_axis"):
        eng.pipelined("all_to_all_tiles", torch.zeros(4, 4, 4), "x",
                      nchunks=2, split_axis=2, tile_split_axis=0)
