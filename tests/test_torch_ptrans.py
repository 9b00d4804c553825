"""The port's PTRANS against the JAX reference, on the CPU.

``transpose_add``'s plain version is held bit for bit against the
reference's Pallas kernel in interpret mode (one fp32 addition per element
on both sides). ``run_ptrans`` on the 1x1 grid gives the reference's C bit
for bit. On a 2x2 torus of gloo processes, spawned once for this module,
every ``grid_transpose`` schedule delivers the movement the reference's
``transpose_perm(2)`` defines, every chunking of ``pipelined`` equals the
monolithic exchange, and PTRANS under each schedule and chunking gives the
1x1 result bit for bit.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import engine as jengine
from repro.comm import topology as jtopo
from repro.comm import types as jtypes
from repro.compat import make_mesh
from repro.core import models as jmodels
from repro.core import ptrans as jptrans
from repro.kernels import ops as jops
from repro_torch.comm import engine
from repro_torch.comm.engine import CollectiveEngine
from repro_torch.comm.types import BITTWARE_520N
from repro_torch.comm.types import CommunicationType as CT
from repro_torch.core import models, ptrans
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import single_rank_mesh, spawn_mesh

GRID = ("direct", "chain", "staged", "ring2d")
CHUNKS = (1, 2, 3, "auto")
PG, N, B = 2, 128, 32
AXES = ("rows", "cols")


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _ints(shape, seed=0):
    return np.random.default_rng(seed).integers(-8, 8, shape).astype(np.float32)


# ---------------------------------------------------------------------------
# transpose_add's plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n", [(64, 64), (128, 128), (96, 160), (176, 112),
                                 (13, 17)])
def test_transpose_add_bitwise_fp32(m, n):
    """Square, non-square and coprime shapes (the reference falls to 1x1
    tiles on the last; the port has no tile constraint)."""
    a, b = _normal(1, (m, n)), _normal(2, (n, m))
    want = np.asarray(jops.transpose_add(jnp.asarray(a), jnp.asarray(b)))
    got = ops.transpose_add(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (n, m) and got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()
    assert torch.equal(ref.transpose_add(torch.from_numpy(a),
                                         torch.from_numpy(b)), got)


@pytest.mark.parametrize("m,n", [(64, 64), (96, 160)])
def test_transpose_add_bf16(m, n):
    a, b = _normal(3, (m, n)), _normal(4, (n, m))
    want = jops.transpose_add(jnp.asarray(a, jnp.bfloat16),
                              jnp.asarray(b, jnp.bfloat16))
    got = ops.transpose_add(torch.from_numpy(a).bfloat16(),
                            torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-6)


def test_transpose_add_takes_strided_column_strips():
    """PTRANS's pipelined path passes a column strip of B as a view."""
    b = torch.from_numpy(_normal(5, (64, 96)))
    a = torch.from_numpy(_normal(6, (32, 64)))
    strip = b[:, 16:48]
    assert not strip.is_contiguous()
    assert torch.equal(ops.transpose_add(a, strip),
                       ops.transpose_add(a, strip.contiguous()))


# ---------------------------------------------------------------------------
# registry, models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["grid_transpose", "ring_exchange"])
def test_schedules_equal_reference(op):
    assert engine.schedules_for(op) == jengine.schedules_for(op)


def test_ptrans_models_equal_reference():
    for b in (32, 64, 128, 512):
        for staged in (False, True):
            assert models.ptrans_block_time(b, 4, BITTWARE_520N, staged) == \
                jmodels.ptrans_block_time(b, 4, jtypes.BITTWARE_520N, staged)
    for bw in (5e9, 1.2e11):
        assert models.ptrans_required_hbm_bw(bw) == \
            jmodels.ptrans_required_hbm_bw(bw)
    with pytest.raises(TypeError):
        models.ptrans_block_time(64, 4)  # no default hardware: no TPU


# ---------------------------------------------------------------------------
# run_ptrans on the 1x1 grid against the reference
# ---------------------------------------------------------------------------


def _port_c(n, b, nchunks=1, mesh=None, pg=1, schedule="auto"):
    mesh = mesh or single_rank_mesh()
    _, _, a_loc, b_loc = ptrans.make_inputs(n, b, pg, "cpu")
    eng = CollectiveEngine.for_mesh(mesh, schedule=schedule)
    out = ptrans.make_step(mesh, pg, eng, nchunks=nchunks)(a_loc, b_loc)
    return ptrans.undistribute_cyclic(ptrans.to_reference(out), pg, b)


@pytest.mark.parametrize("nchunks", [1, 3])
def test_run_ptrans_1x1_equals_reference(nchunks):
    n, b = 256, 64
    mesh = make_mesh((1, 1), AXES)
    want_res = jptrans.run_ptrans(mesh, n=n, b=b, reps=1, nchunks=nchunks)
    res = ptrans.run_ptrans(n=n, b=b, reps=1, nchunks=nchunks, device="cpu")
    assert res.error == want_res.error == 0.0
    assert set(res.details) == set(want_res.details) | {"device", "launches"}
    for key in ("n", "block", "grid", "comm", "schedule", "nchunks",
                "nchunks_requested", "exchange_bytes", "bytes_exchanged"):
        assert res.details[key] == want_res.details[key], key
    assert res.details["launches"] == {k: 0 for k in ops.KERNELS}

    a, bm, _, _ = ptrans.make_inputs(n, b, 1, "cpu")
    eng = jengine.CollectiveEngine.for_mesh(mesh)
    step = jptrans.make_step(mesh, 1, eng, True, nchunks=nchunks)
    want = np.asarray(step(jptrans.distribute_cyclic(a, 1, b),
                           jptrans.distribute_cyclic(bm, 1, b)))
    got = _port_c(n, b, nchunks)
    assert got.tobytes() == want[0].tobytes()
    assert got.tobytes() == (bm + a.T).tobytes()


def test_make_inputs_match_reference_generator():
    a, bm, a_loc, b_loc = ptrans.make_inputs(128, 32, 1, "cpu")
    rng = np.random.default_rng(42)
    assert a.tobytes() == rng.standard_normal((128, 128),
                                              dtype=np.float32).tobytes()
    assert bm.tobytes() == rng.standard_normal((128, 128),
                                               dtype=np.float32).tobytes()
    assert a_loc.numpy().tobytes() == a.tobytes()
    with pytest.raises(ValueError, match="do not tile"):
        ptrans.make_inputs(100, 32, 1, "cpu")


# ---------------------------------------------------------------------------
# a 2x2 torus of gloo processes
# ---------------------------------------------------------------------------


def _torus_world(mesh):
    """Runs on every rank: the exchange under every schedule, pipelined
    chunkings, and PTRANS under each schedule and chunking."""
    rank = mesh.rank
    x = torch.from_numpy(_ints((PG * PG, 6, 8))[rank])
    out = {"coords": (mesh.index("rows"), mesh.index("cols"))}
    for schedule in GRID:
        eng = CollectiveEngine.for_mesh(mesh, schedule=schedule)
        mono = eng.grid_transpose(x, AXES, PG)
        out["move", schedule] = mono.numpy()
        for k in CHUNKS:
            # consume reorients the strip, as PTRANS's transpose-add does
            piped = eng.pipelined("grid_transpose", x, AXES, pg=PG,
                                  nchunks=k, split_axis=0, concat_axis=1,
                                  consume=lambda s, start: s.T.contiguous())
            out["pipe", schedule, k] = piped.numpy()
        out["mono_t", schedule] = mono.T.contiguous().numpy()
        for k in (1, 3):
            res = ptrans.run_ptrans(mesh, n=N, b=B, reps=1,
                                    schedule=schedule, nchunks=k,
                                    device="cpu")
            c = _port_c(N, B, k, mesh, PG, schedule)
            out["ptrans", schedule, k] = (res.error, res.details["schedule"],
                                          res.details["nchunks"], c)
    res = ptrans.run_ptrans(mesh, CT.HOST_STAGED, n=N, b=B, reps=1,
                            schedule="direct", device="cpu")
    out["host_staged"] = (res.error, res.details["schedule"])
    return out


@pytest.fixture(scope="module")
def torus_results():
    return spawn_mesh(PG * PG, _torus_world, timeout=240)


def test_torus_layout(torus_results):
    for rank, res in enumerate(torus_results):
        assert res["coords"] == divmod(rank, PG)


@pytest.mark.parametrize("schedule", GRID)
def test_grid_transpose_moves_as_transpose_perm(torus_results, schedule):
    x = _ints((PG * PG, 6, 8))
    for src, dst in jtopo.transpose_perm(PG):
        got = torus_results[dst]["move", schedule]
        assert got.tobytes() == x[src].tobytes(), (src, dst)


@pytest.mark.parametrize("schedule", GRID)
@pytest.mark.parametrize("nchunks", CHUNKS)
def test_pipelined_grid_transpose_equals_monolithic(torus_results, schedule,
                                                    nchunks):
    for res in torus_results:
        assert res["pipe", schedule, nchunks].tobytes() == \
            res["mono_t", schedule].tobytes()


@pytest.mark.parametrize("schedule", GRID)
@pytest.mark.parametrize("nchunks", [1, 3])
def test_torus_ptrans_equals_1x1(torus_results, schedule, nchunks):
    one = _port_c(N, B)
    for res in torus_results:
        err, resolved, k, c = res["ptrans", schedule, nchunks]
        assert err == 0.0 and resolved == schedule and k == nchunks
        assert c.tobytes() == one.tobytes()


def test_torus_host_staged_resolves_to_staged(torus_results):
    for res in torus_results:
        assert res["host_staged"] == (0.0, "staged")
