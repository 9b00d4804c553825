"""The port's FFT against the JAX reference, on the CPU.

The local transform is held against ``jnp.fft.fft`` on the same numpy
signals within ``RTOL`` and ``ATOL_SCALE * max|ref|``: both are float32
FFTs (pocketfft and XLA's), so they agree to float32 rounding but not in
the last bits. The pencil FFT on a 4-rank gloo ring (spawned once for this
module) must equal ``torch.fft.fft`` at the per-rank block shape
``(B/4, n)`` bit for bit on every schedule and chunking, the reference's
own claim with torch in place of XLA.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import autotune as jautotune
from repro.comm import topology as jtopology
from repro.comm import types as jtypes
from repro_torch.comm.engine import CollectiveEngine
from repro_torch.comm.types import H100_80GB
from repro_torch.core import fft as FFT
from repro_torch.launch.mesh import single_rank_mesh, spawn_mesh

RING = 4
SCHEDULES = ("chain", "native", "staged")
CHUNKS = (1, 3)
RTOL = 1e-5        # float32 FFT rounding, relative to each element
ATOL_SCALE = 1e-5  # times max|ref|: the run_fft error gate's limit
BATCH, LOG_N = 8, 6  # the ring's signals: (8, 64), pencils of 16


def _signals(seed, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape, dtype=np.float32)
            + 1j * rng.standard_normal(shape, dtype=np.float32)) \
        .astype(np.complex64)


def _bits(a) -> bytes:
    a = np.ascontiguousarray(np.asarray(a))
    return a.dtype.str.encode() + repr(a.shape).encode() + a.tobytes()


def _block_reference(x: np.ndarray, index: int) -> np.ndarray:
    """What the pencil FFT must return on axis index ``index``:
    ``torch.fft.fft`` of each rank's (B/4, n) block of whole signals, at
    that shape, this rank's pencil of columns."""
    ns = x.shape[1] // RING
    blocks = [torch.fft.fft(torch.from_numpy(b.copy()), dim=-1).numpy()
              for b in np.split(x, RING, axis=0)]
    return np.concatenate(blocks)[:, index * ns:(index + 1) * ns]


def _reference_choice(nbytes: int, callsite: str) -> str:
    """What the reference's cost model resolves ``all_to_all_tiles`` to on
    a 1-rank ring, priced on the port's hardware constants."""
    model = jautotune.CostModel(
        hw=jtypes.HardwareModel(**dataclasses.asdict(H100_80GB)))
    return model.choose("all_to_all_tiles", nbytes,
                        (jtopology.AxisTopology("x", 1, "ring"),),
                        callsite=callsite)


# ---------------------------------------------------------------------------
# one rank, in process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 16), (8, 256), (4, 1024), (3, 12)],
                         ids=str)
def test_local_fft_matches_jax(shape):
    x = _signals(1, shape)
    got = FFT.fft_local(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.fft.fft(jnp.asarray(x), axis=-1))
    assert got.dtype == want.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_SCALE * np.abs(want).max())


@pytest.mark.parametrize("entry", ["fft", "fft_dist"])
def test_run_single_rank_cpu(entry):
    fn = {"fft": FFT.run_fft, "fft_dist": FFT.run_fft_dist}[entry]
    res = fn(log_size=8, batch_per_device=4, reps=1, device="cpu")
    assert res.error < 1e-5
    assert res.details["batch"] == 4 and res.details["device"] == "cpu"
    assert res.metric > 0
    if entry == "fft_dist":
        # the cost model's pick on a 1-rank ring, as the reference's model
        # makes it on the same constants
        assert res.details["schedule"] == _reference_choice(
            4 * 256 * 8, "fft.transpose") == "chain"
        assert res.details["exchange_bytes"] == 4 * 256 * 8


@pytest.mark.parametrize("nchunks", [1, 3])
def test_dist_step_single_rank_equals_local(nchunks):
    """On one rank both exchanges are the identity: the pencil step is the
    local transform, bit for bit."""
    x = torch.from_numpy(_signals(2, (6, 128)))
    eng = CollectiveEngine.for_mesh(single_rank_mesh(("x",)))
    got = FFT.make_dist_step(eng, nchunks=nchunks)(x)
    assert _bits(got.numpy()) == _bits(FFT.fft_local(x).numpy())


def test_error_covers_full_output():
    """A fault in the last element of the last row shows in ``error``
    (the reference once checked only the first two rows)."""
    ax = single_rank_mesh(("x",)).axis("x")
    x = torch.from_numpy(_signals(3, (8, 64)))
    out = FFT.fft_local(x)
    assert FFT._error(out, x, slice(None), ax) < 1e-6
    out[-1, -1] += 1.0
    assert FFT._error(out, x, slice(None), ax) > 1e-3


def test_make_signals_seeded():
    a = FFT.make_signals(4, 32, device="cpu")
    b = FFT.make_signals(4, 32, device="cpu")
    assert a.dtype == torch.complex64 and a.shape == (4, 32)
    assert torch.equal(a, b)
    assert not torch.equal(a.real, a.imag)


# ---------------------------------------------------------------------------
# a 4-rank gloo ring
# ---------------------------------------------------------------------------


def _ring_world(mesh):
    rank = mesh.index("x")
    ns = (1 << LOG_N) // RING
    x = _signals(4, (BATCH, 1 << LOG_N))
    x_loc = torch.from_numpy(x[:, rank * ns:(rank + 1) * ns].copy())
    out = {}
    for s in SCHEDULES:
        eng = CollectiveEngine.for_mesh(mesh, schedule=s)
        for k in CHUNKS:
            out["pencil", s, k] = FFT.make_dist_step(eng, nchunks=k)(
                x_loc).numpy()
            res = FFT.run_fft_dist(mesh, log_size=LOG_N, batch_per_device=2,
                                   reps=1, schedule=s, nchunks=k,
                                   device="cpu")
            out["dist_err", s, k] = (res.error, res.details["schedule"],
                                     res.details["nchunks"])
    res = FFT.run_fft(mesh, log_size=LOG_N, batch_per_device=2, reps=1,
                      device="cpu")
    out["local"] = (res.error, res.details["batch"])
    # a fault on the last rank only must show in every rank's error
    eng = CollectiveEngine.for_mesh(mesh)
    spec = FFT.make_dist_step(eng)(x_loc)
    if rank == RING - 1:
        spec[-1, -1] += 1.0
    out["fault_err"] = FFT._error(spec, torch.from_numpy(x),
                                  slice(rank * ns, (rank + 1) * ns),
                                  mesh.axis("x"))
    try:
        FFT.run_fft_dist(mesh, log_size=1, device="cpu")
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


@pytest.fixture(scope="module")
def ring_results():
    return spawn_mesh(RING, _ring_world, axes=("x",), timeout=240)


@pytest.mark.parametrize("nchunks", CHUNKS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_pencil_fft_bitwise_at_block_shape(ring_results, schedule, nchunks):
    x = _signals(4, (BATCH, 1 << LOG_N))
    for rank, res in enumerate(ring_results):
        assert _bits(res["pencil", schedule, nchunks]) == \
            _bits(_block_reference(x, rank))


@pytest.mark.parametrize("nchunks", CHUNKS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_run_fft_dist_on_ring(ring_results, schedule, nchunks):
    for res in ring_results:
        err, resolved, k = res["dist_err", schedule, nchunks]
        assert err < 1e-5 and (resolved, k) == (schedule, nchunks)


def test_run_fft_on_ring(ring_results):
    for res in ring_results:
        err, batch = res["local"]
        assert err < 1e-5 and batch == 2 * RING


def test_error_covers_every_rank(ring_results):
    for res in ring_results:
        assert res["fault_err"] > 1e-3


def test_fft_dist_rejects_indivisible_signal(ring_results):
    for res in ring_results:
        assert "not divisible by 4 devices" in res["indivisible"]
