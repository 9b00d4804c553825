"""The port's b_eff against the JAX reference, on the CPU.

On a 4-rank ring of gloo processes, spawned once for this module, every
``ring_exchange`` schedule delivers the left neighbour's forward buffer and
the right neighbour's backward buffer bit for bit, for byte, fp32 and
ragged payloads, and ``run_beff`` passes the paper's byte-pattern check.
The models of Eqs. 1-4 equal the reference's, with the paper's 520N
passed to both.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.comm import types as jtypes
from repro.core import models as jmodels
from repro_torch.comm.engine import CollectiveEngine
from repro_torch.comm.types import BITTWARE_520N
from repro_torch.comm.types import CommunicationType as CT
from repro_torch.core import models
from repro_torch.core.beff import run_beff
from repro_torch.launch.mesh import spawn_mesh

RING = 4
EXCHANGE = ("direct", "chain", "staged")
PAYLOADS = {"uint8": ((100,), np.uint8), "fp32": ((4, 128), np.float32),
            "ragged": ((3, 5), np.float32)}


def _payload(kind, direction):
    """Every rank's (fwd or bwd) buffer of one payload kind, stacked."""
    shape, dtype = PAYLOADS[kind]
    seed = list(PAYLOADS).index(kind) * 2 + (direction == "bwd")
    rng = np.random.default_rng(seed)
    return rng.integers(0, 120, (RING,) + shape).astype(dtype)


def _ring_world(mesh):
    rank = mesh.index("x")
    out = {}
    for schedule in EXCHANGE:
        eng = CollectiveEngine.for_mesh(mesh, schedule=schedule)
        for kind in PAYLOADS:
            fwd = torch.from_numpy(_payload(kind, "fwd")[rank])
            bwd = torch.from_numpy(_payload(kind, "bwd")[rank])
            recv_l, recv_r = eng.ring_exchange(fwd, bwd, "x")
            out[schedule, kind] = (recv_l.numpy(), recv_r.numpy())
        res = run_beff(mesh, max_log=8, reps=1, rounds=2, schedule=schedule,
                       device="cpu")
        out["beff", schedule] = (res.error, res.details["schedule"],
                                 res.details["ranks"])
    res = run_beff(mesh, CT.HOST_STAGED, max_log=4, reps=1, device="cpu")
    out["beff", "host_staged"] = (res.error, res.details["schedule"],
                                  res.details["ranks"])
    return out


@pytest.fixture(scope="module")
def ring_results():
    return spawn_mesh(RING, _ring_world, axes=("x",), timeout=180)


@pytest.mark.parametrize("schedule", EXCHANGE)
@pytest.mark.parametrize("kind", list(PAYLOADS))
def test_ring_exchange_delivers_neighbours(ring_results, schedule, kind):
    fwd, bwd = _payload(kind, "fwd"), _payload(kind, "bwd")
    for rank in range(RING):
        recv_l, recv_r = ring_results[rank][schedule, kind]
        assert recv_l.dtype == fwd.dtype and recv_l.shape == fwd.shape[1:]
        assert recv_l.tobytes() == fwd[(rank - 1) % RING].tobytes()
        assert recv_r.tobytes() == bwd[(rank + 1) % RING].tobytes()


@pytest.mark.parametrize("schedule", EXCHANGE + ("host_staged",))
def test_run_beff_on_ring(ring_results, schedule):
    want = "staged" if schedule == "host_staged" else schedule
    for rank in range(RING):
        assert ring_results[rank]["beff", schedule] == (0.0, want, RING)


def test_run_beff_single_rank():
    res = run_beff(max_log=8, reps=1, device="cpu")
    assert res.error == 0.0 and res.metric > 0
    assert res.details["ranks"] == 1 and res.details["schedule"] == "direct"
    assert res.details["buffer_device"] == "cpu"
    assert sorted(res.details["bandwidth_by_size"]) == [2 ** i
                                                        for i in range(9)]


def test_beff_models_equal_reference():
    bw = {1: 1.0e6, 2: 2.5e6, 1024: 3.0e9}
    assert models.effective_bandwidth(bw) == jmodels.effective_bandwidth(bw)
    for L in (1, 64, 65, 4096, 1 << 20):
        assert models.beff_csn_model_520n(L) == jmodels.beff_csn_model_520n(L)
        assert models.beff_csn_model_520n(L, 1) == \
            jmodels.beff_csn_model_520n(L, 1)
        assert models.beff_host_staged_model(L, BITTWARE_520N) == \
            jmodels.beff_host_staged_model(L, jtypes.BITTWARE_520N)
        assert models.beff_ici_model(L, BITTWARE_520N) == \
            jmodels.beff_ici_model(L, jtypes.BITTWARE_520N)
