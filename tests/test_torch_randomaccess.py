"""The port's RandomAccess (GUPS) against the JAX reference, on the CPU.

The xorshift stream is held against a pure-Python LCG and the reference's
``_gen_updates`` (seeds that reach the msb included), the bucket buffer
against ``_bucket_updates`` bit for bit, and the initial state against
``_make_table_and_seeds``. The drop-local and routed forward tables equal
the reference's bit for bit on one rank in process and on a 4-rank gloo
ring (spawned once for this module) against the reference run in a
subprocess on four simulated devices; the routed restore is exact for every
schedule and chunking. The benchmark scripts run at ``--quick`` size.
"""
from __future__ import annotations

import os
import subprocess
import sys

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import autotune as jautotune
from repro.comm import topology as jtopology
from repro.comm import types as jtypes
from repro.comm.engine import CollectiveEngine as JEngine
from repro.compat import make_mesh
from repro.core import randomaccess as JRA
from repro_torch.benchmarks import common, gups_fft_bench, legacy_suite
from repro_torch.comm.engine import CollectiveEngine
from repro_torch.comm.types import H100_80GB
from repro_torch.core import randomaccess as RA
from repro_torch.launch.mesh import single_rank_mesh, spawn_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING = 4
SCHEDULES = ("chain", "native", "staged")
CHUNKS = (1, 3)
SEEDS = (1, 12345, 0x7FFFFFFF, 0xDEADBEEF, 0x40000000)
# the reference tests' sizes (tests/test_gups_fft.py)
SMALL = dict(table_log=12, rngs_per_device=2, updates_per_rng=128)


def _np_xorshift_stream(seed: int, count: int) -> np.ndarray:
    """Pure-python HPCC-style LCG: x <- (x << 1) ^ (msb(x) ? 0x7 : 0)."""
    x = int(seed) & 0xFFFFFFFF
    out = np.empty(count, np.uint32)
    for i in range(count):
        x = ((x << 1) & 0xFFFFFFFF) ^ (0x7 if x >> 31 else 0)
        out[i] = x
    return out


def _i32(a) -> torch.Tensor:
    """uint32 bits as the port's int32 tensor."""
    return torch.from_numpy(np.asarray(a, np.uint32).view(np.int32).copy())


def _bits(a) -> bytes:
    a = np.ascontiguousarray(np.asarray(a))
    return a.dtype.str.encode() + repr(a.shape).encode() + a.tobytes()


def _reference_choice(nbytes: int, callsite: str) -> str:
    """What the reference's cost model resolves ``all_to_all_tiles`` to on
    a 1-rank ring, priced on the port's hardware constants."""
    model = jautotune.CostModel(
        hw=jtypes.HardwareModel(**dataclasses.asdict(H100_80GB)))
    return model.choose("all_to_all_tiles", nbytes,
                        (jtopology.AxisTopology("x", 1, "ring"),),
                        callsite=callsite)


# ---------------------------------------------------------------------------
# generator, buckets and state against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS, ids=hex)
def test_xorshift_stream_matches_reference(seed):
    got = RA.gen_updates(_i32([seed]), 64)[0].numpy().view(np.uint32)
    want = _np_xorshift_stream(seed, 64)
    ref = np.asarray(JRA._gen_updates(jnp.uint32(seed), 64))
    assert _bits(got) == _bits(want) == _bits(ref)


def test_xorshift_step_feedback_taps():
    # msb set -> the polynomial is XORed in; msb clear -> plain shift
    assert int(RA.xorshift_step(_i32([0x80000000]))[0]) == RA.POLY == \
        int(JRA.POLY)
    assert int(RA.xorshift_step(_i32([1]))[0]) == 2


def test_gen_updates_rows_are_streams():
    seeds = np.array(SEEDS, np.uint32)
    got = RA.gen_updates(_i32(seeds), 33).numpy().view(np.uint32)
    for row, seed in zip(got, SEEDS):
        assert _bits(row) == _bits(_np_xorshift_stream(seed, 33))


@pytest.mark.parametrize("n_dev", [1, 4])
@pytest.mark.parametrize("sign", [+1, -1])
def test_bucket_updates_equal_reference(sign, n_dev):
    table_log = 10
    local_size = (1 << table_log) // n_dev
    vals = np.random.default_rng(7).integers(0, 1 << 32, 256,
                                             dtype=np.uint32)
    vals[:3] = (0x80000000, 0xFFFFFFFF, 0)  # INT_MIN, -1 and 0 as int32
    want = np.asarray(JRA._bucket_updates(
        jnp.asarray(vals), table_log=table_log, local_size=local_size,
        n_dev=n_dev, sign=sign))
    got = RA.bucket_updates(_i32(vals), table_log=table_log,
                            local_size=local_size, n_dev=n_dev, sign=sign)
    assert _bits(got.numpy()) == _bits(want)


def test_reference_state_equal_reference():
    table, seeds = JRA._make_table_and_seeds(make_mesh((1,), ("x",)),
                                             table_log=10, rngs_per_device=8)
    got_t, got_s = RA.reference_state(1, table_log=10, rngs_per_device=8)
    assert _bits(got_t) == _bits(table) and _bits(got_s) == _bits(seeds)


@pytest.mark.parametrize("routed", [False, True], ids=["drop_local",
                                                       "routed"])
@pytest.mark.parametrize("sign", [+1, -1])
def test_forward_table_single_rank_equals_reference(sign, routed):
    jmesh = make_mesh((1,), ("x",))
    kw = dict(updates_per_rng=SMALL["updates_per_rng"],
              table_log=SMALL["table_log"], sign=sign)
    table, seeds = JRA._make_table_and_seeds(
        jmesh, table_log=SMALL["table_log"],
        rngs_per_device=SMALL["rngs_per_device"])
    jstep = (JRA.make_routed_step(jmesh, JEngine.for_mesh(jmesh), **kw)
             if routed else JRA.make_step(jmesh, **kw))
    want = np.asarray(jstep(table, seeds))

    mesh = single_rank_mesh(("x",))
    t, s = RA.from_reference(np.asarray(table), np.asarray(seeds), mesh,
                             "cpu")
    step = (RA.make_routed_step(mesh, CollectiveEngine.for_mesh(mesh), **kw)
            if routed else RA.make_step(mesh, **kw))
    got = RA.to_reference(step(t, s), mesh)
    assert _bits(got) == _bits(want)
    assert not np.array_equal(got, np.asarray(table))


def test_scatter_add_wraps_and_drops_sentinel():
    table = torch.tensor([2 ** 31 - 1, 5, -2 ** 31], dtype=torch.int32)
    idx = torch.tensor([0, 3, 2, 3, 0], dtype=torch.int32)
    upd = torch.tensor([1, 99, -1, 7, 2], dtype=torch.int32)
    out = RA.scatter_add(table, idx, upd)
    assert out.tolist() == [-2 ** 31 + 2, 5, 2 ** 31 - 1]
    assert table.tolist() == [2 ** 31 - 1, 5, -2 ** 31]  # out of place


@pytest.mark.parametrize("entry", ["randomaccess", "randomaccess_dist"])
def test_run_single_rank_cpu(entry):
    fn = {"randomaccess": RA.run_randomaccess,
          "randomaccess_dist": RA.run_randomaccess_dist}[entry]
    res = fn(**SMALL, reps=1, device="cpu")
    assert res.error == 0.0 and res.details["device"] == "cpu"
    assert res.details["updates"] == 2 * 128
    phases = ({"generate", "scatter"} if entry == "randomaccess" else
              {"generate", "bucket", "exchange", "scatter"})
    assert set(res.details["phase_seconds"]) == phases
    if entry == "randomaccess_dist":
        # the cost model's pick on a 1-rank ring, as the reference's model
        # makes it on the same constants
        assert res.details["schedule"] == _reference_choice(
            1 * 256 * 2 * 4, "ra.updates") == "chain"
        assert res.details["exchange_bytes"] == 1 * 256 * 2 * 4


def test_entry_points_without_card_raise(monkeypatch):
    from repro_torch.core.fft import run_fft, run_fft_dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (lambda: RA.run_randomaccess(table_log=4),
                  lambda: RA.run_randomaccess_dist(table_log=4),
                  lambda: run_fft(log_size=4),
                  lambda: run_fft_dist(log_size=4),
                  lambda: gups_fft_bench.main(quick=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()


# ---------------------------------------------------------------------------
# the benchmark scripts at --quick size
# ---------------------------------------------------------------------------


def test_gups_fft_bench_quick_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(common, "RESULTS", tmp_path)
    rec = gups_fft_bench.main(quick=True, device="cpu")
    assert rec["randomaccess_routed"]["err"] == 0.0
    assert rec["randomaccess_local"]["err"] == 0.0
    assert rec["fft_dist"]["err"] < 1e-5
    routed = rec["randomaccess_routed"]
    assert routed["schedule"] == _reference_choice(
        routed["exchange_bytes"], "ra.updates") == "chain"
    assert gups_fft_bench.gate(rec) == []


def test_gups_fft_bench_gate_fails():
    rec = {"randomaccess_routed": {"schedule": "auto", "err": 1e-3},
           "fft_dist": {"schedule": "rs_ag", "err": 1.0}}
    assert len(gups_fft_bench.gate(rec)) == 4


def test_legacy_suite_rows_quick_cpu():
    rec = legacy_suite.main(quick=True, device="cpu")
    assert rec["randomaccess"]["err"] == 0.0
    assert rec["randomaccess"]["table_log"] == 16
    assert rec["fft"]["err"] < 1e-5 and rec["fft"]["log_size"] == 10


# ---------------------------------------------------------------------------
# the reference on four simulated devices, in a subprocess
# ---------------------------------------------------------------------------

_REFERENCE = r"""
import sys
import numpy as np
from repro.comm.engine import CollectiveEngine
from repro.compat import make_mesh
from repro.core import randomaccess as RA

SMALL = %(small)r
ring = make_mesh((4,), ("x",))
table, seeds = RA._make_table_and_seeds(
    ring, table_log=SMALL["table_log"],
    rngs_per_device=SMALL["rngs_per_device"])
kw = dict(updates_per_rng=SMALL["updates_per_rng"],
          table_log=SMALL["table_log"])
out = {"init": np.asarray(table),
       "drop_local": np.asarray(RA.make_step(ring, **kw)(table, seeds))}
for s in ("native", "chain", "staged"):
    eng = CollectiveEngine.for_mesh(ring, schedule=s)
    out["routed/" + s] = np.asarray(
        RA.make_routed_step(ring, eng, **kw)(table, seeds))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("ra_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE % {"small": SMALL}, str(path)],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


# ---------------------------------------------------------------------------
# a 4-rank gloo ring
# ---------------------------------------------------------------------------


def _ring_world(mesh):
    out = {}
    table_np, seeds_np = RA.reference_state(
        RING, table_log=SMALL["table_log"],
        rngs_per_device=SMALL["rngs_per_device"])
    table, seeds = RA.from_reference(table_np, seeds_np, mesh, "cpu")
    out["init"] = RA.to_reference(table, mesh)
    kw = dict(updates_per_rng=SMALL["updates_per_rng"],
              table_log=SMALL["table_log"])
    out["drop_local"] = RA.to_reference(RA.make_step(mesh, **kw)(
        table, seeds), mesh)
    res = RA.run_randomaccess(mesh, **SMALL, reps=1, device="cpu")
    out["drop_local_err"] = res.error
    for s in SCHEDULES:
        eng = CollectiveEngine.for_mesh(mesh, schedule=s)
        for k in CHUNKS:
            step = RA.make_routed_step(mesh, eng, nchunks=k, **kw)
            out["routed", s, k] = RA.to_reference(step(table, seeds), mesh)
            res = RA.run_randomaccess_dist(mesh, **SMALL, reps=1, schedule=s,
                                           nchunks=k, device="cpu")
            out["routed_err", s, k] = (res.error, res.details["schedule"],
                                       res.details["nchunks"])
    try:
        RA.run_randomaccess_dist(mesh, table_log=1, device="cpu")
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


@pytest.fixture(scope="module")
def ring_results():
    return spawn_mesh(RING, _ring_world, axes=("x",), timeout=240)


def test_state_sharded_like_reference(ring_results, reference):
    for res in ring_results:
        assert _bits(res["init"]) == _bits(reference["init"])


def test_drop_local_forward_table_on_ring(ring_results, reference):
    for res in ring_results:
        assert _bits(res["drop_local"]) == _bits(reference["drop_local"])
        assert res["drop_local_err"] == 0.0


@pytest.mark.parametrize("nchunks", CHUNKS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_routed_forward_table_on_ring(ring_results, reference, schedule,
                                      nchunks):
    """Bit for bit the reference's routed table (every schedule of the
    reference agrees), on every rank."""
    want = reference["routed/" + schedule]
    assert _bits(want) == _bits(reference["routed/native"])
    for res in ring_results:
        assert _bits(res["routed", schedule, nchunks]) == _bits(want)


@pytest.mark.parametrize("nchunks", CHUNKS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_routed_restore_exact_on_ring(ring_results, schedule, nchunks):
    for res in ring_results:
        assert res["routed_err", schedule, nchunks] == (0.0, schedule,
                                                        nchunks)


def test_randomaccess_rejects_indivisible_table(ring_results):
    for res in ring_results:
        assert "not divisible by 4 devices" in res["indivisible"]
