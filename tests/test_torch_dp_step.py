"""The port's explicit data-parallel train step on four gloo processes,
held against its one-rank step and the JAX reference's on the global batch.

One world of four CPU processes (``spawn_mesh``, a ring ``x``) runs
``make_dp_train_step_explicit`` for two steps per schedule (``native``,
``chain``, ``rs_ag``, ``"auto"`` through an explicit ``CostModel`` on the
port's ``H100_80GB`` constants, and the ``int8_ef`` compressed path) on a
reduced llama3.2-3b (2 layers, d_model 32, fp32, remat ``full``), every
rank from the same initial state, each on its quarter of the global batch
(8 rows x 16 tokens of synthetic data per step). The parent runs the
port's one-rank ``make_train_step`` and ``repro.train.step.
make_train_step`` on the global batches from that state.

Limits: the loss within rtol 1e-5 of both one-rank steps and across the
schedules (the reference's own claim, ``tests/dist/test_schedules.py:
194-217``); ``grad_norm`` rtol 3e-5 and the weights after two steps atol
1e-3, as in ``tests/test_torch_train_step.py`` (the ranks sum the
gradient in another order, and AdamW's first moves are lr * g / (|g| +
eps)). ``native`` and ``rs_ag`` leave the four ranks' weights bit for bit
alike; ``chain`` adds in a different order on every rank and is not held
to that. ``int8_ef`` gives a finite loss and error tree, the same on
every rank (each rank's error tree is its own residual).

The reference is imported inside the functions that use it, so that the
four spawned processes, which import this module for their rank body, do
not import JAX.
"""
from __future__ import annotations

import dataclasses
import hashlib
import types

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.comm.compression import init_error_tree
from repro_torch.comm.engine import schedules_for
from repro_torch.comm.overlap import pack_buckets, tree_flatten
from repro_torch.comm.topology import MeshTopology
from repro_torch.comm.types import H100_80GB
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.launch.mesh import spawn_mesh
from repro_torch.models.model import (build_model, state_from_reference,
                                      state_to_reference)
from repro_torch.train.step import (GRADS_CALLSITE, init_train_state,
                                    make_train_step)

RANKS = 4
SCHEDULES = ("native", "chain", "rs_ag", "auto")
STEPS = 2
LR = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's tiny models: under six test
    workers the default (one thread per core in every process)
    oversubscribes the cores and slows each small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return configs.reduced(configs.get_config("llama3.2-3b"), layers=2,
                           d_model=32)


def _run(compress=False):
    return configs.RunConfig(learning_rate=LR, warmup_steps=0,
                             grad_compression="int8_ef" if compress
                             else "none")


def _leaves(tree):
    return tree_flatten(tree)[0]


def _digest(tree) -> str:
    h = hashlib.sha256()
    for leaf in _leaves(tree):
        h.update(np.ascontiguousarray(leaf).tobytes())
    return h.hexdigest()


def _start():
    """The initial state in the reference's layout and the global batches:
    each rank makes its own (a spawned process that is handed large
    arguments starts only once the one before it has read them)."""
    cfg = _cfg()
    state_np = state_to_reference(init_train_state(build_model(cfg), 0,
                                                   device="cpu"))
    data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                         global_batch=8, seq_len=16))
    return state_np, [data.batch(s) for s in range(STEPS)]


def _dp_rank(mesh):
    """Every schedule's two steps on this rank, from :func:`_start`."""
    from repro_torch.comm.autotune import CostModel
    from repro_torch.train.step import make_dp_train_step_explicit

    cfg = _cfg()
    model = build_model(cfg)
    state_np, batches = _start()
    out = {}
    for name in SCHEDULES + ("int8_ef",):
        compress = name == "int8_ef"
        state = state_from_reference(cfg, state_np, device="cpu")
        if compress:
            state.error = init_error_tree(state.params.tree())
        step = make_dp_train_step_explicit(
            model, _run(compress), mesh,
            schedule_kind="rs_ag" if compress else name,
            cost_model=CostModel(hw=H100_80GB))
        metrics = []
        for batch in batches:
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        ref = state_to_reference(state)
        engine = step.engine
        leaves = tree_flatten(state.params.tree())[0]
        buckets = [sum(leaves[i].numel() * 4 for i in b) for b in
                   pack_buckets(leaves, engine.bucket_bytes_for("x"))]
        out[name] = {
            "metrics": metrics, "params": ref["params"],
            "digest": _digest(ref["params"]),
            "error": None if ref["error"] is None else ref["error"],
            "bucket_nbytes": buckets,
            "resolved": [engine.schedule_for("allreduce", nbytes=n, axis="x",
                                             callsite=GRADS_CALLSITE)
                         for n in buckets],
        }
    return out


@pytest.fixture(scope="module")
def world():
    cfg = _cfg()
    state_np, batches = _start()
    ranks = spawn_mesh(RANKS, _dp_rank, axes=("x",), timeout=300)

    state = state_from_reference(cfg, state_np, device="cpu")
    fn = make_train_step(build_model(cfg), _run())
    one = []
    for batch in batches:
        state, m = fn(state, batch)
        one.append({k: float(v) for k, v in m.items()})
    one_params = state_to_reference(state)["params"]

    import jax

    from repro import configs as jconfigs
    from repro.models.model import build_model as jbuild_model
    from repro.train import step as jstep

    jmodel = jbuild_model(jconfigs.ModelConfig(**dataclasses.asdict(cfg)))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("x",))
    st, ref = jstep.TrainState(**state_np), []
    # the same HLO with LLVM's backend optimizations off: half the
    # compile's CPU time (as in tests/test_torch_train_step.py)
    jfn = jstep.make_train_step(jmodel, jconfigs.RunConfig(
        **dataclasses.asdict(_run())), mesh, donate=False).lower(
        st, batches[0]).compile(compiler_options={
            "xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True})
    for batch in batches:
        st, m = jfn(st, batch)
        st = jax.tree.map(np.asarray, st)
        ref.append({k: float(v) for k, v in m.items()})
    return dict(ranks=ranks, one=one, one_params=one_params, ref=ref,
                ref_params=st.params)


def _close_params(got, want):
    for a, b in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(a, b, atol=1e-3, rtol=0)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_dp_step_matches_one_rank_step(world, schedule):
    for rank in world["ranks"]:
        got = rank[schedule]
        for g, w in zip(got["metrics"], world["one"]):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=3e-5)
            assert g["lr"] == w["lr"]
        _close_params(got["params"], world["one_params"])


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_dp_step_matches_reference_step(world, schedule):
    for rank in world["ranks"]:
        got = rank[schedule]
        for g, w in zip(got["metrics"], world["ref"]):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=3e-5)
        _close_params(got["params"], world["ref_params"])


def test_dp_losses_agree_across_schedules(world):
    for rank in world["ranks"]:
        base = [m["loss"] for m in rank["native"]["metrics"]]
        for name in SCHEDULES:
            np.testing.assert_allclose(
                [m["loss"] for m in rank[name]["metrics"]], base, rtol=1e-5)


@pytest.mark.parametrize("schedule", ["native", "rs_ag"])
def test_dp_ranks_hold_bit_identical_weights(world, schedule):
    digests = {rank[schedule]["digest"] for rank in world["ranks"]}
    assert len(digests) == 1


def test_dp_int8_ef_is_finite_and_rank_identical(world):
    recs = [rank["int8_ef"] for rank in world["ranks"]]
    for rec in recs:
        assert all(np.isfinite(m["loss"]) for m in rec["metrics"])
        assert all(np.isfinite(leaf).all() for leaf in _leaves(rec["error"]))
        assert any(np.abs(leaf).max() > 0 for leaf in _leaves(rec["error"]))
        # the first step's loss is taken before any compressed update
        np.testing.assert_allclose(rec["metrics"][0]["loss"],
                                   world["one"][0]["loss"], rtol=1e-5)
    assert len({rec["digest"] for rec in recs}) == 1
    assert len({tuple(m["loss"] for m in rec["metrics"])
                for rec in recs}) == 1


def test_dp_auto_resolves_as_the_reference_cost_model(world):
    """Each gradient bucket's ``auto`` schedule is what the reference's
    cost model picks on the port's constants for the same bytes and ring."""
    from repro.comm import autotune as jautotune
    from repro.comm import topology as jtopology
    from repro.comm import types as jtypes

    rec = world["ranks"][0]["auto"]
    ring = jtopology.AxisTopology(**dataclasses.asdict(
        MeshTopology.from_mesh(types.SimpleNamespace(
            shape={"x": RANKS})).axis("x")))
    model = jautotune.CostModel(hw=jtypes.HardwareModel(
        **dataclasses.asdict(H100_80GB)))
    want = [model.choose("allreduce", n, (ring,), callsite=GRADS_CALLSITE)
            for n in rec["bucket_nbytes"]]
    assert rec["resolved"] == want
    assert set(rec["resolved"]) <= set(schedules_for("allreduce"))
    assert all(r["auto"]["resolved"] == rec["resolved"]
               for r in world["ranks"])

