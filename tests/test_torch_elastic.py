"""The port's elastic training on four gloo processes: checkpoints written
by one rank of a mesh, restored and resharded onto another, and a lost rank
survived by ``train_loop_elastic`` (the cases of the reference's
``tests/dist/test_resilience.py:120-140`` and ``:181-215``).

One world of four CPU processes (``spawn_mesh``, a ring ``x``) trains
reduced qwen3-moe (``tiny(4, layers=2)``: one expert per rank, 4 rows x 16
tokens a step, lr 1e-3 after one warmup step, a checkpoint every 2 steps)
under ``step_mode="explicit_tp"``:

* a run crashed before its step-4 checkpoint (``fail_at_step=4``) resumes
  from step 2, and its last loss equals an uninterrupted run's (rtol 1e-6,
  the reference's limit);
* ``failover_bench``'s rank-loss section, rank body and gate: the last rank
  is lost at step 4 of 6, the survivors resume on a ring of 2 from the
  resharded checkpoint, and their losses equal a control's restored from
  the snapshot on an identically chosen ring, bit for bit;
* ``checkpoint.restore(reshard_to=)`` onto the ring of four and onto a ring
  of two equals a whole restore cut by ``shard_whole_model_state``, bit for
  bit, and gathering the cut state gives the whole one back.

The reference is not imported here: these cases hold the port to its own
runs, as the reference's tests hold it to its own.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.benchmarks import failover_bench
from repro_torch.comm.overlap import tree_flatten
from repro_torch.configs import RunConfig
from repro_torch.configs.qwen3_moe_235b_a22b import tiny
from repro_torch.data import DataConfig
from repro_torch.launch.mesh import spawn_mesh, sub_ring_mesh
from repro_torch.models.model import build_model
from repro_torch.train.loop import (InjectedFailure, TrainLoopConfig,
                                    train_loop)
from repro_torch.train.step import (TrainState, gather_whole_model_state,
                                    init_train_state,
                                    shard_whole_model_state,
                                    whole_model_param_specs)

RANKS = 4


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
    return tiny(RANKS, layers=2)


def _leaves(state: TrainState):
    return (tree_flatten(state.params.tree())[0]
            + tree_flatten(state.opt["mu"])[0]
            + tree_flatten(state.opt["nu"])[0]
            + [state.opt["count"], state.step])


def _same(a: TrainState, b: TrainState) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(la, lb))


def _injected(mesh, root):
    cfg = _cfg()
    data = DataConfig(cfg.vocab_size, RANKS, 16)

    def run(d, **kw):
        rc = RunConfig(checkpoint_dir=os.path.join(root, d),
                       checkpoint_every=2, learning_rate=1e-3,
                       warmup_steps=1)
        return train_loop(cfg, rc, data, TrainLoopConfig(
            steps=5, step_mode="explicit_tp", **kw), mesh=mesh,
            device="cpu")

    try:
        run("ck", fail_at_step=4)
        crashed = False
    except InjectedFailure:
        crashed = True
    resumed = run("ck")
    clean = run("fresh")
    return {"crashed": crashed, "resumed": resumed, "clean": clean}


def _reshard(mesh, root):
    """restore(reshard_to=) onto this mesh and onto a ring of two, against
    a whole restore cut here; and the gathered cut against the whole."""
    like = {"state": init_train_state(build_model(_cfg()), 7, device="cpu")}
    d = os.path.join(root, "ck")
    step, whole, _ = ckpt.restore(d, like)
    whole = whole["state"]
    out = {"step": step}
    _, got, _ = ckpt.restore(d, like, reshard_to=mesh)
    cut = shard_whole_model_state(whole, mesh)
    out["four"] = _same(got["state"], cut)
    out["gathered"] = _same(gather_whole_model_state(cut, mesh), whole)
    out["expert_rows"] = int(got["state"].params.blocks[0]["moe"]["w_in"]
                             .shape[0])
    two = sub_ring_mesh((0, 1))  # every process enters the group
    if two is not None:
        _, got2, _ = ckpt.CheckpointManager(d).restore_latest(
            like, reshard_to=two)
        out["two"] = _same(got2["state"], shard_whole_model_state(whole, two))
        out["expert_rows_two"] = int(
            got2["state"].params.blocks[0]["moe"]["w_in"].shape[0])
    return out


def _rank(mesh, root):
    injected = _injected(mesh, os.path.join(root, "injected"))
    rank_loss = failover_bench.rank_loss_rank(
        mesh, os.path.join(root, "rank_loss"), True, "cpu")
    return {"injected": injected, "rank_loss": rank_loss,
            "reshard": _reshard(mesh, os.path.join(root, "injected"))}


@pytest.fixture(scope="module")
def world():
    root = tempfile.mkdtemp(prefix="torch_elastic_")
    try:
        ranks = spawn_mesh(RANKS, _rank, root, axes=("x",), timeout=300)
        d = os.path.join(root, "injected", "ck")
        files = sorted(os.listdir(d))
        with open(os.path.join(d, files[-1], "manifest.json")) as f:
            manifest = json.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"ranks": ranks, "files": files, "manifest": manifest}


def test_injected_failure_resume_explicit_tp(world):
    for rank in world["ranks"]:
        rec = rank["injected"]
        assert rec["crashed"]
        assert rec["resumed"]["step"][0] == 2  # from the step-2 checkpoint
        assert rec["clean"]["step"] == list(range(5))
        np.testing.assert_allclose(rec["resumed"]["loss"][-1],
                                   rec["clean"]["loss"][-1], rtol=1e-6)
    assert len({tuple(r["injected"]["clean"]["loss"])
                for r in world["ranks"]}) == 1


def test_one_rank_writes_whole_checkpoints(world):
    """The crashed run's step 2, the resumed run's step 4 and its final
    step 5, no temporaries left (one writer: never four renames into one
    directory), and the expert weights whole on disk (4 experts), as the
    reference's layout holds them."""
    assert world["files"] == ["step_0000000002", "step_0000000004",
                              "step_0000000005"]
    trees = world["manifest"]["trees"]["state"]
    cfg = _cfg()
    for i in range(cfg.num_layers):
        for part in ("0", "1/mu", "1/nu"):
            key = f"{part}/blocks/{i}/moe/w_in"
            assert trees[key]["shape"] == [cfg.num_experts, cfg.d_model,
                                           cfg.moe_d_ff], key
    assert world["manifest"]["extra"] == {"final": True}


def test_rank_loss_elastic_resume_bitwise(world):
    per_rank = [r["rank_loss"] for r in world["ranks"]]
    sec = failover_bench.rank_loss_record(per_rank)
    rec = sec["recovery"]
    assert rec["lost_ranks"] == [RANKS - 1] and rec["fail_step"] == 4
    assert rec["old_size"] == RANKS and rec["new_size"] == 2
    assert rec["resume_step"] <= rec["fail_step"]
    assert sec["completed"]  # the resumed run finished every step
    assert sec["resumed_losses"] == sec["control_losses"]  # bitwise
    assert sec["sat_out"] == [False, False, True, True]
    assert failover_bench.gate_rank_loss(sec) == []


def test_rank_loss_gate_refuses_a_diverged_resume(world):
    sec = failover_bench.rank_loss_record(
        [r["rank_loss"] for r in world["ranks"]])
    bad = dict(sec, loss_bitwise=False,
               recovery=dict(sec["recovery"], new_size=RANKS))
    assert len(failover_bench.gate_rank_loss(bad)) == 2


def test_restore_reshard_to_equals_a_fresh_cut(world):
    for r, rank in enumerate(world["ranks"]):
        rec = rank["reshard"]
        assert rec["step"] == 5
        assert rec["four"] and rec["gathered"]
        assert rec["expert_rows"] == 1  # 4 experts over 4 ranks
        if r < 2:
            assert rec["two"] and rec["expert_rows_two"] == 2
        else:
            assert "two" not in rec


def test_whole_model_param_specs_match_the_reference():
    """Leaf by leaf, the port's layout is the reference's
    ``whole_model_param_specs`` without its super-block scan dimension."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.train import step as jstep
    from repro_torch.models.model import to_reference

    cfg = _cfg()
    params = build_model(cfg).init(0, device="cpu")
    want = jstep.whole_model_param_specs(to_reference(params), "x")
    got = whole_model_param_specs(params, "x")
    period = len(want["blocks"])
    flat, _ = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, P))
    n = 0
    for path, spec in flat:
        keys = [getattr(e, "key", getattr(e, "idx", None)) for e in path]
        if keys[0] == "blocks":
            for i in range(int(keys[1][1:]), cfg.num_layers, period):
                node = got["blocks"][i]
                for k in keys[2:]:
                    node = node[k]
                assert node.dims == tuple(spec)[1:], (keys, i)
                n += 1
        else:
            node = got
            for k in keys:
                node = node[k]
            assert node.dims == tuple(spec), keys
            n += 1
    assert n == len(tree_flatten(got)[0])
    sharded = [s for s in tree_flatten(got)[0] if not s.replicated]
    assert len(sharded) == 3 * cfg.num_layers
