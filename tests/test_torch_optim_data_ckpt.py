"""The port's training substrate on the CPU, held against the JAX reference:
the synthetic data pipeline, AdamW and its schedule, and checkpointing.

The cases of the reference's ``tests/test_data_optim_ckpt.py`` (up to the
subset restore) run on the port, each beside the reference's answer on the
same inputs: data tokens bit for bit for every ``(seed, step, shard,
num_shards)`` tried; ``adamw_update`` over 5 steps, its in-place form and
``make_lr_schedule`` within rtol 1e-6 (the port keeps the reference's
order of operations; XLA may contract a product and a sum into one fused
multiply-add, so the last bit may differ); ``clip_by_global_norm`` within
rtol 1e-6. Checkpoints keep the reference's layout: the same files,
manifest and arrays for the same tree, which the reference restores.
"""
from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import data as jdata
from repro import optim as joptim
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, SyntheticLMDataset, make_batch_iterator
from repro_torch.models.model import build_model
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               adamw_update_, clip_by_global_norm,
                               global_norm, make_lr_schedule)
from repro_torch.train.step import TrainState, init_train_state

RTOL = 1e-6

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's tiny models: under six test
    workers the default (one thread per core in every process)
    oversubscribes the cores and slows each small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

DATA_CASES = [  # (vocab, batch, seq, seed, step, shard, num_shards, motif)
    (512, 8, 64, 0, 0, 0, 1, 16),
    (512, 8, 64, 0, 7, 0, 1, 16),
    (512, 8, 32, 3, 5, 1, 4, 16),
    (512, 8, 32, 3, 5, 3, 4, 16),
    (1000, 16, 48, 11, 100, 2, 8, 0),
    (128256, 4, 256, 0, 2, 1, 2, 16),
]


@pytest.mark.parametrize("case", DATA_CASES, ids=lambda c: "-".join(map(
    str, c)))
def test_data_tokens_match_reference(case):
    vocab, batch, seq, seed, step, shard, nshards, motif = case
    cfg = DataConfig(vocab_size=vocab, global_batch=batch, seq_len=seq,
                     seed=seed, motif_len=motif)
    jcfg = jdata.DataConfig(vocab_size=vocab, global_batch=batch,
                            seq_len=seq, seed=seed, motif_len=motif)
    got = SyntheticLMDataset(cfg).batch(step, shard, nshards)["tokens"]
    want = jdata.SyntheticLMDataset(jcfg).batch(step, shard,
                                                nshards)["tokens"]
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert SyntheticLMDataset(cfg).entropy_floor() == \
        jdata.SyntheticLMDataset(jcfg).entropy_floor()


@pytest.mark.parametrize("start,shard,nshards", [(0, 0, 1), (3, 0, 1),
                                                 (5, 1, 2)])
def test_batch_iterator_matches_reference(start, shard, nshards):
    cfg = DataConfig(vocab_size=512, global_batch=4, seq_len=32)
    jcfg = jdata.DataConfig(vocab_size=512, global_batch=4, seq_len=32)
    it = make_batch_iterator(cfg, start_step=start, shard=shard,
                             num_shards=nshards)
    jit = jdata.make_batch_iterator(jcfg, start_step=start, shard=shard,
                                    num_shards=nshards)
    for _ in range(3):
        (s, b), (js, jb) = next(it), next(jit)
        assert s == js
        np.testing.assert_array_equal(b["tokens"], jb["tokens"])


def test_data_deterministic():
    cfg = DataConfig(vocab_size=512, global_batch=8, seq_len=64)
    a = SyntheticLMDataset(cfg).batch(7)
    b = SyntheticLMDataset(cfg).batch(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_data_steps_differ():
    ds = SyntheticLMDataset(DataConfig(vocab_size=512, global_batch=8,
                                       seq_len=64))
    assert not np.array_equal(ds.batch(0)["tokens"], ds.batch(1)["tokens"])


def test_data_shards_partition_batch():
    """Shards are rows of the same global batch, drawn per (step, shard)."""
    ds = SyntheticLMDataset(DataConfig(vocab_size=512, global_batch=8,
                                       seq_len=32))
    full = ds.batch(3, shard=0, num_shards=1)["tokens"]
    parts = [ds.batch(3, shard=i, num_shards=4)["tokens"] for i in range(4)]
    assert all(p.shape == (2, 32) for p in parts)
    assert not np.array_equal(parts[0], parts[1])
    assert full.shape == (8, 32)


def test_data_iterator_resumes():
    cfg = DataConfig(vocab_size=512, global_batch=4, seq_len=32)
    it = make_batch_iterator(cfg)
    batches = [next(it) for _ in range(5)]
    step, batch = next(make_batch_iterator(cfg, start_step=3))
    assert step == 3
    np.testing.assert_array_equal(batch["tokens"], batches[3][1]["tokens"])


def test_data_has_learnable_structure():
    """Markov tokens: successor sets are small, so the bigram entropy is
    far below uniform."""
    cfg = DataConfig(vocab_size=256, global_batch=4, seq_len=256)
    toks = SyntheticLMDataset(cfg).batch(0)["tokens"]
    succ = {}
    for row in toks:
        for a, b in zip(row[:-1], row[1:]):
            succ.setdefault(int(a), set()).add(int(b))
    assert np.mean([len(v) for v in succ.values()]) <= cfg.branching + 1


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

SHAPES = {"a": (4, 5), "b": {"c": (7,), "d": (3, 2, 2)}, "e": (1,)}


def _tree(rng, shapes=SHAPES, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _pairs(a, b):
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k])
    else:
        yield a, b


def _close(got, want, rtol=RTOL, atol=0.0):
    for g, w in _pairs(got, want):
        np.testing.assert_allclose(np.asarray(g.detach().cpu()),
                                   np.asarray(w), rtol=rtol, atol=atol)


@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("mode", ["functional", "in_place"])
def test_adamw_matches_reference(wd, mode):
    """Five steps from the same weights and gradients: weights and both
    moments within rtol 1e-6 of the reference after every step."""
    rng = np.random.default_rng(0)
    p_np = _tree(rng)
    cfg = AdamWConfig(lr=1e-2, weight_decay=wd)
    jcfg = joptim.AdamWConfig(lr=1e-2, weight_decay=wd)
    sched = make_lr_schedule(1e-2, 2, 10)
    jsched = joptim.make_lr_schedule(1e-2, 2, 10)
    params = _map(torch.from_numpy, p_np)
    state = adamw_init(params)
    jparams = _map(jnp.asarray, p_np)
    jstate = joptim.adamw_init(jparams)
    for step in range(5):
        g_np = _tree(rng, scale=10.0 ** (step - 2))
        grads = _map(torch.from_numpy, g_np)
        lr, jlr = sched(step), jsched(step)
        np.testing.assert_allclose(float(lr), float(jlr), rtol=RTOL)
        if mode == "functional":
            params, state = adamw_update(grads, state, params, cfg, lr)
        else:
            adamw_update_(grads, state, params, cfg, lr)
        jparams, jstate = joptim.adamw_update(
            _map(jnp.asarray, g_np), jstate, jparams, jcfg, jlr)
        _close(params, jparams)
        _close(state["mu"], jstate["mu"])
        _close(state["nu"], jstate["nu"])
        assert int(state["count"]) == int(jstate["count"]) == step + 1


def test_adamw_in_place_is_bitwise_functional():
    """The training step's in-place update, with the clip folded in as a
    scale, gives the bits of ``clip_by_global_norm`` then ``adamw_update``."""
    rng = np.random.default_rng(1)
    p_np = _tree(rng)
    cfg = AdamWConfig(lr=3e-3)
    a = _map(torch.from_numpy, p_np)
    b = _map(lambda x: torch.from_numpy(x.copy()), p_np)
    sa, sb = adamw_init(a), adamw_init(b)
    sched = make_lr_schedule(3e-3, 1, 10)
    for step in range(3):
        grads = _map(torch.from_numpy, _tree(rng, scale=3.0))
        clipped, norm = clip_by_global_norm(grads, cfg.max_grad_norm)
        a, sa = adamw_update(clipped, sa, a, cfg, sched(step))
        scale = torch.clamp(cfg.max_grad_norm / torch.clamp(
            global_norm(grads), min=1e-12), max=1.0)
        adamw_update_(grads, sb, b, cfg, sched(step), scale=scale)
        for x, y in ((a, b), (sa["mu"], sb["mu"]), (sa["nu"], sb["nu"])):
            for u, v in _pairs(x, y):
                assert torch.equal(u, v)


def test_adamw_minimizes_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = adamw_init(params)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(200):
        grads = {"w": 2 * (params["w"] - target)}
        params, state = adamw_update(grads, state, params, cfg,
                                     torch.tensor(0.1))
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 1e6])
def test_clip_by_global_norm_matches_reference(max_norm):
    g_np = _tree(np.random.default_rng(2))
    got, norm = clip_by_global_norm(_map(torch.from_numpy, g_np), max_norm)
    want, jnorm = joptim.clip_by_global_norm(_map(jnp.asarray, g_np),
                                             max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=RTOL)
    _close(got, want)
    np.testing.assert_allclose(float(global_norm(got)),
                               float(joptim.global_norm(want)), rtol=RTOL)


def test_clip_by_global_norm():
    grads = {"a": torch.full((4,), 10.0), "b": torch.full((4,), 10.0)}
    clipped, norm = clip_by_global_norm(grads, 1.0)
    np.testing.assert_allclose(float(norm), np.sqrt(800.0), rtol=1e-6)
    np.testing.assert_allclose(float(global_norm(clipped)), 1.0, rtol=1e-5)
    out, _ = clip_by_global_norm({"a": torch.full((4,), 0.01)}, 1.0)
    np.testing.assert_allclose(out["a"].numpy(), 0.01, rtol=1e-6)


@pytest.mark.parametrize("base,warmup,total", [(1e-3, 10, 100),
                                               (3e-4, 0, 50), (1e-2, 2, 16),
                                               (5e-4, 100, 10_000)])
def test_lr_schedule_matches_reference(base, warmup, total):
    sched = make_lr_schedule(base, warmup, total)
    jsched = joptim.make_lr_schedule(base, warmup, total)
    steps = sorted(set(range(0, min(total, 120) + 5))
                   | {total // 2, total, total + 7})
    for step in steps:
        got, want = sched(step), jsched(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                                   err_msg=f"step {step}")
    # a step given as an int32 scalar tensor reads the same
    assert float(sched(torch.tensor(5, dtype=torch.int32))) == \
        float(sched(5))


def test_lr_schedule_shape():
    sched = make_lr_schedule(1e-3, warmup_steps=10, total_steps=100)
    assert float(sched(0)) == 0.0
    np.testing.assert_allclose(float(sched(10)), 1e-3, rtol=1e-5)
    assert float(sched(5)) == pytest.approx(5e-4, rel=1e-5)
    assert float(sched(100)) == pytest.approx(1e-4, rel=1e-3)
    assert float(sched(55)) < float(sched(20))


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------


def _ck_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(
                rng.standard_normal((4, 4)).astype(np.float32)),
                       "b": torch.from_numpy(
                rng.standard_normal(4).astype(np.float32))},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path / "ck")
    tree = _ck_tree()
    ckpt.save(d, 7, {"state": tree}, extra={"loss": 1.5})
    step, out, extra = ckpt.restore(d, {"state": tree})
    assert step == 7 and extra["loss"] == 1.5
    assert torch.equal(out["state"]["params"]["w"], tree["params"]["w"])
    assert out["state"]["step"].dtype == torch.int32


def test_checkpoint_layout_matches_reference(tmp_path):
    """The same tree gives the reference's files, manifest and arrays, and
    the reference restores the port's checkpoint."""
    tree = _ck_tree()
    jtree = _map(lambda t: jnp.asarray(t.numpy()), tree)
    ckpt.save(str(tmp_path / "port"), 3, {"state": tree}, extra={"a": 1})
    jckpt.save(str(tmp_path / "ref"), 3, {"state": jtree}, extra={"a": 1})
    dirs = [tmp_path / "port", tmp_path / "ref"]
    assert sorted(os.listdir(dirs[0])) == sorted(os.listdir(dirs[1])) == \
        ["step_0000000003"]
    files = [sorted(os.listdir(d / "step_0000000003")) for d in dirs]
    assert files[0] == files[1] == ["manifest.json", "state.npz"]
    manifests = [json.loads((d / "step_0000000003" / "manifest.json")
                            .read_text()) for d in dirs]
    assert manifests[0] == manifests[1]
    _, out, _ = jckpt.restore(str(dirs[0]), {"state": jtree})
    for g, w in _pairs(out["state"], jtree):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_checkpoint_retention(tmp_path):
    d = str(tmp_path / "ck")
    for s in range(6):
        ckpt.save(d, s, {"state": _ck_tree(s)}, keep=3)
    assert ckpt.all_steps(d) == [3, 4, 5]


def test_checkpoint_ignores_stale_tmp(tmp_path):
    """A crash mid-write leaves step_X.tmp; restore skips it and the next
    good save removes it."""
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"state": _ck_tree()})
    os.makedirs(os.path.join(d, "step_0000000002.tmp"))
    assert ckpt.latest_step(d) == 1
    step, _, _ = ckpt.restore(d, {"state": _ck_tree()})
    assert step == 1
    ckpt.save(d, 3, {"state": _ck_tree()})
    assert not any(e.endswith(".tmp") for e in os.listdir(d))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"state": _ck_tree()})
    bad = _ck_tree()
    bad["params"]["w"] = torch.zeros((2, 2))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, {"state": bad})


def test_checkpoint_mismatch_reports_every_leaf(tmp_path):
    """The complete diagnosis, as the reference gives it: every missing and
    mis-shaped leaf across all trees."""
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"state": _ck_tree()})
    bad = _ck_tree()
    bad["params"]["w"] = torch.zeros((2, 2))
    bad["params"]["extra"] = torch.zeros(3)
    with pytest.raises(ckpt.CheckpointMismatchError) as ei:
        ckpt.restore(d, {"state": bad})
    jbad = _map(lambda t: jnp.asarray(t.numpy()), bad)
    with pytest.raises(jckpt.CheckpointMismatchError) as jei:
        jckpt.restore(d, {"state": jbad})
    err, jerr = ei.value, jei.value
    assert err.missing == jerr.missing == ("state:params/extra",)
    assert err.shape_mismatches == jerr.shape_mismatches == \
        (("state:params/w", (4, 4), (2, 2)),)
    assert str(err) == str(jerr)


def test_checkpoint_subset_restore_still_allowed(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, {"state": _ck_tree()})
    step, out, _ = ckpt.restore(d, {"state": {"params": {
        "w": torch.zeros((4, 4))}}})
    assert step == 1 and set(out["state"]["params"]) == {"w"}


def test_checkpoint_reshard_to_waits_for_the_parallel_model(tmp_path):
    """``reshard_to`` on a one-rank mesh: a tree that is neither a training
    state nor a weight module stays whole (replicated), and a training
    state's one shard is the whole state, bit for bit. Onto meshes of
    several ranks it runs in tests/test_torch_elastic.py."""
    from repro_torch.launch.mesh import single_rank_mesh

    mesh = single_rank_mesh(("x",))
    d = str(tmp_path / "ck")
    cfg = reduced(get_config("qwen3-moe-235b-a22b"), layers=2, d_model=32)
    state = init_train_state(build_model(cfg), 3, device="cpu")
    ckpt.save(d, 1, {"state": _ck_tree(), "train": state})
    _, plain, _ = ckpt.restore(d, {"state": _ck_tree(5)})
    _, got, _ = ckpt.restore(d, {"state": _ck_tree(5)}, reshard_to=mesh)
    for k, v in plain["state"]["params"].items():
        assert torch.equal(got["state"]["params"][k], v)
    _, got, _ = ckpt.CheckpointManager(d).restore_latest(
        {"train": init_train_state(build_model(cfg), 4, device="cpu")},
        reshard_to=mesh)
    want = state.params.tree()
    for i, blk in enumerate(got["train"].params.tree()["blocks"]):
        for k in ("w_gate", "w_in", "w_out", "router"):
            assert torch.equal(blk["moe"][k], want["blocks"][i]["moe"][k])
    assert got["train"].params.embed.requires_grad


@pytest.mark.parametrize("compression_on", [False, True])
def test_checkpoint_train_state_roundtrip(tmp_path, compression_on):
    """A whole TrainState comes back bit for bit, weights trainable, on the
    saving devices and dtypes."""
    cfg = reduced(get_config("llama3.2-3b"), layers=2, d_model=32)
    model = build_model(cfg)
    state = init_train_state(model, 3, device="cpu",
                             compression_on=compression_on)
    state.opt["mu"]["embed"].add_(0.25)
    state.step = torch.tensor(5, dtype=torch.int32)
    d = str(tmp_path / "ck")
    ckpt.save(d, 5, {"state": state})
    fresh = init_train_state(model, 4, device="cpu",
                             compression_on=compression_on)
    step, out, _ = ckpt.restore(d, {"state": fresh})
    got = out["state"]
    assert step == 5 and isinstance(got, TrainState)
    assert type(got.params) is type(state.params)
    assert all(p.requires_grad for p in got.params.parameters())
    for a, b in zip(ckpt.manager._leaves(got), ckpt.manager._leaves(state)):
        assert a[0] == b[0]
        assert a[1].dtype == b[1].dtype and torch.equal(a[1], b[1])
    assert (got.error is None) == (not compression_on)


def test_adamw_update_in_runs_is_the_whole_leaf_update(monkeypatch):
    """A leaf longer than ``UPDATE_CHUNK`` is updated in runs of it: the
    same operations on every element, so the same bits as one pass."""
    from repro_torch.optim import adamw as port_adamw

    rng = np.random.default_rng(3)

    def tree():
        return {"w": torch.from_numpy(rng.standard_normal((300, 7))
                                      .astype(np.float32)),
                "b": torch.from_numpy(rng.standard_normal(5)
                                      .astype(np.float32))}

    params, grads = tree(), tree()
    runs = []
    for chunk in (port_adamw.UPDATE_CHUNK, 256):
        monkeypatch.setattr(port_adamw, "UPDATE_CHUNK", chunk)
        p = {k: v.clone() for k, v in params.items()}
        st = adamw_init(p)
        for _ in range(2):
            adamw_update_(grads, st, p, AdamWConfig(lr=1e-2),
                          torch.tensor(1e-2), scale=torch.tensor(0.5))
        runs.append((p, st))
    (p1, s1), (p2, s2) = runs
    for k in params:
        assert torch.equal(p1[k], p2[k])
        assert torch.equal(s1["mu"][k], s2["mu"][k])
        assert torch.equal(s1["nu"][k], s2["nu"][k])
