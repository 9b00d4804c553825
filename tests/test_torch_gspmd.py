"""The GSPMD placement on several ranks, on four gloo processes, held
against the JAX reference's one-device step and generation.

One world of four CPU processes builds three meshes with
``launch/mesh.py::make_mesh``: 2x2 ``('data', 'model')``, 1x4 and the ring
``('x',)``. On ``reduced(llama3.2-3b, layers=2)`` with 2 KV heads (4 q
heads: 2 q heads and 1 KV head per rank on 2x2; on 1x4 one q head per
rank, the KV heads not dividing ``tp`` = 4, so each rank takes the KV
block its q head maps to) the ranks run:

* two steps of ``make_train_step`` on 2x2 with ZeRO-1 on, off and with
  ``fsdp``, and on 1x4, each from ``shard_state`` of seed 0's state, the
  whole weights gathered afterwards (``gather_state``);
* greedy ``generate`` of 4 prompts of 128 tokens (prefill takes
  ``_flash_sharded``) on 2x2 and 1x4, with a spy on
  ``ops.flash_attention`` recording the local shapes and ``bq``/``bk``,
  and a prefill on 1x4 of a model with 6 q heads, which tp = 4 does not
  divide (no flash call, the one-rank plain prefill's logits);
* two GSPMD steps of reduced qwen3-moe on the ring (``rules_for`` gives
  ``dp=('x',)`` and no tensor axis: whole weights, moments over ``x``);
* ``train_loop(step_mode="gspmd")`` on 2x2: two steps with the final
  (forced) checkpoint, then resumed to four from it into ``state_specs``'
  layout, against four steps without the stop;
* ``lm_step_bench``'s ``moe_explicit`` section in quick mode.

The parent runs ``repro.train.step.make_train_step`` on a one-device mesh
and ``repro.train.serve.generate`` on the global batch from the same
weights, and holds the ranks to the reference's limits
(``tests/dist/test_transformer.py:92-100``): loss atol 1e-5,
``grad_norm`` rtol 1e-4, weights atol 2e-5 rtol 1e-4; greedy tokens
equal. The reference is imported inside functions only, so the spawned
ranks do not import JAX.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch import sharding as sh
from repro_torch.comm.overlap import tree_flatten
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.launch.mesh import (MeshAxis, ProcessMesh, make_mesh,
                                     spawn_mesh)
from repro_torch.models.model import (build_model, state_to_reference,
                                      to_reference)
from repro_torch.train.loop import TrainLoopConfig, train_loop
from repro_torch.train.serve import generate, make_paged_decode_step
from repro_torch.train.step import (gather_state, init_train_state,
                                    make_train_step, shard_state)

RANKS = 4
B, S, STEPS = 4, 32, 2
PROMPT, NEW = 128, 4
LIMITS = dict(loss_atol=1e-5, gn_rtol=1e-4, atol=2e-5, rtol=1e-4)
MESHES = {"2x2": ((2, 2), ("data", "model")), "1x4": ((1, 4),
                                                     ("data", "model")),
          "ring": ((4,), ("x",))}
# leg -> (mesh, zero1, fsdp)
LEGS = {"2x2/zero1": ("2x2", True, False), "2x2/no_zero1": ("2x2", False,
                                                            False),
        "2x2/fsdp": ("2x2", True, True), "1x4": ("1x4", True, False)}
GEN_MESHES = ("2x2", "1x4")
MOE_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/dist/test_moe.py:106


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
    return dataclasses.replace(
        configs.reduced(configs.get_config("llama3.2-3b"), layers=2),
        num_kv_heads=2)


def _moe_cfg():
    return configs.reduced(configs.get_config("qwen3-moe-235b-a22b"),
                           layers=2)


def _run():
    return configs.RunConfig(learning_rate=1e-3, warmup_steps=1)


def _batches(cfg):
    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, B, S))
    return [data.batch(s) for s in range(STEPS)]


def _prompts(cfg):
    g = torch.Generator().manual_seed(7)
    return torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=g,
                         dtype=torch.int32)


def _leaves(tree):
    return [t.detach().numpy().copy() for t in tree_flatten(tree)[0]]


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------


def _steps(model, mesh, zero1, fsdp, batches):
    state = shard_state(init_train_state(model, 0, device="cpu"), mesh,
                        zero1=zero1, fsdp=fsdp)
    shapes = {"param": tuple(state.params.embed.shape),
              "mu": tuple(state.opt["mu"]["embed"].shape)}
    step = make_train_step(model, _run(), mesh, zero1=zero1, fsdp=fsdp)
    metrics = []
    for batch in batches:
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    whole = gather_state(state, model, mesh, zero1=zero1, fsdp=fsdp)
    return {"metrics": metrics, "shapes": shapes,
            "params": _leaves(whole.params.tree()) if mesh.rank == 0
            else None}


def _generate_with_spy(model, mesh):
    from repro_torch.kernels import ops
    calls = []
    orig = ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append({"q": tuple(q.shape), "k": tuple(k.shape), **kw})
        return orig(q, k, v, **kw)

    ops.flash_attention = spy
    try:
        out = generate(model, model.init(0, device="cpu"),
                       _prompts(model.cfg), max_new_tokens=NEW, mesh=mesh)
    finally:
        ops.flash_attention = orig
    return {"tokens": out.numpy(), "flash": calls}


def _prefill_whole_heads(mesh):
    """Prefill of 128-token prompts on ``mesh`` by a model whose 6 q heads
    its tp axis does not divide: the attention stays whole, and
    ``_flash_sharded`` returns None as the reference's does, so no flash
    call is made; the one-rank plain prefill of the same prompts beside
    it."""
    from repro_torch.kernels import ops
    from repro_torch.train.serve import make_prefill_step

    model = build_model(dataclasses.replace(_cfg(), num_heads=6))
    params = model.init(0, device="cpu")
    local = type(params)(model.cfg, sh.cut(params.tree(), sh.param_specs(
        params, sh.rules_for(mesh), mesh), mesh))
    batch = {"tokens": _prompts(model.cfg)}
    calls = []
    orig = ops.flash_attention

    def spy(*a, **kw):
        calls.append(kw)
        return orig(*a, **kw)

    ops.flash_attention = spy
    try:
        got = make_prefill_step(model, mesh)(local, batch, model.init_cache(
            B, PROMPT, torch.float32, device="cpu", mesh=mesh))[0]
    finally:
        ops.flash_attention = orig
    want = make_prefill_step(model, None)(params, batch, model.init_cache(
        B, PROMPT, torch.float32, device="cpu"))[0]
    return {"flash": calls, "logits": got.numpy(), "plain": want.numpy()}


def _loop(mesh, root):
    cfg = configs.reduced(configs.get_config("llama3.2-3b"), layers=1)
    data = DataConfig(cfg.vocab_size, B, 16)
    out = {}
    for name, runs in (("resumed", (2, 4)), ("straight", (4,))):
        run = dataclasses.replace(_run(), checkpoint_dir=os.path.join(
            root, name), checkpoint_every=100)
        out[name] = [train_loop(cfg, run, data,
                                TrainLoopConfig(steps=n, log_every=100),
                                mesh=mesh, device="cpu")["loss"]
                     for n in runs]
    return out


def _rank(mesh, root):
    from repro_torch.benchmarks import lm_step_bench

    meshes = {name: make_mesh(*spec) for name, spec in MESHES.items()}
    cfg = _cfg()
    model = build_model(cfg)
    batches = _batches(cfg)
    out = {"layout": {name: [(a.name, a.size, a.index, a.ranks)
                             for a in m.axes]
                      for name, m in meshes.items()}}
    out["steps"] = {leg: _steps(model, meshes[m], z, f, batches)
                    for leg, (m, z, f) in LEGS.items()}
    out["generate"] = {m: _generate_with_spy(model, meshes[m])
                       for m in GEN_MESHES}
    out["whole_heads"] = _prefill_whole_heads(meshes["1x4"])
    moe = build_model(_moe_cfg())
    out["moe"] = _steps(moe, meshes["ring"], True, False, _batches(moe.cfg))
    out["loop"] = _loop(meshes["2x2"], root)
    rec = lm_step_bench.moe_explicit_rank(meshes["ring"], "auto", 16, "cpu")
    out["moe_explicit"] = rec
    return out


# ---------------------------------------------------------------------------
# the world and the reference
# ---------------------------------------------------------------------------


def _reference_steps(cfg, state_np, batches):
    import jax

    from repro import configs as jconfigs
    from repro.models.model import build_model as jbuild_model
    from repro.train import step as jstep

    jmodel = jbuild_model(jconfigs.ModelConfig(**dataclasses.asdict(cfg)))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("x",))
    st, ref = jstep.TrainState(**state_np), []
    jfn = jstep.make_train_step(jmodel, jconfigs.RunConfig(
        **dataclasses.asdict(_run())), mesh, donate=False).lower(
        st, batches[0]).compile(compiler_options={
            "xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True})
    for batch in batches:
        st, m = jfn(st, batch)
        st = jax.tree.map(np.asarray, st)
        ref.append({k: float(v) for k, v in m.items()})
    return ref, st.params, jmodel


@pytest.fixture(scope="module")
def world():
    root = tempfile.mkdtemp(prefix="test_torch_gspmd_")
    try:
        ranks = spawn_mesh(RANKS, _rank, root, axes=("x",), timeout=300)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    import jax.numpy as jnp

    from repro.train import serve as jserve

    cfg = _cfg()
    model = build_model(cfg)
    state = init_train_state(model, 0, device="cpu")
    ref, ref_params, jmodel = _reference_steps(
        cfg, state_to_reference(state), _batches(cfg))
    ref_params = _leaves(_from_np(cfg, ref_params).tree())
    jparams = to_reference(model.init(0, device="cpu"))
    tokens = np.asarray(jserve.generate(
        jmodel, jparams, jnp.asarray(_prompts(cfg).numpy()),
        max_new_tokens=NEW))

    moe = build_model(_moe_cfg())
    mstate = init_train_state(moe, 0, device="cpu")
    step = make_train_step(moe, _run())
    moe_ref = []
    for batch in _batches(moe.cfg):
        mstate, m = step(mstate, batch)
        moe_ref.append({k: float(v) for k, v in m.items()})
    return dict(ranks=ranks, ref=ref,
                ref_params=ref_params, tokens=tokens,
                moe_ref=moe_ref, moe_params=_leaves(mstate.params.tree()))


def _from_np(cfg, params_np):
    from repro_torch.models.model import from_reference
    return from_reference(cfg, params_np, device="cpu")


def _hold(got, want_metrics, want_params, tag, limits=LIMITS):
    for g, w in zip(got["metrics"], want_metrics):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=0,
                                   atol=limits["loss_atol"], err_msg=tag)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=limits["gn_rtol"], err_msg=tag)
    if got["params"] is not None:
        assert len(got["params"]) == len(want_params)
        for a, b in zip(got["params"], want_params):
            np.testing.assert_allclose(a, b, atol=limits["atol"],
                                       rtol=limits["rtol"], err_msg=tag)


# ---------------------------------------------------------------------------
# the meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MESHES))
def test_make_mesh_is_row_major(world, name):
    shape, names = MESHES[name]
    for g, rank in enumerate(world["ranks"]):
        coord = np.unravel_index(g, shape)
        for d, (axis, size, index, ranks) in enumerate(
                rank["layout"][name]):
            assert (axis, size, index) == (names[d], shape[d], coord[d])
            want = [int(np.ravel_multi_index(
                tuple(coord[:d]) + (i,) + tuple(coord[d + 1:]), shape))
                for i in range(shape[d])]
            assert list(ranks) == want


# ---------------------------------------------------------------------------
# the train step against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_step_matches_reference(world, leg):
    for rank in world["ranks"]:
        _hold(rank["steps"][leg], world["ref"], world["ref_params"], leg)
    assert world["ranks"][0]["steps"][leg]["params"] is not None


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_ranks_agree_on_the_metrics(world, leg):
    got = world["ranks"][0]["steps"][leg]["metrics"]
    for rank in world["ranks"][1:]:
        assert rank["steps"][leg]["metrics"] == got, leg


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_state_layout(world, leg):
    """The embedding split over the vocabulary on ``model``; its moments
    also over ``data`` under ZeRO-1, and the weight too under FSDP."""
    cfg = _cfg()
    V, D = cfg.padded_vocab(), cfg.d_model
    mesh, zero1, fsdp = LEGS[leg]
    dp, tp = MESHES[mesh][0]
    param = (V // tp, D // dp if fsdp else D)
    mu = (V // tp, D // dp if (zero1 or fsdp) else D)
    for rank in world["ranks"]:
        assert rank["steps"][leg]["shapes"] == {"param": param, "mu": mu}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", GEN_MESHES)
def test_generate_matches_reference(world, mesh):
    (dp, _), _ = MESHES[mesh]
    b = B // dp
    for g, rank in enumerate(world["ranks"]):
        rows = (g // (RANKS // dp)) * b
        got = rank["generate"][mesh]["tokens"]
        assert got.shape == (b, PROMPT + NEW)
        np.testing.assert_array_equal(got, world["tokens"][rows:rows + b])


@pytest.mark.parametrize("mesh", GEN_MESHES)
def test_flash_sharded_takes_the_kernel_on_local_heads(world, mesh):
    """One flash call per layer in prefill and none in decode, on this
    rank's rows and q heads and the KV block they map to, with the
    reference's ``bq = bk = min(512, S)``."""
    cfg = _cfg()
    (dp, tp), _ = MESHES[mesh]
    h_loc = cfg.num_heads // tp
    kv_loc = cfg.num_kv_heads // tp if cfg.num_kv_heads % tp == 0 \
        else max(h_loc // (cfg.num_heads // cfg.num_kv_heads), 1)
    want = {"q": (B // dp, PROMPT, h_loc, cfg.head_dim),
            "k": (B // dp, PROMPT, kv_loc, cfg.head_dim),
            "causal": True, "bq": PROMPT, "bk": PROMPT}
    for rank in world["ranks"]:
        assert rank["generate"][mesh]["flash"] == [want] * cfg.num_layers


def test_flash_sharded_leaves_heads_tp_does_not_divide(world):
    """On 1x4 a model with 6 q heads keeps its attention whole: prefill
    makes no flash call (the reference's ``H % tp_n`` rule) and its logits
    are the one-rank plain prefill's."""
    for rank in world["ranks"]:
        rec = rank["whole_heads"]
        assert rec["flash"] == []
        np.testing.assert_allclose(rec["logits"], rec["plain"],
                                   atol=LIMITS["atol"], rtol=LIMITS["rtol"])


# ---------------------------------------------------------------------------
# the MoE step on the ring, the loop, the bench section
# ---------------------------------------------------------------------------


def test_moe_ring_step_matches_one_rank(world):
    for rank in world["ranks"]:
        _hold(rank["moe"], world["moe_ref"], world["moe_params"], "moe")
    n = world["ranks"][0]["moe"]["shapes"]
    cfg = _moe_cfg()
    assert n == {"param": (cfg.padded_vocab(), cfg.d_model),
                 "mu": (cfg.padded_vocab() // RANKS, cfg.d_model)}


def test_train_loop_resumes_into_state_specs(world):
    """Two steps then a resume to four from the final checkpoint (whole
    arrays, cut again by ``shard_state``) give the uninterrupted run's
    losses bit for bit."""
    for rank in world["ranks"]:
        loop = rank["loop"]
        first, resumed = loop["resumed"]
        straight, = loop["straight"]
        assert len(first) == 2 and len(resumed) == 2 and len(straight) == 4
        assert first + resumed == straight
        assert all(np.isfinite(straight))


def test_moe_explicit_section(world):
    from repro_torch.benchmarks import lm_step_bench

    per_rank = [r["moe_explicit"] for r in world["ranks"]]
    rec = lm_step_bench.moe_explicit_record(per_rank, "auto", 16, "cpu")
    assert rec["max_abs_err_vs_gspmd"] <= MOE_TOL["atol"]
    assert all(r["within_tolerance"] for r in per_rank)
    assert rec["ranks_agree"] and np.isfinite(rec["dp_loss"])
    assert lm_step_bench.gate_resolved(rec) == []


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def _wide():
    return ProcessMesh(axes=(MeshAxis("data", 2, 0, (0, 2)),
                             MeshAxis("model", 2, 0, (0, 1))))


def test_paged_decode_on_a_wide_mesh_waits_for_a13():
    """The paged decode builds on a wide mesh for every attention-only
    family, the MoE's too (the name is kept from when it waited for A13);
    its runs are ``tests/test_torch_gspmd_families.py``'s."""
    assert callable(make_paged_decode_step(build_model(_cfg()), _wide()))
    assert callable(make_paged_decode_step(build_model(_moe_cfg()),
                                           _wide()))


@pytest.mark.parametrize("arch", ["mamba2-130m", "llama-3.2-vision-90b",
                                  "whisper-base"])
def test_tp_on_other_families_raises(arch):
    """The SSM, vlm and encoder-decoder families run over a ``model``
    axis of 2 now (the name is kept from when they raised): on the meta
    device over a dry 2x2 mesh, with this rank's part of the weights, the
    logits come back whole over the vocabulary, and the layers' ``tp``
    collectives are engine calls under ``gspmd.tp``."""
    from repro_torch.comm import dry
    from repro_torch.launch.mesh import dry_mesh

    cfg = configs.reduced(configs.get_config(arch), layers=2)
    model = build_model(cfg)
    wide = dry_mesh((2, 2), ("data", "model"))
    shard = sh.make_shard_fn(wide, sh.rules_for(wide))
    whole = model.init(0, device="meta")
    params = type(whole)(cfg, sh.cut(whole.tree(), sh.param_specs(
        whole, shard.rules, wide), wide, copy=False))
    batch = {"tokens": torch.zeros((2, 4), dtype=torch.int32,
                                   device="meta")}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.empty(
            (2, cfg.num_patches, cfg.vision_dim), device="meta")
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.empty((2, cfg.audio_ctx, cfg.d_model),
                                      device="meta")
    dry.reset()
    with torch.no_grad():
        logits = model.apply(params, batch, shard=shard)[0]
    assert logits.shape == (2, 4, cfg.padded_vocab())
    assert {o.source for o in dry.ops()} == {"gspmd.tp", "gspmd.logits"}
    dry.reset()
