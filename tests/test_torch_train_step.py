"""The port's one-rank train step on the CPU, held against the JAX reference.

Six reduced families, fp32, one initial weights-and-AdamW state carried
into each package (``state_to_reference`` / ``state_from_reference``):
dense llama3.2-3b with GQA
(``num_kv_heads=2``: ``reduced()`` drops GQA, ROADMAP C8), qwen3-moe,
mamba2, jamba at 4 layers (SSM and attention layers), the vlm with its
cross gates opened from a numpy seed (the reference starts them at 0, which
hides the cross branch) and whisper. Each takes two steps of
``make_train_step`` (lr 1e-2 from the first step, remat ``none``) on one
batch of synthetic tokens, beside ``repro.train.step.make_train_step`` on
the same inputs. The gradients are held through ``mu`` after the first
step, which is (1 - b1) times the clipped gradient.

Tolerances, each with the largest difference measured over the six
families: loss rtol 1e-5 (6.2e-7) and ``grad_norm`` rtol 3e-5 (4.2e-6):
the port sums in other orders; ``lr`` exact; ``mu`` after step 1 atol 1e-7
(6.5e-9: the clipped gradient within 1e-6); after step 2 ``mu`` atol 2e-5
(3.4e-6) and ``nu`` atol 1e-6 (4.1e-8), the second gradient being taken
at weights that already differ; the weights after either step atol 1e-3,
a tenth of one step's largest move (2.6e-4): AdamW's first moves are lr *
g / (|g| + eps), so a gradient element near 0 whose last bits differ
moves its weight by a visible fraction of lr.

Port-only checks: every architecture of ``list_archs()`` trains at its
reduced size (loss falls, nothing is NaN); ``microbatches`` 1, 2 and 4
agree; the remat policies give bit-identical losses and gradients; serving
builds no autograd graph from trainable weights.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.comm.callsites import DP_GRADS as JDP_GRADS
from repro.models.model import build_model as jbuild_model
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.comm.callsites import DP_GRADS
from repro_torch.comm.overlap import tree_flatten
from repro_torch.launch.mesh import single_rank_mesh
from repro_torch.models import transformer
from repro_torch.models.model import (build_model, next_token_loss,
                                      state_from_reference,
                                      state_to_reference)
from repro_torch.train import serve
from repro_torch.train.step import (GRADS_CALLSITE, TrainState,
                                    init_train_state, make_train_step)

LR = 1e-2
B, S = 2, 16
FAMILIES = {"gqa": ("llama3.2-3b", 2), "qwen3-moe": ("qwen3-moe-235b-a22b", 2),
            "mamba2": ("mamba2-130m", 2), "jamba": ("jamba-1.5-large-398b", 4),
            "vlm": ("llama-3.2-vision-90b", 4), "whisper": ("whisper-base", 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's tiny models: under six test
    workers the default (one thread per core in every process)
    oversubscribes the cores and slows each small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(family):
    arch, layers = FAMILIES[family]
    cfg = configs.reduced(configs.get_config(arch), layers=layers,
                          d_model=64)
    return dataclasses.replace(cfg, num_kv_heads=2) if family == "gqa" \
        else cfg


def _batch(cfg, seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.vision_dim)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal(
            (b, cfg.audio_ctx, cfg.d_model)).astype(np.float32)
    return batch


# XLA's options for compiling the reference's step: the same HLO with
# LLVM's backend optimizations off, which halves the compile's CPU time
# (six families: about 74 s of CPU in three threads to 38 s); the losses
# agree with the default build's to nine digits
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def reference_step(jfn, state, batch):
    """The jitted reference step ``jfn`` compiled under
    :data:`FAST_COMPILE` for the avals of ``(state, batch)``."""
    return jfn.lower(state, batch).compile(compiler_options=FAST_COMPILE)


def _np_state(state):
    return jax.tree.map(np.asarray, state)


@pytest.fixture(scope="module", params=list(FAMILIES))
def run(request):
    cfg = _cfg(request.param)
    jmodel = jbuild_model(jconfigs.ModelConfig(**dataclasses.asdict(cfg)))
    # one initial state in the reference's layout for both packages (the
    # port draws it: the reference's eager init takes seconds per model)
    state0 = jstep.TrainState(**state_to_reference(
        init_train_state(build_model(cfg), 0, device="cpu")))
    if cfg.family == "vlm":
        rng = np.random.default_rng(1)
        for block in state0.params["blocks"].values():
            if "cross_gate" in block:
                block["cross_gate"] = rng.uniform(
                    0.5, 1.0, block["cross_gate"].shape).astype(np.float32)
    batch = _batch(cfg)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("x",))
    jfn = reference_step(jstep.make_train_step(jmodel, jconfigs.RunConfig(
        remat="none", learning_rate=LR, warmup_steps=0), mesh, donate=False),
        state0, batch)
    want, wmetrics, st = [], [], state0
    for _ in range(2):
        st, m = jfn(st, batch)
        st = _np_state(st)
        want.append(st)
        wmetrics.append({k: float(v) for k, v in m.items()})

    state = state_from_reference(cfg, state0, device="cpu")
    fn = make_train_step(build_model(cfg), configs.RunConfig(
        remat="none", learning_rate=LR, warmup_steps=0))
    got, gmetrics = [], []
    for _ in range(2):
        state, m = fn(state, batch)
        got.append(state_to_reference(state))
        gmetrics.append({k: float(v) for k, v in m.items()})
    return dict(cfg=cfg, want=want, wmetrics=wmetrics, got=got,
                gmetrics=gmetrics)


def _leaves(tree):
    return jax.tree.leaves(tree)


def _assert_close(got, want, atol, rtol=0.0):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_loss_and_lr_match_reference(run):
    for g, w in zip(run["gmetrics"], run["wmetrics"]):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        assert g["lr"] == w["lr"]
    assert run["gmetrics"][1]["loss"] < run["gmetrics"][0]["loss"]


def test_grad_norm_matches_reference(run):
    for g, w in zip(run["gmetrics"], run["wmetrics"]):
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=3e-5)


def test_gradients_match_reference(run):
    """``mu`` after one step is (1 - b1) x the clipped gradient."""
    _assert_close(run["got"][0]["opt"]["mu"], run["want"][0].opt["mu"],
                  atol=1e-7)


@pytest.mark.parametrize("after", [1, 2])
def test_state_matches_reference(run, after):
    got, want = run["got"][after - 1], run["want"][after - 1]
    _assert_close(got["params"], want.params, atol=1e-3)
    _assert_close(got["opt"]["mu"], want.opt["mu"], atol=2e-5)
    _assert_close(got["opt"]["nu"], want.opt["nu"], atol=1e-6)
    assert int(got["opt"]["count"]) == int(want.opt["count"]) == after
    assert int(got["step"]) == int(want.step) == after


def test_state_round_trips_through_reference_layout():
    """A state in the reference's layout (its ``init_train_state``'s
    structure, shapes and dtypes, values from a numpy seed) comes back
    bit for bit through the port's state."""
    cfg = _cfg("gqa")
    jmodel = jbuild_model(jconfigs.ModelConfig(**dataclasses.asdict(cfg)))
    shapes = jax.eval_shape(lambda key: jstep.init_train_state(
        jmodel, key, compression_on=True), jax.random.key(1))
    rng = np.random.default_rng(1)
    state0 = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype)
        if a.dtype == np.float32 else np.zeros(a.shape, a.dtype), shapes)
    state = state_from_reference(cfg, state0, device="cpu")
    assert isinstance(state, TrainState)
    assert all(p.requires_grad for p in state.params.parameters())
    back = state_to_reference(state)
    assert jax.tree.structure(back["params"]) == \
        jax.tree.structure(state0.params)
    for tree, ref in ((back["params"], state0.params),
                      (back["opt"], state0.opt),
                      (back["error"], state0.error)):
        for a, b in zip(_leaves(tree), _leaves(ref)):
            np.testing.assert_array_equal(a, b)
    assert int(back["step"]) == int(state0.step) == 0


@pytest.mark.parametrize("compression_on", [False, True])
def test_init_train_state(compression_on):
    cfg = _cfg("gqa")
    model = build_model(cfg)
    state = init_train_state(model, 0, compression_on=compression_on,
                             device="cpu")
    served = model.init(0, device="cpu")
    assert all(p.requires_grad for p in state.params.parameters())
    assert not any(p.requires_grad for p in served.parameters())
    for a, b in zip(tree_flatten(state.params.tree())[0],
                    tree_flatten(served.tree())[0]):
        assert torch.equal(a, b)
    for name in ("mu", "nu"):
        leaves = tree_flatten(state.opt[name])[0]
        assert all(t.dtype == torch.float32 and not t.any() for t in leaves)
    assert int(state.opt["count"]) == int(state.step) == 0
    assert (state.error is not None) == compression_on


def test_grads_callsite_is_the_reference_tag():
    assert GRADS_CALLSITE == DP_GRADS == jstep.GRADS_CALLSITE == JDP_GRADS


# ---------------------------------------------------------------------------
# port only
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", configs.list_archs())
def test_every_architecture_trains(arch):
    cfg = configs.reduced(configs.get_config(arch),
                          layers=4 if arch.startswith("jamba") else 2)
    model = build_model(cfg)
    state = init_train_state(model, 0, device="cpu")
    fn = make_train_step(model, configs.RunConfig(learning_rate=LR,
                                                  warmup_steps=0))
    batch = _batch(cfg, seed=3)
    losses = []
    for _ in range(4):
        state, m = fn(state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(bool(torch.isfinite(p).all())
               for p in state.params.parameters())


@pytest.mark.parametrize("micro", [2, 4])
def test_microbatches_agree(micro):
    """Gradient accumulation over the batch-major split gives the step of
    the whole batch; a batch that does not split raises."""
    cfg = _cfg("gqa")
    model = build_model(cfg)
    batch = _batch(cfg, seed=4, b=4)
    out = {}
    for m in (1, micro):
        state = init_train_state(model, 0, device="cpu")
        fn = make_train_step(model, configs.RunConfig(
            learning_rate=LR, warmup_steps=0, microbatches=m))
        state, metrics = fn(state, batch)
        out[m] = (metrics, state)
    (m1, s1), (mk, sk) = out[1], out[micro]
    np.testing.assert_allclose(float(mk["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(mk["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    for a, b in zip(tree_flatten(sk.opt["mu"])[0],
                    tree_flatten(s1.opt["mu"])[0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7)
    for a, b in zip(sk.params.parameters(), s1.params.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-3)
    fn = make_train_step(model, configs.RunConfig(microbatches=micro))
    with pytest.raises(ValueError, match="microbatches"):
        fn(init_train_state(model, 0, device="cpu"), _batch(cfg, b=micro + 1))


def _loss_and_grads(model, params, batch, remat):
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    logits, _, _ = model.apply(params, batch, remat=remat)
    loss = next_token_loss(logits, batch["tokens"])
    leaves = tree_flatten(params.tree(data=False))[0]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), grads


@pytest.mark.parametrize("family", ["gqa", "jamba", "vlm", "whisper"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_is_bitwise(family, remat):
    cfg = _cfg(family)
    model = build_model(cfg)
    params = init_train_state(model, 0, device="cpu").params
    batch = _batch(cfg, seed=5)
    loss0, g0 = _loss_and_grads(model, params, batch, "none")
    loss1, g1 = _loss_and_grads(model, params, batch, remat)
    assert torch.equal(loss0, loss1)
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def test_unknown_remat_policy_raises():
    assert transformer.REMAT_POLICIES == ("none", "full", "dots")
    cfg = _cfg("gqa")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    with pytest.raises(ValueError, match="remat policy"):
        model.apply(params, {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
                    remat="everything")


def test_serving_builds_no_graph_from_trainable_weights():
    """After ``init_train_state`` the weights want gradients, yet the
    serving steps' outputs carry no ``grad_fn``."""
    cfg = _cfg("gqa")
    model = build_model(cfg)
    state = init_train_state(model, 0, device="cpu")
    prompts = torch.from_numpy(_batch(cfg)["tokens"])
    cache = model.init_cache(B, S + 4, torch.float32, device="cpu")
    logits, cache = serve.make_prefill_step(model)(
        state.params, {"tokens": prompts}, cache)
    assert logits.grad_fn is None and not logits.requires_grad
    logits, cache = serve.make_decode_step(model)(
        state.params, prompts[:, -1:], cache, {})
    assert logits.grad_fn is None
    assert all(t.grad_fn is None for layer in cache["layers"]
               for t in layer.values())
    out = serve.generate(model, state.params, prompts, max_new_tokens=3,
                         mesh=single_rank_mesh(("x",)))
    assert out.grad_fn is None and out.shape == (B, S + 3)
    assert all(p.grad is None for p in state.params.parameters())


def test_one_rank_step_refuses_a_wide_mesh():
    """The step takes a wide mesh now (tests/test_torch_gspmd.py); what it
    still refuses there is FSDP weights on the encoder-decoder."""
    from repro_torch.launch.mesh import MeshAxis, ProcessMesh
    model = build_model(configs.reduced(configs.get_config("whisper-base"),
                                        layers=2))
    wide = ProcessMesh(axes=(MeshAxis("x", 2, 0, (0, 1)),))
    with pytest.raises(NotImplementedError, match="A15"):
        make_train_step(model, configs.RunConfig(), wide, fsdp=True)


def test_step_updates_the_state_in_place():
    """The step returns the state it was given, its weights the same
    tensors with new values, and the step count advanced."""
    cfg = _cfg("gqa")
    model = build_model(cfg)
    state = init_train_state(model, 0, device="cpu")
    leaves = tree_flatten(state.params.tree(data=False))[0]
    before = [t.detach().clone() for t in leaves]
    fn = make_train_step(model, configs.RunConfig(learning_rate=LR,
                                                  warmup_steps=0))
    new, _ = fn(state, _batch(cfg))
    assert new is state and int(state.step) == 1
    after = tree_flatten(state.params.tree(data=False))[0]
    assert all(a is b for a, b in zip(after, leaves))
    assert any(not torch.equal(a, b) for a, b in zip(after, before))


def test_lm_step_bench(monkeypatch):
    """The per-architecture timings on the CPU at one architecture, the
    module's registration, and its refusal to run without a card unless
    asked for the CPU."""
    from repro_torch.benchmarks import lm_step_bench
    from repro_torch.benchmarks import run as bench_run

    rec = lm_step_bench.arch_steps("llama3.2-3b", torch.device("cpu"))
    assert rec["train_step_s"] > 0 and rec["decode_step_s"] > 0
    assert np.isfinite(rec["loss"])
    assert "lm_step_bench" in bench_run.MODULES
    # the whole-model section brought back the schedule parameter
    assert "lm_step_bench" in bench_run._SCHEDULED
    assert bench_run.ALIASES["lm"] == "lm_step_bench"
    # the moe_explicit section came with the GSPMD placement on several
    # ranks (tests/test_torch_gspmd.py runs it), the production roofline
    # with the dry run (tests/test_torch_dryrun.py reads it)
    assert lm_step_bench.NOT_PORTED == {}
    assert callable(lm_step_bench.production_roofline_section)
    assert callable(lm_step_bench.moe_explicit_section)
    assert callable(lm_step_bench.whole_model_section)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_step_bench.main(quick=True)
