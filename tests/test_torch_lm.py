"""The port's LM serving slice on the CPU, held against the JAX reference:
configs, weights, ``transformer.apply`` in train, prefill and decode, and
``generate`` with and without the one-rank mesh.

The reference's weights (``model.init(jax.random.key(0))``) move to the port
with ``from_reference``; prompts come from a numpy seed. The models, all
at d_model 64 in fp32: ``reduced(llama3.2-3b, layers=2)`` (four heads,
MHA), its GQA variant (``num_kv_heads=2``) and its qk-norm variant; reduced
qwen3-moe (MoE every layer, qk-norm), llama4-maverick (MoE every 2nd
layer, shared expert) and mamba2 (SSM, no attention), at 2 layers; and
reduced jamba at 4 layers (SSM, attention, SSM, attention; MoE every 2nd
layer). Prompts have 128 tokens so that the mesh path reaches the flash
kernel (one call per attention layer, counted with a spy on
``ops.flash_attention``; on the CPU it runs its plain version, as the
reference runs its Pallas kernel in interpret mode). Logits and caches
agree within 1e-5 and greedy tokens exactly. The EOS tests mirror
``tests/test_serve.py``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch.mesh import make_mesh
from repro.models.model import build_model as jbuild_model
from repro.models.model import next_token_loss as jnext_token_loss
from repro.train import serve as jserve
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch.mesh import single_rank_mesh
from repro_torch.models import transformer
from repro_torch.models.model import (build_model, from_reference,
                                      next_token_loss, to_reference)
from repro_torch.train import serve

ATOL = 1e-5
B, S0, NEW = 2, 128, 8


def _jcfg(cfg):
    return jconfigs.ModelConfig(**dataclasses.asdict(cfg))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# configs: copies of the reference's
# ---------------------------------------------------------------------------


def test_arch_registry_matches_reference():
    assert configs.list_archs() == jconfigs.list_archs()
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert dataclasses.asdict(configs.RunConfig()) == \
        dataclasses.asdict(jconfigs.RunConfig())


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_config_matches_reference(arch):
    got, want = configs.get_config(arch), jconfigs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for a, b in ((got, want), (configs.reduced(got), jconfigs.reduced(want))):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.padded_vocab() == b.padded_vocab()
        assert a.layer_kinds() == b.layer_kinds()
        assert a.moe_layer_mask() == b.moe_layer_mask()
        assert a.cross_attn_mask() == b.cross_attn_mask()
        assert a.param_count() == b.param_count()
        assert a.param_count(active_only=True) == \
            b.param_count(active_only=True)
        for shape in configs.SHAPES.values():
            assert configs.cell_is_applicable(a, shape) == \
                jconfigs.cell_is_applicable(b, jconfigs.shape_for(shape.name))


def test_serving_config_is_llama3_2_3b():
    cfg = configs.get_config("llama3.2-3b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.rope_theta,
            cfg.dtype, cfg.param_dtype) == (28, 3072, 24, 8, 128, 8192,
                                            128256, 5e5, "bfloat16",
                                            "float32")
    assert cfg.param_count() == 3_212_835_840


@pytest.mark.parametrize("arch", [a for a in jconfigs.list_archs()
                                  if jconfigs.get_config(a).family != "dense"]
                         + ["llama3.2-3b with qk-norm"])
def test_unported_families_raise(arch):
    """Every family is served now: the MoE, SSM, hybrid and qk-norm ones,
    vision cross-attention and the encoder-decoder. ``build_model`` takes
    the full configuration, and its reduced form runs a forward on the CPU
    (vlm with patch embeddings, whisper with frames)."""
    cfg = dataclasses.replace(configs.get_config("llama3.2-3b"),
                              use_qk_norm=True) if arch.endswith("qk-norm") \
        else configs.get_config(arch)
    assert build_model(cfg).cfg == cfg
    small = configs.reduced(cfg, layers=4)
    model = build_model(small)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, small.vocab_size, (1, 8)).astype(np.int32))}
    if small.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (1, small.num_patches, small.vision_dim)).astype(np.float32))
    if small.is_encoder_decoder:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (1, small.audio_ctx, small.d_model)).astype(np.float32))
    logits, _, _ = model.apply(model.init(0, device="cpu"), batch)
    assert logits.shape == (1, 8, small.padded_vocab())
    assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# the reduced models, weights from the reference
# ---------------------------------------------------------------------------

FAMILY_ARCHS = {"qwen3-moe": ("qwen3-moe-235b-a22b", 2),
                "maverick": ("llama4-maverick-400b-a17b", 2),
                "mamba2": ("mamba2-130m", 2),
                "jamba": ("jamba-1.5-large-398b", 4)}


def _reduced(kind):
    if kind in FAMILY_ARCHS:
        arch, layers = FAMILY_ARCHS[kind]
        return configs.reduced(configs.get_config(arch), layers=layers,
                               d_model=64)
    cfg = configs.reduced(configs.get_config("llama3.2-3b"), layers=2,
                          d_model=64)
    if kind == "qk-norm":
        return dataclasses.replace(cfg, use_qk_norm=True)
    return cfg if kind == "mha" else dataclasses.replace(cfg, num_kv_heads=2)


def _n_attn(cfg):
    """Attention layers: one flash call each in a mesh prefill."""
    return sum(kind == "attn" for kind in cfg.layer_kinds())


@pytest.fixture(scope="module", params=["mha", "gqa", "qk-norm",
                                        *FAMILY_ARCHS])
def setup(request):
    cfg = _reduced(request.param)
    jmodel = jbuild_model(_jcfg(cfg))
    jparams = jmodel.init(jax.random.key(0))
    params_np = jax.tree.map(np.asarray, jparams)
    model = build_model(cfg)
    params = from_reference(cfg, params_np, device="cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S0)).astype(np.int32)
    return dict(cfg=cfg, jmodel=jmodel, jparams=jparams, params_np=params_np,
                model=model, params=params, prompts=prompts)


@pytest.fixture
def flash_calls(monkeypatch):
    calls = []
    orig = ops.flash_attention

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    return calls


def test_reduced_gqa_variant_keeps_grouped_heads(setup):
    cfg = setup["cfg"]
    assert cfg.num_heads == 4
    assert cfg.num_kv_heads in ((0,) if cfg.family == "ssm" else (4, 2))


def test_from_reference_round_trip_is_bitwise(setup):
    back = to_reference(setup["params"])
    want = setup["params_np"]
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for got, exp in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert got.dtype == exp.dtype and got.shape == exp.shape
        assert np.array_equal(got.view(np.uint32), exp.view(np.uint32))


def test_init_params_has_the_reference_layout(setup):
    cfg = setup["cfg"]
    params = build_model(cfg).init(0, device="cpu")
    back = to_reference(params)
    want = setup["params_np"]
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for got, exp in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert got.dtype == exp.dtype and got.shape == exp.shape
    # seeded: the same seed draws the same weights
    again = to_reference(build_model(cfg).init(0, device="cpu"))
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(back), jax.tree.leaves(again)))
    lp = params.blocks[0]
    w = lp["attn"]["wq"] if "attn" in lp else lp["ssm"]["in_x"]
    assert abs(float(w.std()) - 0.02) < 2e-3


def test_entry_points_default_to_the_card(monkeypatch, setup):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        setup["model"].init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_reference(setup["cfg"], setup["params_np"])


def test_apply_train_logits_and_loss(setup):
    tokens = setup["prompts"]
    jlogits, _, _ = setup["jmodel"].apply(setup["jparams"],
                                          {"tokens": jnp.asarray(tokens)})
    logits, cache, _ = setup["model"].apply(
        setup["params"], {"tokens": torch.from_numpy(tokens)})
    assert cache is None
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        float(next_token_loss(logits, torch.from_numpy(tokens))),
        float(jnext_token_loss(jlogits, jnp.asarray(tokens))),
        atol=ATOL, rtol=0)


@pytest.mark.parametrize("mesh_on", [False, True], ids=["no_mesh", "mesh"])
def test_prefill_and_decode_match_reference(setup, flash_calls, mesh_on):
    """Prefill then two decode steps: logits and every layer's cache (k/v,
    or the SSM conv and state) within 1e-5 of the reference, with one
    flash call per attention layer in the mesh prefill and none
    elsewhere."""
    cfg, tokens = setup["cfg"], setup["prompts"]
    max_seq = S0 + 4
    jmesh = make_mesh((1,), ("x",)) if mesh_on else None
    mesh = single_rank_mesh(("x",)) if mesh_on else None
    jcache = setup["jmodel"].init_cache(B, max_seq, jnp.float32)
    cache = setup["model"].init_cache(B, max_seq, torch.float32,
                                      device="cpu")
    jlogits, jcache = jserve.make_prefill_step(setup["jmodel"], jmesh)(
        setup["jparams"], {"tokens": jnp.asarray(tokens)}, jcache)
    logits, cache = serve.make_prefill_step(setup["model"], mesh)(
        setup["params"], {"tokens": torch.from_numpy(tokens)}, cache)
    assert len(flash_calls) == (_n_attn(cfg) if mesh_on else 0)
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=ATOL, rtol=0)
    assert cache["pos"] == int(jcache["pos"]) == S0

    jdecode = jserve.make_decode_step(setup["jmodel"], jmesh)
    decode = serve.make_decode_step(setup["model"], mesh)
    tok = np.array(jnp.argmax(jlogits[:, -1:], -1), np.int32)
    for _ in range(2):
        jlogits, jcache = jdecode(setup["jparams"], jnp.asarray(tok), jcache,
                                  {})
        logits, cache = decode(setup["params"], torch.from_numpy(tok), cache,
                               {})
        assert logits.shape == (B, 1, cfg.padded_vocab())
        np.testing.assert_allclose(_np(logits), _np(jlogits), atol=ATOL,
                                   rtol=0)
        tok = np.array(jnp.argmax(jlogits[:, -1:], -1), np.int32)
    assert len(flash_calls) == (_n_attn(cfg) if mesh_on else 0)
    assert cache["pos"] == int(jcache["pos"]) == S0 + 2
    period = transformer.period_of(cfg)
    for i, layer in enumerate(cache["layers"]):
        s, p = divmod(i, period)
        want = jcache["layers"][f"p{p}"]
        assert set(layer) == set(want)
        for name in layer:
            np.testing.assert_allclose(_np(layer[name]),
                                       _np(want[name][s]), atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def reference_tokens(setup):
    """The reference's greedy generations, with and without the mesh."""
    return {mesh_on: np.asarray(jserve.generate(
        setup["jmodel"], setup["jparams"], jnp.asarray(setup["prompts"]),
        max_new_tokens=NEW, mesh=make_mesh((1,), ("x",)) if mesh_on
        else None)) for mesh_on in (False, True)}


@pytest.mark.parametrize("mesh_on", [False, True], ids=["no_mesh", "mesh"])
def test_generate_greedy_matches_reference(setup, reference_tokens,
                                           flash_calls, mesh_on):
    out = serve.generate(setup["model"], setup["params"],
                         torch.from_numpy(setup["prompts"]),
                         max_new_tokens=NEW,
                         mesh=single_rank_mesh(("x",)) if mesh_on else None)
    assert out.dtype == torch.int32 and out.shape == (B, S0 + NEW)
    np.testing.assert_array_equal(out.numpy(), reference_tokens[mesh_on])
    assert len(flash_calls) == (_n_attn(setup["cfg"]) if mesh_on else 0)


def test_generate_sampling_is_seeded(setup):
    def run(seed):
        return serve.generate(
            setup["model"], setup["params"],
            torch.from_numpy(setup["prompts"]), max_new_tokens=NEW,
            temperature=1.0, generator=torch.Generator().manual_seed(seed))

    a, b = run(3), run(3)
    assert a.shape == (B, S0 + NEW) and torch.equal(a, b)
    assert torch.equal(a[:, :S0], torch.from_numpy(setup["prompts"]))
    assert bool(((a >= 0) & (a < setup["cfg"].vocab_size)).all())


def test_paged_cache_raises(setup):
    """The paged decode of every model against the reference's
    ``make_paged_decode_step``: each row's prompt prefilled and committed
    into its pages, one decode step, logits within 1e-5 on the active
    rows (a third slot stays inactive on the sentinel). The SSM and hybrid
    models have no paged cache in either package."""
    from repro.models import kvcache as jkv
    from repro.models import transformer as jT
    from repro_torch.models import kvcache as kv

    cfg, tokens = setup["cfg"], setup["prompts"][:, :8]
    geometry = dict(page_size=4, num_pages=12, max_slots=3, max_seq=12)
    pcfg, jpcfg = kv.PagedCacheConfig(**geometry), jkv.PagedCacheConfig(
        **geometry)
    if any(kind != "attn" for kind in cfg.layer_kinds()):
        with pytest.raises(ValueError, match="attention-only"):
            transformer.init_paged_cache(cfg, pcfg)
        with pytest.raises(ValueError, match="attention-only"):
            jT.init_paged_cache(_jcfg(cfg), jpcfg)
        return
    alloc = kv.PageAllocator(pcfg)
    pages = transformer.init_paged_cache(cfg, pcfg, torch.float32, "cpu")
    jpages = jT.init_paged_cache(_jcfg(cfg), jpcfg, jnp.float32)
    for b in range(B):
        slot = alloc.allocate(12)
        row = tokens[b:b + 1]
        cache = setup["model"].init_cache(1, 8, torch.float32, device="cpu")
        _, cache = serve.make_prefill_step(setup["model"])(
            setup["params"], {"tokens": torch.from_numpy(row)}, cache)
        kv.commit_prefill(pages["layers"], cache["layers"],
                          alloc.block_table[slot], 8, page_size=4)
        jcache = setup["jmodel"].init_cache(1, 8, jnp.float32)
        _, jcache = jserve.make_prefill_step(setup["jmodel"], None)(
            setup["jparams"], {"tokens": jnp.asarray(row)}, jcache)
        jpages = {"layers": jkv.commit_prefill(
            jpages["layers"], jcache["layers"],
            jnp.asarray(alloc.block_table[slot]), 8, page_size=4)}
        alloc.commit(slot, 8)
    tok = np.asarray([[5], [9], [0]], np.int32)
    bt, lens = alloc.device_tables("cpu")
    logits, _ = serve.make_paged_decode_step(setup["model"])(
        setup["params"], torch.from_numpy(tok), pages, bt, lens)
    jlogits, _ = jserve.make_paged_decode_step(setup["jmodel"])(
        setup["jparams"], jnp.asarray(tok), jpages,
        jnp.asarray(alloc.block_table), jnp.asarray(alloc.seq_lens))
    np.testing.assert_allclose(_np(logits)[:B], _np(jlogits)[:B], atol=ATOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# mirrors of tests/test_serve.py (8-token prompts, d_model 32), each also
# held to the reference's output
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small():
    cfg = configs.reduced(configs.get_config("llama3.2-3b"), layers=2,
                          d_model=32)
    jmodel = jbuild_model(_jcfg(cfg))
    jparams = jmodel.init(jax.random.key(0))
    params = from_reference(cfg, jax.tree.map(np.asarray, jparams),
                            device="cpu")
    return cfg, build_model(cfg), params, jmodel, jparams


def _prompts(cfg, seed, rows):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (rows, 8)).astype(np.int32)


def test_generate_greedy_deterministic(small):
    cfg, model, params, _, _ = small
    prompts = torch.from_numpy(_prompts(cfg, 0, 3))
    a = serve.generate(model, params, prompts, max_new_tokens=6)
    b = serve.generate(model, params, prompts, max_new_tokens=6)
    assert torch.equal(a, b) and a.shape == (3, 14)
    assert torch.equal(a[:, :8], prompts)


def test_generate_matches_stepwise_forward(small):
    """Cached decode equals repeated full forwards (greedy)."""
    cfg, model, params, _, _ = small
    seq = torch.from_numpy(_prompts(cfg, 1, 1))
    out = serve.generate(model, params, seq, max_new_tokens=4)
    for _ in range(4):
        logits, _, _ = model.apply(params, {"tokens": seq})
        nxt = torch.argmax(logits[:, -1], -1).to(seq.dtype)[:, None]
        seq = torch.cat([seq, nxt], dim=1)
    assert torch.equal(out, seq)


def test_generate_eos_padding(small):
    cfg, model, params, jmodel, jparams = small
    prompts = _prompts(cfg, 2, 2)
    free = serve.generate(model, params, torch.from_numpy(prompts),
                          max_new_tokens=8)
    eos = int(free[0, 9])  # force EOS at the 2nd generated token
    out = serve.generate(model, params, torch.from_numpy(prompts),
                         max_new_tokens=8, eos_id=eos)
    row = out[0, 8:].numpy()
    hit = np.where(row == eos)[0]
    assert len(hit) > 0
    np.testing.assert_array_equal(row[hit[0]:], eos)  # padded after EOS
    want = jserve.generate(jmodel, jparams, jnp.asarray(prompts),
                           max_new_tokens=8, eos_id=eos)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_generate_eos_stops_decoding_early(small, monkeypatch):
    """Once every row has hit EOS the loop stops issuing decode steps (the
    output keeps its fixed (B, S0 + max_new) shape through EOS padding)."""
    cfg, model, params, jmodel, jparams = small
    prompt = _prompts(cfg, 5, 1)
    calls = []
    orig = serve.make_decode_step

    def counting(model, mesh=None, **kw):
        step = orig(model, mesh, **kw)

        def wrapped(*a, **k):
            calls.append(1)
            return step(*a, **k)
        return wrapped

    monkeypatch.setattr(serve, "make_decode_step", counting)
    free = serve.generate(model, params, torch.from_numpy(prompt),
                          max_new_tokens=8)
    assert len(calls) == 7  # baseline: max_new - 1 decode steps
    eos = int(free[0, 8])

    calls.clear()
    out = serve.generate(model, params, torch.from_numpy(prompt),
                         max_new_tokens=8, eos_id=eos)
    assert out.shape == (1, 16)
    gen = free[0, 8:].numpy()
    k = int(np.flatnonzero(gen == eos)[0])  # decode steps until the EOS hit
    assert len(calls) == k < 7
    np.testing.assert_array_equal(out[0, 8:8 + k + 1].numpy(), gen[:k + 1])
    np.testing.assert_array_equal(out[0, 8 + k + 1:].numpy(), eos)
    want = jserve.generate(jmodel, jparams, jnp.asarray(prompt),
                           max_new_tokens=8, eos_id=eos)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_prefill_then_decode_shapes(small):
    cfg, model, params, _, _ = small
    Bs, S, MAX = 2, 8, 16
    cache = model.init_cache(Bs, MAX, torch.float32, device="cpu")
    batch = {"tokens": torch.from_numpy(_prompts(cfg, 3, Bs))}
    logits, cache = serve.make_prefill_step(model)(params, batch, cache)
    assert logits.shape == (Bs, S, cfg.padded_vocab())
    assert cache["pos"] == S
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    logits2, cache = serve.make_decode_step(model)(params, tok, cache, {})
    assert logits2.shape == (Bs, 1, cfg.padded_vocab())
    assert cache["pos"] == S + 1
