"""The port's vlm family (llama-3.2-vision's gated cross-attention) on the
CPU, held against the JAX reference.

``reduced(llama-3.2-vision-90b)``: 4 layers at d_model 64, a cross layer
every 2nd (layers 1 and 3), 8 patches of 32 features, fp32; also with
``num_kv_heads=2`` (``reduced()`` drops GQA, ROADMAP C8). The reference's
weights move across with ``from_reference``; its cross gates start at 0,
which hides the whole cross branch (``tanh(0) * c``), so both packages get
the same nonzero gates drawn from a numpy seed. Prompts of 128 tokens make
the one-rank mesh prefill reach the flash kernel: one call per
self-attention layer, never for a cross layer. Logits and caches agree
within 1e-5, greedy tokens exactly.
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
from repro.models import layers as JL
from repro.models import transformer as jT
from repro.models.model import build_model as jbuild_model
from repro.train import serve as jserve
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch.mesh import single_rank_mesh
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.model import (build_model, from_reference,
                                      to_reference)
from repro_torch.train import serve

ATOL = 1e-5
B, S0, NEW = 2, 128, 6
ARCH = "llama-3.2-vision-90b"


def _jcfg(cfg):
    return jconfigs.ModelConfig(**dataclasses.asdict(cfg))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _open_gates(params_np, seed):
    """Nonzero cross gates from a numpy seed, in place: (n_super,) per
    cross position of the period."""
    rng = np.random.default_rng(seed)
    for block in params_np["blocks"].values():
        if "cross_gate" in block:
            block["cross_gate"] = rng.uniform(
                0.5, 1.0, block["cross_gate"].shape).astype(np.float32)


@pytest.fixture(scope="module", params=["mha", "gqa"])
def setup(request):
    cfg = configs.reduced(configs.get_config(ARCH))
    if request.param == "gqa":
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
    jmodel = jbuild_model(_jcfg(cfg))
    params_np = jax.tree.map(np.array, jmodel.init(jax.random.key(0)))
    _open_gates(params_np, 1)
    jparams = jax.tree.map(jnp.asarray, params_np)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (B, S0)).astype(np.int32)
    patches = rng.standard_normal(
        (B, cfg.num_patches, cfg.vision_dim)).astype(np.float32)
    return dict(cfg=cfg, jmodel=jmodel, jparams=jparams, params_np=params_np,
                model=build_model(cfg),
                params=from_reference(cfg, params_np, device="cpu"),
                prompts=prompts, patches=patches)


@pytest.fixture
def flash_calls(monkeypatch):
    calls = []
    orig = ops.flash_attention

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    return calls


def _batch(setup, jax_side=False, rows=slice(None)):
    tokens, patches = setup["prompts"][rows], setup["patches"][rows]
    if jax_side:
        return {"tokens": jnp.asarray(tokens),
                "patch_embeds": jnp.asarray(patches)}
    return {"tokens": torch.from_numpy(tokens),
            "patch_embeds": torch.from_numpy(patches)}


def test_config_and_period_match_reference():
    """Cross every 5th layer in the full model (a period of 5), every 2nd
    in the reduced one; the period is the lcm with ``cross_attn_every``."""
    full = configs.get_config(ARCH)
    small = configs.reduced(full)
    for cfg in (full, small, dataclasses.replace(full, num_layers=5)):
        assert transformer.period_of(cfg) == jT.period_of(_jcfg(cfg))
    assert transformer.period_of(full) == 5
    assert small.cross_attn_mask() == (False, True, False, True)
    with pytest.raises(ValueError, match="not divisible"):
        transformer.period_of(dataclasses.replace(full, num_layers=7))


def test_from_reference_round_trip_is_bitwise(setup):
    back = to_reference(setup["params"])
    want = setup["params_np"]
    assert set(back) == {"embed", "final_norm", "blocks", "vlm"}
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for got, exp in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert got.dtype == exp.dtype and got.shape == exp.shape
        assert np.array_equal(got.view(np.uint32), exp.view(np.uint32))


def test_init_params_has_the_reference_layout(setup):
    params = build_model(setup["cfg"]).init(0, device="cpu")
    back = to_reference(params)
    want = jax.tree.map(np.asarray, setup["jmodel"].init(jax.random.key(0)))
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for got, exp in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert got.dtype == exp.dtype and got.shape == exp.shape
    # the gates start closed, as the reference's
    np.testing.assert_array_equal(back["blocks"]["p1"]["cross_gate"], 0.0)
    assert abs(float(params.vlm["patch_proj"].std()) - 0.02) < 2e-3


def test_apply_train_logits(setup):
    jlogits, _, _ = setup["jmodel"].apply(setup["jparams"],
                                          _batch(setup, True))
    logits, cache, _ = setup["model"].apply(setup["params"], _batch(setup))
    assert cache is None
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=ATOL, rtol=0)


def test_cross_gate_opens_the_cross_branch(setup):
    """With the gates set the logits differ from the gates at 0; at 0 they
    equal the logits without patches bit for bit (the branch adds 0 * c),
    and without patches both packages skip the cross layers."""
    model, params = setup["model"], setup["params"]
    opened = model.apply(params, _batch(setup))[0]
    shut = {**setup["params_np"], "blocks": {
        k: {**v, "cross_gate": np.zeros_like(v["cross_gate"])}
        if "cross_gate" in v else v
        for k, v in setup["params_np"]["blocks"].items()}}
    closed = model.apply(from_reference(setup["cfg"], shut, device="cpu"),
                         _batch(setup))[0]
    assert float((opened - closed).abs().max()) > 1e-3
    bare = {"tokens": torch.from_numpy(setup["prompts"])}
    no_patches = model.apply(params, bare)[0]
    assert torch.equal(closed, no_patches)
    jbare = setup["jmodel"].apply(setup["jparams"],
                                  {"tokens": jnp.asarray(setup["prompts"])})
    np.testing.assert_allclose(_np(no_patches), _np(jbare[0]), atol=ATOL,
                               rtol=0)


def test_cross_attention_layer_matches_reference(setup):
    """``apply_attention`` with ``kv_x``: k and v from the patches, no
    rope, not causal; caching cross K/V raises the reference's error."""
    cfg, lp = setup["cfg"], setup["params"].blocks[1]
    jlp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                       setup["params_np"]["blocks"]["p1"])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 16, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((B, 8, cfg.d_model)).astype(np.float32)
    out, _ = L.apply_attention(lp["cross_attn"], cfg, torch.from_numpy(x),
                               kv_x=torch.from_numpy(src), causal=False,
                               use_rope=False)
    jout, _ = JL.apply_attention(jlp["cross_attn"], _jcfg(cfg),
                                 jnp.asarray(x), kv_x=jnp.asarray(src),
                                 causal=False, use_rope=False)
    np.testing.assert_allclose(_np(out), _np(jout), atol=ATOL, rtol=0)
    cache = {"k": torch.zeros((B, 16, cfg.num_kv_heads, cfg.head_dim)),
             "v": torch.zeros((B, 16, cfg.num_kv_heads, cfg.head_dim))}
    with pytest.raises(ValueError, match="cross-attention KV"):
        L.apply_attention(lp["cross_attn"], cfg, torch.from_numpy(x),
                          kv_x=torch.from_numpy(src), cache=cache)


@pytest.mark.parametrize("mesh_on", [False, True], ids=["no_mesh", "mesh"])
def test_prefill_and_decode_match_reference(setup, flash_calls, mesh_on):
    """Prefill then two decode steps with the patches (decode recomputes
    the cross K/V, as the reference does): logits and every layer's k/v
    within 1e-5; one flash call per self-attention layer in the mesh
    prefill, none for the cross layers and none in decode."""
    cfg = setup["cfg"]
    max_seq = S0 + 4
    jmesh = make_mesh((1,), ("x",)) if mesh_on else None
    mesh = single_rank_mesh(("x",)) if mesh_on else None
    jcache = setup["jmodel"].init_cache(B, max_seq, jnp.float32)
    cache = setup["model"].init_cache(B, max_seq, torch.float32,
                                      device="cpu")
    jlogits, jcache = jserve.make_prefill_step(setup["jmodel"], jmesh)(
        setup["jparams"], _batch(setup, True), jcache)
    logits, cache = serve.make_prefill_step(setup["model"], mesh)(
        setup["params"], _batch(setup), cache)
    assert len(flash_calls) == (cfg.num_layers if mesh_on else 0)
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=ATOL, rtol=0)

    jdecode = jserve.make_decode_step(setup["jmodel"], jmesh)
    decode = serve.make_decode_step(setup["model"], mesh)
    extras = {"patch_embeds": torch.from_numpy(setup["patches"])}
    jextras = {"patch_embeds": jnp.asarray(setup["patches"])}
    tok = np.array(jnp.argmax(jlogits[:, -1:], -1), np.int32)
    for _ in range(2):
        jlogits, jcache = jdecode(setup["jparams"], jnp.asarray(tok), jcache,
                                  jextras)
        logits, cache = decode(setup["params"], torch.from_numpy(tok), cache,
                               extras)
        np.testing.assert_allclose(_np(logits), _np(jlogits), atol=ATOL,
                                   rtol=0)
        tok = np.array(jnp.argmax(jlogits[:, -1:], -1), np.int32)
    assert len(flash_calls) == (cfg.num_layers if mesh_on else 0)
    assert cache["pos"] == int(jcache["pos"]) == S0 + 2
    period = transformer.period_of(cfg)
    for i, layer in enumerate(cache["layers"]):
        want = jcache["layers"][f"p{i % period}"]
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(layer[name]),
                                       _np(want[name][i // period]),
                                       atol=ATOL, rtol=0)


@pytest.mark.parametrize("mesh_on", [False, True], ids=["no_mesh", "mesh"])
def test_generate_greedy_matches_reference(setup, flash_calls, mesh_on):
    want = jserve.generate(
        setup["jmodel"], setup["jparams"], jnp.asarray(setup["prompts"]),
        max_new_tokens=NEW, extras={"patch_embeds":
                                    jnp.asarray(setup["patches"])},
        mesh=make_mesh((1,), ("x",)) if mesh_on else None)
    out = serve.generate(setup["model"], setup["params"],
                         torch.from_numpy(setup["prompts"]),
                         max_new_tokens=NEW,
                         extras={"patch_embeds":
                                 torch.from_numpy(setup["patches"])},
                         mesh=single_rank_mesh(("x",)) if mesh_on else None)
    assert out.shape == (B, S0 + NEW)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert len(flash_calls) == (setup["cfg"].num_layers if mesh_on else 0)
