"""The port's encoder-decoder (whisper) on the CPU, held against the JAX
reference.

``reduced(whisper-base)``: 2 encoder and 2 decoder layers at d_model 64,
16 frames, vocabulary 512, fp32. The reference's weights move across with
``from_reference`` (its block lists are stacked over layers); prompts and
frames come from a numpy seed. Logits, the decoder's k/v caches and the
stored encoder output agree within 1e-5 (both packages keep the cache in
fp32), greedy tokens exactly. No path of the encoder-decoder takes the
flash kernel, with or without a mesh, as in the reference.
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
from repro.models import encdec as jencdec
from repro.models.model import build_model as jbuild_model
from repro.train import serve as jserve
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch.mesh import single_rank_mesh
from repro_torch.models import encdec
from repro_torch.models.model import (build_model, from_reference,
                                      to_reference)
from repro_torch.train import serve

ATOL = 1e-5
B, S0, NEW = 2, 12, 6
ARCH = "whisper-base"


def _jcfg(cfg):
    return jconfigs.ModelConfig(**dataclasses.asdict(cfg))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def setup():
    cfg = configs.reduced(configs.get_config(ARCH), layers=2)
    jmodel = jbuild_model(_jcfg(cfg))
    jparams = jmodel.init(jax.random.key(0))
    params_np = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    return dict(cfg=cfg, jmodel=jmodel, jparams=jparams, params_np=params_np,
                model=build_model(cfg),
                params=from_reference(cfg, params_np, device="cpu"),
                prompts=rng.integers(0, cfg.vocab_size,
                                     (B, S0)).astype(np.int32),
                frames=rng.standard_normal(
                    (B, cfg.audio_ctx, cfg.d_model)).astype(np.float32))


@pytest.fixture
def flash_calls(monkeypatch):
    calls = []
    orig = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    return calls


def _batch(setup, jax_side=False):
    if jax_side:
        return {"tokens": jnp.asarray(setup["prompts"]),
                "frames": jnp.asarray(setup["frames"])}
    return {"tokens": torch.from_numpy(setup["prompts"]),
            "frames": torch.from_numpy(setup["frames"])}


def test_whisper_config():
    """2 + 2 layers in the reduced model; the full model's padded
    vocabulary is wider than its 51865 tokens, and the logits span it."""
    full = configs.get_config(ARCH)
    assert (full.num_encoder_layers, full.num_layers, full.audio_ctx,
            full.rope_theta) == (6, 6, 1500, 0.0)
    assert full.padded_vocab() == 51968 > full.vocab_size == 51865
    small = configs.reduced(full, layers=2)
    assert (small.num_encoder_layers, small.num_layers,
            small.audio_ctx) == (2, 2, 16)


def test_from_reference_round_trip_is_bitwise(setup):
    back = to_reference(setup["params"])
    want = setup["params_np"]
    assert set(back) == {"embed", "enc_blocks", "enc_norm", "dec_blocks",
                         "final_norm"}
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for got, exp in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert got.dtype == exp.dtype and got.shape == exp.shape
        assert np.array_equal(got.view(np.uint32), exp.view(np.uint32))


def test_init_params_has_the_reference_layout(setup):
    cfg = setup["cfg"]
    params = build_model(cfg).init(0, device="cpu")
    assert isinstance(params, encdec.EncDecParams)
    back = to_reference(params)
    want = setup["params_np"]
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for got, exp in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert got.dtype == exp.dtype and got.shape == exp.shape
    assert abs(float(params.dec_blocks[0]["self_attn"]["wq"].std())
               - 0.02) < 2e-3


def test_encode_matches_reference(setup):
    cfg = setup["cfg"]
    got = encdec.encode(setup["params"], cfg,
                        torch.from_numpy(setup["frames"]))
    want = jencdec.encode(setup["jparams"], _jcfg(cfg),
                          jnp.asarray(setup["frames"]))
    assert tuple(got.shape) == (B, cfg.audio_ctx, cfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)


def test_apply_train_logits(setup, flash_calls):
    jlogits, _, _ = setup["jmodel"].apply(setup["jparams"],
                                          _batch(setup, True))
    logits, cache, aux = setup["model"].apply(setup["params"], _batch(setup))
    assert cache is None and aux is None and flash_calls == []
    assert logits.shape == (B, S0, setup["cfg"].padded_vocab())
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=ATOL, rtol=0)


@pytest.mark.parametrize("mesh_on", [False, True], ids=["no_mesh", "mesh"])
def test_prefill_and_decode_match_reference(setup, flash_calls, mesh_on):
    """Prefill (the encoder runs, its output stored in the cache), then
    two decode steps without frames (the encoder output read back from the
    cache): logits, every decoder layer's k/v and ``encoder_out`` within
    1e-5; no flash call anywhere."""
    cfg = setup["cfg"]
    max_seq = S0 + 4
    jmesh = make_mesh((1,), ("x",)) if mesh_on else None
    mesh = single_rank_mesh(("x",)) if mesh_on else None
    jcache = setup["jmodel"].init_cache(B, max_seq, jnp.float32)
    cache = setup["model"].init_cache(B, max_seq, torch.float32,
                                      device="cpu")
    assert tuple(cache["encoder_out"].shape) == jcache["encoder_out"].shape
    jlogits, jcache = jserve.make_prefill_step(setup["jmodel"], jmesh)(
        setup["jparams"], _batch(setup, True), jcache)
    logits, cache = serve.make_prefill_step(setup["model"], mesh)(
        setup["params"], _batch(setup), cache)
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(cache["encoder_out"]),
                               _np(jcache["encoder_out"]), atol=ATOL, rtol=0)

    jdecode = jserve.make_decode_step(setup["jmodel"], jmesh)
    decode = serve.make_decode_step(setup["model"], mesh)
    tok = np.array(jnp.argmax(jlogits[:, -1:], -1), np.int32)
    for _ in range(2):
        jlogits, jcache = jdecode(setup["jparams"], jnp.asarray(tok), jcache,
                                  {})
        logits, cache = decode(setup["params"], torch.from_numpy(tok), cache,
                               {})
        np.testing.assert_allclose(_np(logits), _np(jlogits), atol=ATOL,
                                   rtol=0)
        tok = np.array(jnp.argmax(jlogits[:, -1:], -1), np.int32)
    assert flash_calls == []
    assert cache["pos"] == int(jcache["pos"]) == S0 + 2
    for i, layer in enumerate(cache["layers"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(layer[name]),
                                       _np(jcache["layers"][name][i]),
                                       atol=ATOL, rtol=0)


@pytest.mark.parametrize("mesh_on", [False, True], ids=["no_mesh", "mesh"])
def test_generate_greedy_matches_reference(setup, flash_calls, monkeypatch,
                                           mesh_on):
    """Greedy tokens equal; decode gets no frames (only prefill encodes),
    as the reference's ``generate`` drops them from the decode extras."""
    frames_seen = []
    orig = encdec.encode

    def spy(params, cfg, frames, **kw):
        frames_seen.append(tuple(frames.shape))
        return orig(params, cfg, frames, **kw)

    monkeypatch.setattr(encdec, "encode", spy)
    want = jserve.generate(setup["jmodel"], setup["jparams"],
                           jnp.asarray(setup["prompts"]), max_new_tokens=NEW,
                           extras={"frames": jnp.asarray(setup["frames"])},
                           mesh=make_mesh((1,), ("x",)) if mesh_on else None)
    out = serve.generate(setup["model"], setup["params"],
                         torch.from_numpy(setup["prompts"]),
                         max_new_tokens=NEW,
                         extras={"frames": torch.from_numpy(setup["frames"])},
                         mesh=single_rank_mesh(("x",)) if mesh_on else None)
    assert out.shape == (B, S0 + NEW)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert frames_seen == [setup["frames"].shape] and flash_calls == []


def test_bf16_cache_stores_encoder_output_in_its_dtype(setup):
    """The encoder output is stored in the cache's dtype and read back in
    the compute dtype, as in the reference (``encdec.py:152,154``)."""
    cache = setup["model"].init_cache(B, S0 + 1, torch.bfloat16,
                                      device="cpu")
    _, cache = serve.make_prefill_step(setup["model"])(
        setup["params"], _batch(setup), cache)
    assert cache["encoder_out"].dtype == torch.bfloat16
    enc = encdec.encode(setup["params"], setup["cfg"],
                        torch.from_numpy(setup["frames"]))
    assert torch.equal(cache["encoder_out"], enc.to(torch.bfloat16))
