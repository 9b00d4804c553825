"""The port's attention on the CPU, held against the JAX reference: the
flash kernel's plain version, the layers of the LM, and the one-rank
sharding that chooses the flash path.

Inputs come from a numpy seed and go to both packages. On a CPU tensor
``repro_torch.kernels.ops.flash_attention`` runs its plain version
(``kernels/ref.py``); it is held against the reference's Pallas kernel in
interpret mode (``pallas``) and its dense jnp oracle (``ref``) over the
sweep of ``tests/test_kernels.py``, with its tolerances (atol 2e-4 fp32,
8e-2 bf16; rtol 2e-2). The CUDA kernel needs the card; ``chip_smoke.py``
holds it against the same plain version there. The layer functions of
``models/layers.py`` are held against ``repro.models.layers`` in fp32
within 1e-5: both compute the same operations in the same order and differ
only in the order of library sums.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import sharding as jsh
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.mesh import make_mesh
from repro.models import layers as JL
from repro_torch import sharding as sh
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.launch.mesh import single_rank_mesh
from repro_torch.models import layers as L

ATOL = {torch.float32: 2e-4, torch.bfloat16: 8e-2}
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
LAYER_ATOL = 1e-5


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _both(x, dtype=torch.float32):
    """The same values as a torch tensor and a jax array of one dtype."""
    t = torch.from_numpy(x).to(dtype)
    return t, jnp.asarray(t.float().numpy()).astype(JDTYPE[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# flash_attention's plain version against the Pallas kernel and the oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("oracle", ("pallas", "ref"))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,KV,S,hd,bq,bk", [
    (2, 4, 4, 128, 32, 64, 64),     # MHA
    (1, 8, 2, 256, 64, 128, 64),    # GQA 4:1
    (2, 8, 1, 96, 32, 32, 32),      # MQA
])
def test_flash_attention_sweep(oracle, dtype, causal, B, H, KV, S, hd, bq,
                               bk):
    (q, jq), (k, jk), (v, jv) = (_both(_normal(s, shp), dtype) for s, shp in
                                 ((1, (B, S, H, hd)), (2, (B, S, KV, hd)),
                                  (3, (B, S, KV, hd))))
    got = ops.flash_attention(q, k, v, causal=causal, bq=bq, bk=bk)
    assert got.dtype == dtype and got.shape == q.shape
    if oracle == "pallas":
        want = jops.flash_attention(jq, jk, jv, causal=causal, bq=bq, bk=bk,
                                    interpret=True)
    else:
        want = jref.attention(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype],
                               rtol=2e-2)


def test_flash_attention_q_offset():
    """Decode-style offset: the last rows with q_offset equal the same rows
    of the full causal attention, and the reference's kernel."""
    B, S, H, hd = 1, 128, 4, 32
    (q, jq), (k, jk), (v, jv) = (_both(_normal(s, (B, S, H, hd)))
                                 for s in (4, 5, 6))
    full = ops.flash_attention(q, k, v, causal=True, bq=32, bk=32)
    tail = ops.flash_attention(q[:, -32:], k, v, causal=True,
                               q_offset=S - 32, bq=32, bk=32)
    want = jops.flash_attention(jq[:, -32:], jk, jv, causal=True,
                                q_offset=S - 32, bq=32, bk=32, interpret=True)
    np.testing.assert_allclose(_np(tail), _np(full[:, -32:]), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(_np(tail), _np(want), atol=ATOL[torch.float32],
                               rtol=2e-2)


@pytest.mark.parametrize("Sq,Skv,bq,bk", [(96, 96, 64, 32), (128, 96, 64, 64),
                                          (128, 128, 0, 32)])
def test_flash_attention_blocks_must_divide(Sq, Skv, bq, bk):
    q = torch.zeros((1, Sq, 2, 32))
    k = torch.zeros((1, Skv, 2, 32))
    with pytest.raises(ValueError, match="do not divide"):
        ops.flash_attention(q, k, k, bq=bq, bk=bk)


def test_flash_attention_rejects_bad_shapes():
    q = torch.zeros((1, 64, 6, 32))
    with pytest.raises(ValueError, match="multiple of KV"):
        ops.flash_attention(q, torch.zeros((1, 64, 4, 32)),
                            torch.zeros((1, 64, 4, 32)))
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q, q, q, q_offset=-1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,q_offset", [(True, 0), (False, 0),
                                             (True, 32)])
def test_dense_oracle_matches_reference(dtype, causal, q_offset):
    (q, jq), (k, jk), (v, jv) = (_both(_normal(s, shp), dtype) for s, shp in
                                 ((7, (2, 32, 8, 32)), (8, (2, 64, 2, 32)),
                                  (9, (2, 64, 2, 32))))
    got = ref.attention(q, k, v, causal=causal, q_offset=q_offset)
    want = jref.attention(jq, jk, jv, causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype] / 10,
                               rtol=2e-2)


# ---------------------------------------------------------------------------
# layers, fp32, within 1e-5
# ---------------------------------------------------------------------------


def test_rmsnorm():
    (x, jx), (s, js) = _both(_normal(10, (2, 5, 48))), \
        _both(_normal(11, (48,)) + 1.0)
    np.testing.assert_allclose(_np(L.rmsnorm(x, s, 1e-5)),
                               _np(JL.rmsnorm(jx, js, 1e-5)),
                               atol=LAYER_ATOL, rtol=0)


@pytest.mark.parametrize("batched", [False, True])
def test_rope(batched):
    pos_np = np.arange(24, dtype=np.int32) + 5
    if batched:
        pos_np = np.stack([pos_np, pos_np + 100])
    pos, jpos = torch.from_numpy(pos_np), jnp.asarray(pos_np)
    sin, cos = L.rope_table(pos, 32, 5e5)
    jsin, jcos = JL.rope_table(jpos, 32, 5e5)
    np.testing.assert_allclose(_np(sin), _np(jsin), atol=LAYER_ATOL, rtol=0)
    np.testing.assert_allclose(_np(cos), _np(jcos), atol=LAYER_ATOL, rtol=0)
    x, jx = _both(_normal(12, (2, 24, 4, 32)))
    np.testing.assert_allclose(_np(L.apply_rope(x, sin, cos)),
                               _np(JL.apply_rope(jx, jsin, jcos)),
                               atol=LAYER_ATOL, rtol=0)


def test_sinusoidal_positions():
    pos_np = np.arange(40, dtype=np.int32)
    np.testing.assert_allclose(
        _np(L.sinusoidal_positions(torch.from_numpy(pos_np), 64)),
        _np(JL.sinusoidal_positions(jnp.asarray(pos_np), 64)),
        atol=LAYER_ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_heads", [8, 2, 1])
@pytest.mark.parametrize("branch", ["dense", "blockwise", "blockwise_pad"])
def test_attention_layer(branch, kv_heads, causal):
    """Both branches of ``layers.attention``: the dense one, and the
    blockwise online softmax (forced by a low ``dense_threshold``), with
    and without a padded last block."""
    Sq, Skv = (48, 96) if branch != "blockwise_pad" else (48, 80)
    kw = {} if branch == "dense" else dict(kv_block=32, dense_threshold=16)
    (q, jq), (k, jk), (v, jv) = (_both(_normal(s, shp)) for s, shp in
                                 ((13, (2, Sq, 8, 32)),
                                  (14, (2, Skv, kv_heads, 32)),
                                  (15, (2, Skv, kv_heads, 32))))
    q_offset = Skv - Sq
    got = L.attention(q, k, v, causal=causal, q_offset=q_offset, **kw)
    want = JL.attention(jq, jk, jv, causal=causal, q_offset=q_offset, **kw)
    np.testing.assert_allclose(_np(got), _np(want), atol=LAYER_ATOL, rtol=0)


def test_decode_attention():
    (q, jq), (k, jk), (v, jv) = (_both(_normal(s, shp)) for s, shp in
                                 ((16, (3, 1, 8, 32)), (17, (3, 40, 2, 32)),
                                  (18, (3, 40, 2, 32))))
    lengths = np.array([0, 17, 39], np.int32)
    got = L.decode_attention(q, k, v, lengths=torch.from_numpy(lengths))
    want = JL.decode_attention(jq, jk, jv, lengths=jnp.asarray(lengths))
    np.testing.assert_allclose(_np(got), _np(want), atol=LAYER_ATOL, rtol=0)


def _layer_params(cfg, seed):
    """Matching attention and MLP parameters for both packages."""
    key = jax.random.key(seed)
    ka, km = jax.random.split(key)
    jattn = JL.init_attention(ka, cfg)
    jmlp = JL.init_mlp(km, cfg.d_model, cfg.d_ff, cfg.num_layers)

    def t(tree):
        return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    return (t(jattn), jattn), (t(jmlp), jmlp)


@pytest.fixture(scope="module")
def gqa_cfg():
    from dataclasses import replace
    return replace(reduced(get_config("llama3.2-3b"), layers=2, d_model=64),
                   num_kv_heads=2)


def _jcfg(cfg):
    from repro.configs.base import ModelConfig
    from dataclasses import asdict
    return ModelConfig(**asdict(cfg))


def test_apply_mlp(gqa_cfg):
    _, (p, jp) = _layer_params(_jcfg(gqa_cfg), 19)
    x, jx = _both(_normal(20, (2, 6, gqa_cfg.d_model)))
    np.testing.assert_allclose(_np(L.apply_mlp(p, x)),
                               _np(JL.apply_mlp(jp, jx)),
                               atol=LAYER_ATOL, rtol=0)


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_apply_attention_prefill_then_decode(gqa_cfg, qkv_bias):
    """No cache, a prefill into a dense cache, then one decode position:
    outputs and the cache within 1e-5 of the reference (with random q/k/v
    biases where the config has them, as qwen1.5 does)."""
    from dataclasses import replace
    gqa_cfg = replace(gqa_cfg, qkv_bias=qkv_bias)
    jcfg = _jcfg(gqa_cfg)
    (p, jp), _ = _layer_params(jcfg, 21)
    for i, name in enumerate(("bq", "bk", "bv") if qkv_bias else ()):
        p[name], jp[name] = _both(_normal(30 + i, tuple(p[name].shape)))
    B, S, Smax = 2, 12, 16
    x, jx = _both(_normal(22, (B, S, gqa_cfg.d_model)))
    out, _ = L.apply_attention(p, gqa_cfg, x)
    jout, _ = JL.apply_attention(jp, jcfg, jx)
    np.testing.assert_allclose(_np(out), _np(jout), atol=LAYER_ATOL, rtol=0)

    shape = (B, Smax, gqa_cfg.num_kv_heads, gqa_cfg.head_dim)
    cache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    out, cache = L.apply_attention(p, gqa_cfg, x, cache=cache)
    jout, jcache = JL.apply_attention(jp, jcfg, jx, cache=jcache)
    np.testing.assert_allclose(_np(out), _np(jout), atol=LAYER_ATOL, rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]),
                                   atol=LAYER_ATOL, rtol=0)

    x1, jx1 = _both(_normal(23, (B, 1, gqa_cfg.d_model)))
    out, cache = L.apply_attention(p, gqa_cfg, x1, cache=cache, pos=S)
    jout, upd = JL.apply_attention(jp, jcfg, jx1, cache=jcache, pos=S)
    np.testing.assert_allclose(_np(out), _np(jout), atol=LAYER_ATOL, rtol=0)
    np.testing.assert_allclose(_np(cache["k"][:, S:S + 1]), _np(upd["k_upd"]),
                               atol=LAYER_ATOL, rtol=0)


def test_apply_attention_paged_cache_raises(gqa_cfg):
    """The paged branch against the reference's: pools with random
    pages, a block table with an inactive (sentinel) row and a row whose
    token falls past its last page; output within the layer tolerance on
    the active rows, the token update the same, and the reference's
    ValueErrors for a missing page table and for cross-attention K/V."""
    (p, jp), _ = _layer_params(_jcfg(gqa_cfg), 24)
    shape = (6, 4, gqa_cfg.num_kv_heads, gqa_cfg.head_dim)
    kp, jkp = _both(_normal(40, shape))
    vp, jvp = _both(_normal(41, shape))
    bt = np.asarray([[4, 1, 6], [6, 6, 6], [0, 2, 6]], np.int32)
    lens = np.asarray([6, 0, 8], np.int32)
    x, jx = _both(_normal(42, (3, 1, gqa_cfg.d_model)))
    cache = {"k_pages": kp, "v_pages": vp}
    table = {"block_table": torch.from_numpy(bt),
             "lengths": torch.from_numpy(lens)}
    out, upd = L.apply_attention(p, gqa_cfg, x, cache=cache,
                                 pos=table["lengths"], page_table=table)
    jout, jupd = JL.apply_attention(
        jp, _jcfg(gqa_cfg), jx, cache={"k_pages": jkp, "v_pages": jvp},
        pos=jnp.asarray(lens), page_table={"block_table": jnp.asarray(bt),
                                           "lengths": jnp.asarray(lens)})
    np.testing.assert_allclose(_np(out)[[0, 2]], _np(jout)[[0, 2]],
                               atol=LAYER_ATOL, rtol=0)
    for name in ("k_upd", "v_upd"):
        np.testing.assert_allclose(_np(upd[name]), _np(jupd[name]),
                                   atol=LAYER_ATOL, rtol=0)
    assert torch.equal(cache["k_pages"], kp)  # the pool is not written here
    with pytest.raises(ValueError, match="page_table"):
        L.apply_attention(p, gqa_cfg, x, cache=cache, pos=table["lengths"])
    with pytest.raises(ValueError, match="cross-attention"):
        L.apply_attention(p, gqa_cfg, x, kv_x=x, cache=cache,
                          pos=table["lengths"], page_table=table)


# ---------------------------------------------------------------------------
# the flash path: chosen by a shard function that carries a one-rank mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("names", [("x",), ("data", "model"),
                                   ("pod", "data", "model"), ("rows", "cols")])
def test_rules_for_matches_reference(names):
    got = sh.rules_for(single_rank_mesh(names))
    want = jsh.rules_for(make_mesh((1,) * len(names), names))
    assert (got.dp, got.tp) == (want.dp, want.tp)


def test_shard_fn_is_identity_carrying_mesh_and_rules():
    mesh = single_rank_mesh(("x",))
    rules = sh.rules_for(mesh)
    shard = sh.make_shard_fn(mesh, rules)
    x = torch.arange(6.0).reshape(2, 3)
    assert shard(x, "residual") is x
    assert shard.mesh is mesh and shard.rules is rules


def test_shard_fn_refuses_a_wide_mesh():
    """``make_shard_fn`` takes a mesh with axes wider than 1, and nothing
    refuses it now (the name is kept from when the MoE layer did): on the
    meta device over a dry 2x2 mesh the MoE layer holds half the experts
    and their router columns, gathers the logits and reduces its output
    over ``model`` under ``gspmd.tp``, and returns the whole output."""
    from repro_torch.comm import dry
    from repro_torch.launch.mesh import dry_mesh
    from repro_torch.models import moe as MOE

    wide = dry_mesh((2, 2), ("data", "model"))
    shard = sh.make_shard_fn(wide, sh.rules_for(wide))
    assert shard.mesh is wide and shard(torch.ones(2), "residual") is not None
    cfg = reduced(get_config("qwen3-moe-235b-a22b"), layers=2)
    p = MOE.init_moe(torch.Generator().manual_seed(0), cfg, device="meta")
    specs = sh.param_specs({"moe": p}, shard.rules, wide)["moe"]
    local = sh.cut(p, specs, wide, copy=False)
    assert local["w_gate"].shape[0] == cfg.num_experts // 2
    assert local["router"].shape[1] == cfg.num_experts // 2
    dry.reset()
    out = MOE.apply_moe(local, cfg, torch.empty((2, 4, cfg.d_model),
                                                device="meta"), shard=shard)
    assert out.shape == (2, 4, cfg.d_model) and out.device.type == "meta"
    assert [(o.op, o.source) for o in dry.ops()] == [
        ("all-gather", "gspmd.tp"), ("all-reduce", "gspmd.tp")]
    dry.reset()


@pytest.mark.parametrize("Sq,expect_flash", [(128, True), (64, False)])
def test_flash_sharded_takes_the_kernel(monkeypatch, Sq, expect_flash):
    """The one-rank shard function routes prefill attention of 128 queries
    or more through ``ops.flash_attention`` (with the reference's
    ``bq = bk = min(512, S)``); shorter prompts and a shard function
    without a mesh return None, as in the reference."""
    calls = []
    orig = ops.flash_attention

    def spy(*a, **kw):
        calls.append(kw)
        return orig(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    q, k, v = (torch.from_numpy(_normal(s, (2, Sq, 4, 32))) for s in
               (25, 26, 27))
    mesh = single_rank_mesh(("x",))
    shard = sh.make_shard_fn(mesh, sh.rules_for(mesh))
    out = L._flash_sharded(q, k, v, shard=shard, causal=True)
    assert L._flash_sharded(q, k, v, shard=lambda x, n: x,
                            causal=True) is None
    if expect_flash:
        assert calls == [dict(causal=True, bq=Sq, bk=Sq)]
        np.testing.assert_allclose(_np(out), _np(ref.attention(q, k, v)),
                                   atol=ATOL[torch.float32], rtol=2e-2)
    else:
        assert out is None and calls == []
