"""The port's Mamba-2 SSD block (``repro_torch.models.ssm``) and its cache
against the JAX reference on the CPU.

Inputs come from numpy seeds and weights from the reference's ``init_ssm``.
``ssd_chunked`` is held within 1e-5 of the reference's ``ssd_chunked`` and
of its sequential oracle ``ssd_reference`` (and the port's oracle of the
reference's), for a length that is a multiple of the chunk and one that is
not, with and without an initial state, and with one, two and four heads
per group; ``_causal_conv`` with and without a cache; ``apply_ssm`` in
prefill (from a zero and a nonzero cache state) and in decode, with the
cache it writes in place; ``ssm_cache_spec``'s shapes and dtypes.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import kvcache as jkvcache
from repro.models import ssm as JSSM
from repro_torch import configs
from repro_torch.models import kvcache
from repro_torch.models import ssm as SSM

ATOL = 1e-5


def _jcfg(cfg):
    return jconfigs.ModelConfig(**dataclasses.asdict(cfg))


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# the chunked SSD core
# ---------------------------------------------------------------------------

# (L, chunk, heads, groups, with h0)
SSD_CASES = {"multiple": (64, 16, 4, 1, False),
             "ragged": (50, 16, 4, 1, False),
             "h0": (50, 16, 4, 1, True),
             "two_groups": (40, 16, 4, 2, True),
             "head_per_group": (33, 8, 2, 2, False)}


def _ssd_inputs(L, H, G, h0, seed=0, b=2, P=8, N=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, L, H, P)).astype(np.float32)
    dt = (0.05 + 0.1 * rng.random((b, L, H))).astype(np.float32)
    A = -np.arange(1, H + 1, dtype=np.float32) * 0.5
    B = rng.standard_normal((b, L, G, N)).astype(np.float32)
    C = rng.standard_normal((b, L, G, N)).astype(np.float32)
    h = rng.standard_normal((b, H, P, N)).astype(np.float32) if h0 else None
    return x, dt, A, B, C, h


@pytest.mark.parametrize("name", list(SSD_CASES))
def test_ssd_chunked_matches_reference(name):
    L, chunk, H, G, with_h0 = SSD_CASES[name]
    args = _ssd_inputs(L, H, G, with_h0)
    x, dt, A, B, C, h0 = args
    jy, jh = JSSM.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk,
                              h0=None if h0 is None else jnp.asarray(h0))
    y, h = SSM.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)), chunk,
                           h0=None if h0 is None else torch.from_numpy(h0))
    assert y.shape == x.shape and y.dtype == torch.float32
    assert h.shape == (x.shape[0], H, x.shape[3], B.shape[3])
    np.testing.assert_allclose(_np(y), _np(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(h), _np(jh), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", list(SSD_CASES))
def test_ssd_chunked_matches_sequential_oracle(name):
    """The chunked form against the reference's sequential recurrence, and
    the port's oracle against the reference's."""
    L, chunk, H, G, with_h0 = SSD_CASES[name]
    x, dt, A, B, C, h0 = _ssd_inputs(L, H, G, with_h0, seed=1)
    jy, jh = JSSM.ssd_reference(*map(jnp.asarray, (x, dt, A, B, C)),
                                h0=None if h0 is None else jnp.asarray(h0))
    th0 = None if h0 is None else torch.from_numpy(h0)
    targs = tuple(map(torch.from_numpy, (x, dt, A, B, C)))
    y, h = SSM.ssd_chunked(*targs, chunk, h0=th0)
    np.testing.assert_allclose(_np(y), _np(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(h), _np(jh), atol=ATOL, rtol=0)
    oy, oh = SSM.ssd_reference(*targs, h0=th0)
    np.testing.assert_allclose(_np(oy), _np(jy), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(oh), _np(jh), atol=ATOL, rtol=0)


def test_ssd_chunked_bf16_keeps_fp32_state():
    x, dt, A, B, C, _ = _ssd_inputs(40, 4, 1, False, seed=2)
    xb = torch.from_numpy(x).bfloat16()
    y, h = SSM.ssd_chunked(xb, torch.from_numpy(dt), torch.from_numpy(A),
                           torch.from_numpy(B).bfloat16(),
                           torch.from_numpy(C).bfloat16(), 16)
    jy, jh = JSSM.ssd_chunked(jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt),
                              jnp.asarray(A), jnp.asarray(B, jnp.bfloat16),
                              jnp.asarray(C, jnp.bfloat16), 16)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    np.testing.assert_allclose(_np(h), _np(jh), atol=ATOL, rtol=0)
    np.testing.assert_allclose(_np(y), _np(jy), atol=5e-2, rtol=0)


# ---------------------------------------------------------------------------
# the causal conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L", [1, 2, 7])
@pytest.mark.parametrize("cached", [False, True], ids=["no_cache", "cache"])
def test_causal_conv_matches_reference(L, cached):
    rng = np.random.default_rng(L)
    K, ch = 4, 6
    xBC = rng.standard_normal((2, L, ch)).astype(np.float32)
    w = rng.standard_normal((K, ch)).astype(np.float32)
    b = rng.standard_normal((ch,)).astype(np.float32)
    cache = rng.standard_normal((2, K - 1, ch)).astype(np.float32) \
        if cached else None
    jout, jnew = JSSM._causal_conv(
        jnp.asarray(xBC), jnp.asarray(w), jnp.asarray(b),
        conv_cache=None if cache is None else jnp.asarray(cache))
    out, new = SSM._causal_conv(
        torch.from_numpy(xBC), torch.from_numpy(w), torch.from_numpy(b),
        conv_cache=None if cache is None else torch.from_numpy(cache))
    np.testing.assert_allclose(_np(out), _np(jout), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(_np(new), _np(jnew))
    assert new.shape == (2, K - 1, ch)


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["mamba2", "jamba"])
def block(request):
    arch = {"mamba2": "mamba2-130m",
            "jamba": "jamba-1.5-large-398b"}[request.param]
    cfg = configs.reduced(configs.get_config(arch))
    jp = JSSM.init_ssm(jax.random.key(3), _jcfg(cfg))
    return cfg, jp, _t(jp)


def _x(cfg, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)


def _caches(cfg, rng=None):
    jc = jkvcache.ssm_cache_spec(_jcfg(cfg), 2, jnp.float32)
    if rng is not None:  # a nonzero state, as after an earlier prefill
        jc = dict(jc, state=jnp.asarray(rng.standard_normal(
            jc["state"].shape).astype(np.float32) * 0.1))
    return jc, {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}


@pytest.mark.parametrize("S", [8, 40], ids=["one_chunk", "two_chunks"])
def test_apply_ssm_prefill_matches_reference(block, S):
    cfg, jp, p = block
    x = _x(cfg, S, 4)
    jout, _ = JSSM.apply_ssm(jp, _jcfg(cfg), jnp.asarray(x))
    out, none = SSM.apply_ssm(p, cfg, torch.from_numpy(x))
    assert none is None
    np.testing.assert_allclose(_np(out), _np(jout), atol=ATOL, rtol=0)
    for rng in (None, np.random.default_rng(5)):
        jc, c = _caches(cfg, rng)
        jout, jnew = JSSM.apply_ssm(jp, _jcfg(cfg), jnp.asarray(x), cache=jc)
        out, new = SSM.apply_ssm(p, cfg, torch.from_numpy(x), cache=c)
        assert new is c  # written in place
        np.testing.assert_allclose(_np(out), _np(jout), atol=ATOL, rtol=0)
        for k in jnew:
            assert new[k].dtype == torch.float32
            np.testing.assert_allclose(_np(new[k]), _np(jnew[k]), atol=ATOL,
                                       rtol=0)


def test_apply_ssm_decode_matches_reference(block):
    """Prefill, then three recurrent decode steps from its cache."""
    cfg, jp, p = block
    x = _x(cfg, 12, 6)
    jc, c = _caches(cfg)
    _, jc = JSSM.apply_ssm(jp, _jcfg(cfg), jnp.asarray(x), cache=jc)
    SSM.apply_ssm(p, cfg, torch.from_numpy(x), cache=c)
    for step in range(3):
        x1 = _x(cfg, 1, 10 + step)
        jout, jc = JSSM.apply_ssm(jp, _jcfg(cfg), jnp.asarray(x1), cache=jc,
                                  pos=12 + step)
        out, c = SSM.apply_ssm(p, cfg, torch.from_numpy(x1), cache=c,
                               pos=12 + step)
        assert out.shape == (2, 1, cfg.d_model)
        np.testing.assert_allclose(_np(out), _np(jout), atol=ATOL, rtol=0)
        for k in jc:
            np.testing.assert_allclose(_np(c[k]), _np(jc[k]), atol=ATOL,
                                       rtol=0)


def test_apply_ssm_bf16_gated_norm_in_the_activation_dtype(block):
    cfg, jp, p = block
    x = _x(cfg, 8, 7)
    jout, _ = JSSM.apply_ssm(jp, _jcfg(cfg), jnp.asarray(x, jnp.bfloat16))
    out, _ = SSM.apply_ssm(p, cfg, torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(jout), atol=2e-2, rtol=0)


def test_init_ssm_has_the_reference_layout(block):
    cfg, jp, _ = block
    got = SSM.init_ssm(torch.Generator().manual_seed(0), cfg)
    assert set(got) == set(jp)
    for k, v in got.items():
        assert tuple(v.shape) == jp[k].shape and v.dtype == torch.float32
    for k in ("D", "conv_x_b", "conv_bc_b", "norm"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jp[k]))
    # log(1..H): torch's and XLA's log may differ in the last bit
    np.testing.assert_allclose(got["A_log"].numpy(), np.asarray(jp["A_log"]),
                               rtol=1e-6, atol=0)
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert bool(((dt >= 1e-3 - 1e-7) & (dt <= 1e-1 + 1e-7)).all())
    assert SSM.ssm_dims(cfg) == JSSM.ssm_dims(_jcfg(cfg))


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_cache_spec_shapes(arch, dtype):
    for cfg in (configs.get_config(arch),
                configs.reduced(configs.get_config(arch))):
        want = jkvcache.ssm_cache_spec(_jcfg(cfg), 3, jnp.dtype(dtype))
        got = kvcache.ssm_cache_spec(cfg, 3, getattr(torch, dtype),
                                     device="meta")
        assert set(got) == set(want)
        for k, v in got.items():
            assert tuple(v.shape) == want[k].shape
            assert str(v.dtype).split(".")[1] == str(want[k].dtype)
        assert got["state"].dtype == torch.float32
