"""The bf16 tensor-core flash kernel's arithmetic, on the CPU, without the
kernel.

``csrc/flash_attention.cu``'s bf16 route computes S = Q K^T on bf16 operands
with fp32 sums and scales S in fp32 afterwards; it keeps P, m and l in fp32
and splits P for P V into ``P_hi = bf16(P)`` and ``P_lo = bf16(P - P_hi)``,
summing ``P_hi V + P_lo V`` in fp32. :func:`split_flash` repeats those steps
in plain torch, over the kernel's 128-key tiles, and is held against the
JAX reference's Pallas flash kernel in interpret mode (as
``tests/test_torch_attention.py`` runs it) within chip_smoke.py's
FLASH_TIGHT: one bf16 rounding of |want| plus 1e-3. The split's own error
is bounded by 2^-16 |P| over P in (0, 1].

    PYTHONPATH=src python tests/test_torch_flash_split.py

prints, for every case, the largest error of the split and of the
``P_hi``-only variant (P rounded to bf16 once, another function) against
the reference.
"""
from __future__ import annotations

import ast
import json
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops

BN = 128                                  # the kernel's keys per tile
MASKED = -1e30
SPLIT_BOUND = 2.0 ** -16


def smoke_constant(name: str):
    """The value chip_smoke.py assigns to ``name`` at module level, read
    without importing the script."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    for node in ast.parse(path.read_text(), str(path)).body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == name):
            return eval(compile(ast.Expression(node.value), str(path),
                                "eval"), {})
    raise LookupError(f"chip_smoke.py assigns no {name}")


FLASH_TIGHT = smoke_constant("FLASH_TIGHT")

CASES = {  # B, Sq, Skv, H, KV, hd, causal, q_offset
    "GQA 3:1 hd128 causal": (1, 256, 256, 6, 2, 128, True, 0),
    "GQA 3:1 hd128 non-causal": (1, 256, 256, 6, 2, 128, False, 0),
    "MQA hd32 causal": (2, 96, 96, 4, 1, 32, True, 0),
    "MQA hd32 non-causal": (2, 96, 96, 4, 1, 32, False, 0),
    "MQA hd64 causal": (1, 128, 128, 4, 1, 64, True, 0),
    "MQA hd64 non-causal": (1, 128, 128, 4, 1, 64, False, 0),
    "q_offset 128 hd64": (1, 64, 192, 4, 2, 64, True, 128),
    "ragged 100x200 hd64 q_offset 100": (1, 100, 200, 6, 3, 64, True, 100),
    "ragged 200x200 hd128 causal": (1, 200, 200, 3, 1, 128, True, 0),
}


def split_p(p: torch.Tensor):
    """(P_hi, P_lo) as fp32 tensors: P rounded to bf16, and the rest of P
    rounded to bf16 (P - P_hi is exact in fp32)."""
    hi = p.to(torch.bfloat16).float()
    return hi, (p - hi).to(torch.bfloat16).float()


def split_flash(q, k, v, *, causal: bool, q_offset: int = 0,
                hi_only: bool = False) -> torch.Tensor:
    """The bf16 kernel's function in plain fp32 torch: bf16 q and k
    multiplied with fp32 sums, the scale after the product, -1e30 for
    causally masked scores, an online softmax over 128-key tiles (keys past
    Skv simply absent), ``acc += P_hi V + P_lo V`` (``P_hi V`` alone with
    ``hi_only``), output ``acc / max(l, 1e-30)`` rounded once to bf16."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    heads = torch.arange(H) // (H // KV)
    qf = q.float().transpose(1, 2)                   # (B, H, Sq, hd)
    kf = k.float()[:, :, heads].transpose(1, 2)      # (B, H, Skv, hd)
    vf = v.float()[:, :, heads].transpose(1, 2)
    m = torch.full((B, H, Sq, 1), MASKED)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, Sq, hd))
    qpos = q_offset + torch.arange(Sq)
    for kv0 in range(0, Skv, BN):
        kb, vb = kf[:, :, kv0:kv0 + BN], vf[:, :, kv0:kv0 + BN]
        s = (qf @ kb.transpose(-1, -2)) * hd ** -0.5
        if causal:
            kpos = kv0 + torch.arange(kb.shape[2])
            s = s.masked_fill(kpos[None, :] > qpos[:, None], MASKED)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        hi, lo = split_p(p)
        pv = hi @ vb if hi_only else hi @ vb + lo @ vb
        acc = acc * alpha + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).to(torch.bfloat16)


def _inputs(B, Sq, Skv, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(torch.bfloat16) for shape in ((B, Sq, H, hd), (B, Skv, KV, hd),
                                              (B, Skv, KV, hd))]


def _reference(q, k, v, *, causal, q_offset):
    """The JAX reference's Pallas flash kernel in interpret mode, in bf16."""
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (q, k, v))
    out = jops.flash_attention(jq, jk, jv, causal=causal, q_offset=q_offset,
                               interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def _errors(label):
    B, Sq, Skv, H, KV, hd, causal, qo = CASES[label]
    q, k, v = _inputs(B, Sq, Skv, H, KV, hd)
    want = _reference(q, k, v, causal=causal, q_offset=qo)
    split = split_flash(q, k, v, causal=causal, q_offset=qo).float()
    hi = split_flash(q, k, v, causal=causal, q_offset=qo,
                     hi_only=True).float()
    return want, split, hi


@pytest.mark.parametrize("label", CASES)
def test_split_p_flash_matches_reference_within_tight_limit(label):
    want, split, _ = _errors(label)
    assert split.shape == want.shape
    assert torch.isfinite(split).all()
    np.testing.assert_allclose(split.numpy(), want.numpy(),
                               atol=FLASH_TIGHT["atol"],
                               rtol=FLASH_TIGHT["rtol"])


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (1.0, 10.0), (10.0, 80.0)])
def test_split_error_bounded(lo, hi):
    """|P - P_hi - P_lo| <= 2^-16 |P| for P = exp(-t), t in [lo, hi]: the
    normal fp32 range a softmax weight in (0, 1] takes."""
    t = torch.from_numpy(np.random.default_rng(7).uniform(
        lo, hi, 200_000).astype(np.float32))
    p = torch.cat([torch.exp(-t), torch.tensor([1.0])])
    p_hi, p_lo = split_p(p)
    assert ((p - p_hi - p_lo).abs() <= SPLIT_BOUND * p).all()
    # P_hi alone errs by up to 2^-9 |P|: the split is what removes it
    assert ((p - p_hi).abs() > SPLIT_BOUND * p).any()


def test_split_error_bounded_near_rounding_ties():
    """Values a half bf16 ulp from a representable value, where P_hi's
    rounding error is largest."""
    base = torch.exp(-torch.linspace(0.0, 60.0, 4001))
    bits = base.view(torch.int32) & ~0xFFFF
    p = (bits | 0x7FFF).view(torch.float32)  # just under a tie
    p = torch.cat([p, (bits | 0x8001).view(torch.float32)])  # just over
    p = p[(p > 0) & (p <= 1)]
    p_hi, p_lo = split_p(p)
    assert ((p - p_hi - p_lo).abs() <= SPLIT_BOUND * p).all()


if __name__ == "__main__":
    for label in CASES:
        want, split, hi = _errors(label)
        print(json.dumps({
            "case": label,
            "split_max_abs_err": float((split - want).abs().max()),
            "p_hi_only_max_abs_err": float((hi - want).abs().max()),
            "p_hi_only_within_tight": bool(
                ((hi - want).abs() <= FLASH_TIGHT["atol"]
                 + FLASH_TIGHT["rtol"] * want.abs()).all())}))
