"""Core neural-net layers: norms, rotary embeddings, attention, MLP.

Port of ``repro/models/layers.py``. Functional as in the reference:
``init_*`` draw parameter dicts, the other functions consume them. Each
function keeps the reference's order of operations and dtypes, path by path:
the dense ``attention`` scales q in the activation dtype before its products
and masks with -inf, the blockwise branch guards all-masked rows,
``decode_attention`` masks with the dtype's smallest finite value, and the
flash path (``ops.flash_attention``) casts q to fp32, then scales, and masks
with -1e30. In bf16 these give different bits; none of them is unified with
another. Products that the reference computes in fp32 from bf16 operands
(``preferred_element_type=float32``) cast their operands to fp32 here, which
gives the same exact products and fp32 sums.

qk-norm (``cfg.use_qk_norm``, qwen3-moe) normalizes q and k per head after
the qkv biases and before rope, as the reference does (``layers.py:319``).
:func:`apply_attention` also takes the reference's cross-attention source
``kv_x`` (vlm, whisper), ``causal`` and ``use_rope`` (whisper's encoder)
and its paged-decode branch (a page pool with a ``page_table``), and the
explicit path's ``attn_impl`` hook (:mod:`repro_torch.models.parallel`).

On a mesh whose ``tp`` axis is wider than 1 (a ``shard`` callback from
:func:`repro_torch.sharding.make_shard_fn`) the attention block and the
MLP hold this rank's part of their weights (the layout of
:func:`repro_torch.sharding.param_specs`): the heads of ``wq``/``wo`` and,
where they divide, the KV heads of ``wk``/``wv``, the columns of
``w_gate``/``w_in`` and the rows of ``w_out``. The replicated input enters
through :func:`repro_torch.partition.copy_to` and the partial output sums
leave through :func:`repro_torch.partition.reduce_from`, where GSPMD puts
its collectives. When the KV heads do not divide ``tp`` each rank takes
the contiguous block of KV heads its q heads map to, as the reference's
``_flash_sharded`` does, in the flash path, the plain one and decode.
Cross-attention (vlm, whisper) splits the same way. Where ``tp`` does not
divide the q heads (or an MLP's ``d_ff``) the block keeps its weights
whole and runs whole on every rank.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import partition as P
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=torch.float32, device=device)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dtype)


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------


def rope_table(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """(sin, cos) tables for integer positions; shape (..., head_dim/2)."""
    half = head_dim // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); sin/cos: (S, hd/2) or (B, S, hd/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if sin.dim() == 2:  # (S, half) -> broadcast over batch and heads
        sin_b, cos_b = sin[None, :, None, :], cos[None, :, None, :]
    else:  # (B, S, half)
        sin_b, cos_b = sin[:, :, None, :], cos[:, :, None, :]
    dtype = x.dtype
    x1f, x2f = x1.float(), x2.float()
    out1 = x1f * cos_b - x2f * sin_b
    out2 = x2f * cos_b + x1f * sin_b
    return torch.cat([out1, out2], dim=-1).to(dtype)


def sinusoidal_positions(positions: torch.Tensor,
                         d_model: int) -> torch.Tensor:
    """Transformer sinusoidal embedding for integer positions ->
    (..., d_model)."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Attention (dense or blockwise online softmax; GQA; causal or full)
# ---------------------------------------------------------------------------


def _gqa_scores(q, k):
    # q: (B, Sq, KV, G, hd), k: (B, Skv, KV, hd) -> (B, KV, G, Sq, Skv) fp32
    return torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float())


def _gqa_out(p, v):
    # p: (B, KV, G, Sq, Skv), v: (B, Skv, KV, hd) -> (B, Sq, KV, G, hd) fp32;
    # p is rounded to v's dtype first, as in the reference
    return torch.einsum("bkgqs,bskh->bqkgh", p.to(v.dtype).float(), v.float())


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, q_offset: int = 0, kv_block: int = 1024,
              dense_threshold: int = 2048) -> torch.Tensor:
    """Multi-head attention with GQA head grouping. q: (B, Sq, H, hd);
    k, v: (B, Skv, KV, hd).

    For short KV (<= dense_threshold) or single-query decode the dense path
    is used (one product pair); otherwise KV is processed in blocks of
    ``kv_block`` with an online softmax."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = (q * scale).reshape(B, Sq, KV, G, hd)
    q_pos = q_offset + torch.arange(Sq, device=q.device)

    if Sq == 1 or Skv <= dense_threshold:
        s = _gqa_scores(qg, k)
        if causal:
            kv_pos = torch.arange(Skv, device=q.device)
            mask = kv_pos[None, :] <= q_pos[:, None]  # (Sq, Skv)
            s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = _gqa_out(p, v)
        return o.reshape(B, Sq, H, hd).to(q.dtype)

    # ---- blockwise path ----------------------------------------------------
    nblk = -(-Skv // kv_block)
    pad = nblk * kv_block - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    acc = torch.zeros((B, Sq, KV, G, hd), dtype=torch.float32,
                      device=q.device)
    m = torch.full((B, KV, G, Sq), float("-inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    for blk in range(nblk):
        start = blk * kv_block
        kblk, vblk = k[:, start:start + kv_block], v[:, start:start + kv_block]
        s = _gqa_scores(qg, kblk)  # (B, KV, G, Sq, kv_block)
        kv_pos = start + torch.arange(kv_block, device=q.device)
        valid = kv_pos[None, :] < Skv  # mask zero padding
        if causal:
            valid = valid & (kv_pos[None, :] <= q_pos[:, None])
        else:
            valid = valid.expand(Sq, kv_block)
        s = s.masked_fill(~valid, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # all-masked rows (m_new == -inf): scale factors become 0
        m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        alpha = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(valid, p, 0.0)
        l = l * alpha + p.sum(dim=-1)
        o_blk = _gqa_out(p, vblk)  # (B, Sq, KV, G, hd) fp32
        acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + o_blk
        m = m_new
    l = l.clamp_min(1e-20)
    out = acc / l.permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Single-token attention with per-row valid lengths. q: (B, 1, H, hd);
    k, v: (B, Smax, KV, hd); positions > ``lengths[b]`` are masked with the
    smallest finite fp32 value (inactive rows give garbage, not NaN)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg = (q * scale).reshape(B, Sq, KV, G, hd)
    s = _gqa_scores(qg, k)  # (B, KV, G, Sq, Smax) fp32
    kv_pos = torch.arange(k.shape[1], device=q.device)
    mask = kv_pos[None, :] <= lengths[:, None]  # (B, Smax)
    s = s.masked_fill(~mask[:, None, None, None, :],
                      torch.finfo(s.dtype).min)
    p = torch.softmax(s, dim=-1)
    o = _gqa_out(p, v)
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def paged_decode_attention(q, k_upd, v_upd, pages_k, pages_v, block_table,
                           lengths) -> torch.Tensor:
    """:func:`decode_attention` of q (B, 1, H, hd) over each row's pages
    (``block_table`` (B, pmax)) with the new token ``k_upd``/``v_upd`` (B,
    1, KV, hd) at ``lengths[b]``; a row whose length lies past the
    gathered width keeps what it gathered (the reference's drop). The
    pools are read, not written."""
    # local: kvcache imports ssm, which imports this module
    from repro_torch.models.kvcache import gather_pages

    gk, gv = gather_pages(pages_k, block_table), gather_pages(pages_v,
                                                              block_table)
    rows = torch.arange(q.shape[0], device=q.device)
    at = lengths.long().clamp(max=gk.shape[1] - 1)
    inside = (lengths < gk.shape[1])[:, None, None]
    gk[rows, at] = torch.where(inside, k_upd[:, 0], gk[rows, at])
    gv[rows, at] = torch.where(inside, v_upd[:, 0], gv[rows, at])
    return decode_attention(q, gk.to(q.dtype), gv.to(q.dtype),
                            lengths=lengths)


# ---------------------------------------------------------------------------
# Flash-attention path (prefill, forward only)
# ---------------------------------------------------------------------------


def _flash_sharded(q, k, v, *, shard, causal: bool,
                   num_heads: Optional[int] = None):
    """The flash kernel for prefill when ``shard`` carries a mesh and its
    rules, as in the reference (``layers.py:202-248``): batch over ``dp``,
    heads over ``tp``; None where the reference returns None (no mesh, a
    batch the dp axes do not divide, ``num_heads`` (the model's; default
    ``q``'s, all of them) that the tp axis does not divide, fewer than 128
    queries). ``q``, ``k`` and
    ``v`` are this rank's: its rows and its heads, with ``k``/``v``
    already the KV block its q heads map to (:func:`apply_attention`
    selects it), so the kernel runs as the reference's ``shard_map`` body
    does, with ``bq = min(512, S)`` and ``bk = min(512, Skv)``."""
    if getattr(shard, "mesh", None) is None or \
            getattr(shard, "rules", None) is None:
        return None
    part = P.placement(shard)
    if part is not None and part.dp_n > 1 and \
            not getattr(shard, "rows_split", True):
        return None  # the whole batch on every rank: B % dp_n
    if part is not None and (num_heads or q.shape[2]) % part.tp_n:
        return None  # the heads stay whole: H % tp_n
    Sq = q.shape[1]
    if Sq < 128:
        return None
    return ops.flash_attention(q, k, v, causal=causal, bq=min(512, Sq),
                               bk=min(512, k.shape[1]))


def kv_heads_held(cfg: ModelConfig, part) -> tuple:
    """(start, count) of the KV heads a rank holds at placement ``part``:
    all of them without a ``tp`` axis or when ``tp`` does not divide the
    heads (attention stays whole), its contiguous share when ``tp``
    divides them, else the block its q heads map to."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if part is None or part.tp is None or H % part.tp_n:
        return 0, KV
    if KV % part.tp_n == 0:
        n = KV // part.tp_n
        return part.tp_index * n, n
    return P.kv_block(H, KV, part)


# ---------------------------------------------------------------------------
# Attention block (params + apply): self- or cross-attention, dense or paged
# cache
# ---------------------------------------------------------------------------


def _normal(gen, shape, std, device):
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * std


def init_attention(gen: torch.Generator, cfg: ModelConfig, *,
                   kv_in_dim: Optional[int] = None,
                   layers_for_scale: Optional[int] = None,
                   device=None) -> dict:
    """q/k/v/o projections; k and v read ``kv_in_dim`` features (a
    cross-attention source) when given, and the output projection's scale
    follows ``layers_for_scale`` (whisper's encoder) when given."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kv_in = kv_in_dim or d
    nl = layers_for_scale or cfg.num_layers
    std = 0.02
    p = {
        "wq": _normal(gen, (d, h, hd), std, device),
        "wk": _normal(gen, (kv_in, kv, hd), std, device),
        "wv": _normal(gen, (kv_in, kv, hd), std, device),
        "wo": _normal(gen, (h, hd, d), std / math.sqrt(2 * nl), device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), device=device)
        p["bk"] = torch.zeros((kv, hd), device=device)
        p["bv"] = torch.zeros((kv, hd), device=device)
    if cfg.use_qk_norm:
        p["q_norm"] = init_rmsnorm(hd, device)
        p["k_norm"] = init_rmsnorm(hd, device)
    return p


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # "bsd,dhk->bshk": one product over the flattened head axes
    d, h, k = w.shape
    return torch.matmul(x, w.to(x.dtype).reshape(d, h * k)).unflatten(
        -1, (h, k))


def apply_attention(p, cfg: ModelConfig, x: torch.Tensor, *,
                    kv_x: Optional[torch.Tensor] = None,
                    cache: Optional[dict] = None, pos=None,
                    causal: bool = True, use_rope: bool = True, shard=None,
                    attn_impl=None, page_table: Optional[dict] = None,
                    flash: bool = True):
    """Self- or cross-attention; returns (out, cache).

    ``kv_x`` (B, Skv, kv_in) is a cross-attention source: k and v are
    projected from it, rope is skipped (as with ``use_rope=False``) and the
    attention is not causal. A dense ``cache`` ``{'k', 'v'}`` (B, Smax, KV,
    hd) is written in place: positions [0, S) in prefill (``pos`` None),
    [pos, pos + S) in decode, which then attends over the whole cache under
    the causal mask. Prefill with a cache and a ``shard`` carrying a mesh
    takes the flash kernel (causal self-attention only).

    A paged ``cache`` ``{'k_pages', 'v_pages'}`` (num_pages, page_size, KV,
    hd) is decode only (S == 1): ``pos`` is the (B,) vector of lengths,
    ``page_table`` holds ``block_table`` (B, pmax) and ``lengths``. Each
    row attends over its gathered pages with its new token at
    ``lengths[b]``; the pool is not written here, and the returned cache
    is the token update ``{'k_upd', 'v_upd'}`` (B, 1, KV, hd) that
    :func:`repro_torch.models.kvcache.scatter_token` writes into it. A hook
    with a truthy ``paged`` attribute
    (:func:`repro_torch.models.parallel.make_paged_decode_attention`)
    takes over the exchange, the gather and the attention there, called as
    ``attn_impl(q, k_upd, v_upd, pages_k=, pages_v=, block_table=,
    lengths=) -> (o, k_full, v_full)``; the k/v it returns are the
    update. Under a ``tp`` axis the pool holds this rank's KV heads
    (:func:`kv_heads_held`).

    ``attn_impl`` (the explicit path's hook, ``(q, k, v, *, causal,
    q_offset) -> o``) replaces the core attention call: projections,
    biases, qk-norm and rope run here first, and the flash path is
    bypassed. ``flash=False`` keeps the prefill on the plain attention
    under a ``shard`` (the encoder-decoder, whose reference passes no
    shard function to its attention).

    Cross-attention under ``tp`` splits its q and KV heads as
    self-attention does: each rank projects K/V for its own KV heads from
    the whole source ``kv_x``, which enters through ``copy_to`` as ``x``
    does. It stays on the plain attention, as in the reference."""
    dtype = x.dtype
    part = P.tp_of(shard) if attn_impl is None else None
    if part is not None and cfg.num_heads % part.tp_n:
        part = None  # heads tp does not divide: the block stays whole
    wk, wv = p["wk"], p["wv"]
    bk, bv = (p["bk"], p["bv"]) if cfg.qkv_bias else (None, None)
    q_norm, k_norm = (p["q_norm"], p["k_norm"]) if cfg.use_qk_norm \
        else (None, None)
    if part is not None:
        mesh, tp = part.mesh, part.tp
        x = P.copy_to(x, mesh, tp)
        if kv_x is not None:
            kv_x = P.copy_to(kv_x, mesh, tp)
        if cfg.num_kv_heads % part.tp_n:
            # whole KV weights (param_specs keeps them so): this rank's
            # block, its gradient summed over tp (every rank uses a share)
            start, n = kv_heads_held(cfg, part)
            wk = P.copy_to(wk, mesh, tp).narrow(1, start, n)
            wv = P.copy_to(wv, mesh, tp).narrow(1, start, n)
            if bk is not None:
                bk = P.copy_to(bk, mesh, tp).narrow(0, start, n)
                bv = P.copy_to(bv, mesh, tp).narrow(0, start, n)
        if q_norm is not None:  # scales of this rank's heads only
            q_norm = P.copy_to(q_norm, mesh, tp)
            k_norm = P.copy_to(k_norm, mesh, tp)
    src = kv_x if kv_x is not None else x
    q = _project(x, p["wq"])
    k = _project(src, wk)
    v = _project(src, wv)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dtype)
        k = k + bk.to(dtype)
        v = v + bv.to(dtype)
    if cfg.use_qk_norm:
        q = rmsnorm(q, q_norm, cfg.norm_eps)
        k = rmsnorm(k, k_norm, cfg.norm_eps)

    per_row = isinstance(pos, torch.Tensor) and pos.dim() == 1
    q_offset = 0 if pos is None else pos
    if use_rope and cfg.rope_theta > 0 and kv_x is None:
        steps = torch.arange(x.shape[1], device=x.device)
        # paged decode: per-row positions (B, S); else (S,)
        positions = pos[:, None] + steps if per_row else steps + q_offset
        sin, cos = rope_table(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)

    if cache is not None and kv_x is not None:
        raise ValueError("cross-attention KV is not cached here")
    if cache is not None and "k_pages" in cache:
        if page_table is None:
            raise ValueError("paged cache requires page_table=")
        kp, vp = cache["k_pages"], cache["v_pages"]
        k_upd, v_upd = k.to(kp.dtype), v.to(vp.dtype)
        bt, lengths = page_table["block_table"], page_table["lengths"]
        if attn_impl is not None and getattr(attn_impl, "paged", False):
            o, k_upd, v_upd = attn_impl(q, k_upd, v_upd, pages_k=kp,
                                        pages_v=vp, block_table=bt,
                                        lengths=lengths)
        else:
            o = paged_decode_attention(q, k_upd, v_upd, kp, vp, bt, lengths)
        return _out_proj(o, p["wo"], part), {"k_upd": k_upd, "v_upd": v_upd}

    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        S = x.shape[1]
        if pos is None:  # prefill: write the whole prefix
            ck[:, :S] = k.to(ck.dtype)
            cv[:, :S] = v.to(cv.dtype)
        else:  # decode: write one (or few) positions, attend over the cache
            ck[:, pos:pos + S] = k.to(ck.dtype)
            cv[:, pos:pos + S] = v.to(cv.dtype)
            k, v = ck.to(dtype), cv.to(dtype)

    o = None
    if attn_impl is not None:
        o = attn_impl(q, k, v, causal=causal and kv_x is None,
                      q_offset=q_offset)
    elif (flash and shard is not None and kv_x is None and causal
            and cache is not None and pos is None):
        o = _flash_sharded(q, k, v, shard=shard, causal=True,
                           num_heads=cfg.num_heads)
    if o is None:
        o = attention(q, k, v, causal=causal and kv_x is None,
                      q_offset=q_offset)
    return _out_proj(o, p["wo"], part), cache


def _out_proj(o: torch.Tensor, wo: torch.Tensor, part=None) -> torch.Tensor:
    # "bshk,hkd->bsd": one product over the flattened head axes; with this
    # rank's heads a partial sum, reduced over tp
    B, S, H, hd = o.shape
    out = torch.matmul(o.reshape(B, S, H * hd),
                       wo.to(o.dtype).reshape(H * hd, -1))
    if part is not None:
        out = P.reduce_from(out, part.mesh, part.tp)
    return out


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d: int, d_ff: int, num_layers: int,
             device=None) -> dict:
    std = 0.02
    return {
        "w_gate": _normal(gen, (d, d_ff), std, device),
        "w_in": _normal(gen, (d, d_ff), std, device),
        "w_out": _normal(gen, (d_ff, d), std / math.sqrt(2 * num_layers),
                         device),
    }


def apply_mlp(p, x: torch.Tensor, shard=None,
              d_ff: Optional[int] = None) -> torch.Tensor:
    """SwiGLU. With a ``shard`` whose ``tp`` axis is wider than 1 and
    divides the hidden width ``d_ff`` (the whole layer's) the weights are
    this rank's columns of ``w_gate``/``w_in`` and rows of ``w_out``: the
    input enters through ``copy_to`` and the output is reduced over tp.
    Where tp does not divide ``d_ff`` the weights are whole and the MLP
    runs whole on every rank, with no collective (the reference's
    ``_maybe`` rule)."""
    part = P.tp_of(shard)
    if part is not None and d_ff is None:
        raise ValueError("apply_mlp on a tp axis needs the layer's d_ff")
    if part is not None and d_ff % part.tp_n:
        part = None
    if part is not None:
        x = P.copy_to(x, part.mesh, part.tp)
    dtype = x.dtype
    g = torch.matmul(x, p["w_gate"].to(dtype))
    h = torch.matmul(x, p["w_in"].to(dtype))
    out = torch.matmul(F.silu(g) * h, p["w_out"].to(dtype))
    if part is not None:
        out = P.reduce_from(out, part.mesh, part.tp)
    return out
