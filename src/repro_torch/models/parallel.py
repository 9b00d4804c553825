"""Engine-routed attention exchanges for the explicit whole-model path.

Port of ``repro/models/parallel.py`` (``ATTN_MODES``, ``make_tp_attention``
:60-88, ``make_paged_decode_attention`` :91-139, ``make_sp_attention``
:142-226, ``make_attn_impl`` :229-239). Inside
the whole-model step (:func:`repro_torch.train.step.
make_whole_model_train_step_explicit`) every rank of a
:class:`~repro_torch.launch.mesh.ProcessMesh` axis holds its rows of the
batch, and attention, whose scores couple every query to every key of the
same row, needs a resharding exchange. Two modes cover the two classic
layouts, every wire hop a :class:`~repro_torch.comm.engine.CollectiveEngine`
call under a registered :mod:`~repro_torch.comm.callsites` tag:

* **tp** (head-parallel): q/k/v go from (B_loc, S, H, hd) to (B, S, H_loc,
  hd) through an all-to-all that splits the heads and gathers the batch
  (``tp.qkv``); the port's plain :func:`~repro_torch.models.layers.
  attention` runs on the full batch with the local heads, and the inverse
  exchange (``tp.out``) restores the batch layout. Heads and KV heads are
  both split contiguously, so local q head ``j`` still maps to local kv
  head ``j // G``. Only whole heads move: the result equals local dense
  attention.
* **sp** (sequence-parallel ring attention): q/k/v go to (B, S_loc, H, hd)
  (``sp.qkv``), the K/V block circulates the ring in both directions at
  once by ``engine.ring_exchange`` (``sp.kv``; after hop j a rank holds the
  blocks of ranks r - j and r + j, so ``n // 2`` hops visit all n blocks),
  and an online softmax folds each block in with global positions for the
  causal mask; the inverse exchange (``sp.out``) restores the batch layout.
  Equal to the dense computation up to the softmax's reassociation (~1e-6
  in fp32). The fold is torch ops, as the reference's is jnp outside any
  Pallas kernel.

The exchanges are differentiable (the engine's autograd functions), so the
hooks train. Factories return ``attn_impl(q, k, v, *, causal, q_offset=0)
-> o`` hooks that :func:`repro_torch.models.layers.apply_attention` takes
through ``attn_impl=``: projections, biases, qk-norm and rope run before
the hook (rope depends only on the sequence index, so applying it before
the exchange is exact in both modes).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.comm.callsites import (DECODE_OUT, DECODE_QKV, SP_KV, SP_OUT,
                                        SP_QKV, TP_OUT, TP_QKV)
from repro_torch.comm.engine import CollectiveEngine, schedules_for
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (_gqa_out, _gqa_scores, attention,
                                       paged_decode_attention)

ATTN_MODES = ("tp", "sp")


def _engine_for(mesh, engine: Optional[CollectiveEngine]) -> CollectiveEngine:
    return engine or CollectiveEngine.for_mesh(mesh, schedule="auto")


def make_tp_attention(cfg: ModelConfig, mesh, *, axis: str = "x",
                      engine: Optional[CollectiveEngine] = None,
                      schedule: Optional[str] = None) -> Callable:
    """Head-parallel attention hook: exchange heads out, batch in.

    Requires ``num_heads`` and ``num_kv_heads`` divisible by the axis size
    (GQA keeps separate q and kv head counts, hence three forward
    exchanges)."""
    n = mesh.shape[axis]
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if H % n or KV % n:
        raise ValueError(
            f"num_heads={H} and num_kv_heads={KV} must be divisible by the "
            f"{axis!r} axis size {n} for the head-parallel (tp) exchange")
    engine = _engine_for(mesh, engine)

    def attn_impl(q, k, v, *, causal: bool = True, q_offset=0):
        def gather_heads(t):  # (B_loc, S, H, hd) -> (B, S, H_loc, hd)
            return engine.all_to_all_tiles(t, axis, split_axis=2,
                                           concat_axis=0, schedule=schedule,
                                           callsite=TP_QKV)
        o = attention(gather_heads(q), gather_heads(k), gather_heads(v),
                      causal=causal, q_offset=q_offset)
        return engine.all_to_all_tiles(o, axis, split_axis=0, concat_axis=2,
                                       schedule=schedule, callsite=TP_OUT)

    return attn_impl


def make_paged_decode_attention(cfg: ModelConfig, mesh, *, axis: str = "x",
                                engine: Optional[CollectiveEngine] = None,
                                schedule: Optional[str] = None) -> Callable:
    """Head-parallel paged-decode hook for the explicit serving path
    (reference ``:91-139``).

    Per-token exchanges are tiny, the latency band of the alpha-beta
    model, so they carry their own ``decode.*`` tags and resolve apart
    from the training-sized ``tp.*`` entries. The layout mirrors
    :func:`make_tp_attention`: q and the token's k/v go from (B_loc, 1,
    heads, hd) to (B, 1, heads_loc, hd) (three exchanges under
    ``decode.qkv``), the rank-local page pool (its KV heads, split over
    ``axis``) is gathered for the whole batch and the new token written at
    ``lengths[b]`` with the reference's drop rule, the plain
    :func:`~repro_torch.models.layers.decode_attention` runs on the whole
    batch with the local heads, and the inverse exchange (``decode.out``)
    restores the batch layout. Every wire hop is an engine call.

    Returns the hook ``(q, k_upd, v_upd, *, pages_k, pages_v, block_table,
    lengths) -> (o, k_full, v_full)`` with ``paged = True``:
    ``block_table`` and ``lengths`` are the whole batch's, and the
    exchanged whole-batch k/v go back to the layer loop, which scatters
    them into the local pool."""
    n = mesh.shape[axis]
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if H % n or KV % n:
        raise ValueError(
            f"num_heads={H} and num_kv_heads={KV} must be divisible by the "
            f"{axis!r} axis size {n} for the paged decode exchange")
    engine = _engine_for(mesh, engine)

    def attn_impl(q, k_upd, v_upd, *, pages_k, pages_v, block_table,
                  lengths):
        def gather_heads(t):  # (B_loc, 1, heads, hd) -> (B, 1, heads_loc, hd)
            return engine.all_to_all_tiles(t.contiguous(), axis,
                                           split_axis=2, concat_axis=0,
                                           schedule=schedule,
                                           callsite=DECODE_QKV)
        qh, kh, vh = gather_heads(q), gather_heads(k_upd), gather_heads(v_upd)
        o = paged_decode_attention(qh, kh, vh, pages_k, pages_v, block_table,
                                   lengths)
        o = engine.all_to_all_tiles(o, axis, split_axis=0, concat_axis=2,
                                    schedule=schedule, callsite=DECODE_OUT)
        return o, kh, vh

    attn_impl.paged = True
    return attn_impl


def make_sp_attention(cfg: ModelConfig, mesh, *, axis: str = "x",
                      engine: Optional[CollectiveEngine] = None,
                      schedule: Optional[str] = None) -> Callable:
    """Sequence-parallel ring-attention hook.

    Requires the sequence length divisible by the axis size (checked at
    the call). ``schedule`` overrides the all-to-all exchanges; the K/V
    rotation honours it only when the name is registered for
    ``ring_exchange`` (an all-to-all-only name like ``native`` falls back
    to the engine-wide resolution instead of raising)."""
    ax = mesh.axis(axis)
    n = ax.size
    engine = _engine_for(mesh, engine)
    rx_schedule = schedule if schedule in schedules_for("ring_exchange") \
        else None

    def attn_impl(q, k, v, *, causal: bool = True, q_offset=0):
        B_loc, S, H, hd = q.shape
        if S % n:
            raise ValueError(
                f"sequence length {S} must be divisible by the {axis!r} "
                f"axis size {n} for the sequence-parallel (sp) exchange")

        def gather_seq(t):  # (B_loc, S, H, hd) -> (B, S_loc, H, hd)
            return engine.all_to_all_tiles(t, axis, split_axis=1,
                                           concat_axis=0, schedule=schedule,
                                           callsite=SP_QKV)
        qs, ks, vs = gather_seq(q), gather_seq(k), gather_seq(v)
        B, S_loc = qs.shape[0], S // n
        KV = ks.shape[2]
        G = H // KV
        r = ax.index
        scale = 1.0 / math.sqrt(hd)
        qg = (qs * scale).reshape(B, S_loc, KV, G, hd)
        q_pos = q_offset + r * S_loc + torch.arange(S_loc, device=q.device)

        def fold(carry, kblk, vblk, kv_start):
            # one online-softmax step over a ring block (the accumulator of
            # the blockwise path in layers.attention, global positions)
            acc, m, l = carry
            s = _gqa_scores(qg, kblk)  # (B, KV, G, S_loc, S_loc) fp32
            valid = None
            if causal:
                kv_pos = kv_start + torch.arange(S_loc, device=q.device)
                valid = kv_pos[None, :] <= q_pos[:, None]
                s = s.masked_fill(~valid, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
            alpha = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
            p = torch.exp(s - m_safe[..., None])
            if causal:
                p = torch.where(valid, p, 0.0)
            l_new = l * alpha + p.sum(dim=-1)
            o_blk = _gqa_out(p, vblk)
            acc_new = acc * alpha.permute(0, 3, 1, 2)[..., None] + o_blk
            return acc_new, m_new, l_new

        f32 = dict(dtype=torch.float32, device=q.device)
        carry = (torch.zeros((B, S_loc, KV, G, hd), **f32),
                 torch.full((B, KV, G, S_loc), float("-inf"), **f32),
                 torch.zeros((B, KV, G, S_loc), **f32))
        carry = fold(carry, ks, vs, r * S_loc)  # the local block first

        # the kv block rides both ring directions at once: after hop j the
        # fwd buffer holds rank r-j's block and the bwd buffer rank r+j's,
        # so n//2 hops visit all n blocks (at j == n-j both name the same
        # source: fold only one)
        kv = torch.cat([ks, vs], dim=-1)
        fwd = bwd = kv
        for j in range(1, n // 2 + 1):
            fwd, bwd = engine.ring_exchange(fwd, bwd, axis,
                                            schedule=rx_schedule,
                                            callsite=SP_KV)
            carry = fold(carry, fwd[..., :hd], fwd[..., hd:],
                         ((r - j) % n) * S_loc)
            if j != n - j:
                carry = fold(carry, bwd[..., :hd], bwd[..., hd:],
                             ((r + j) % n) * S_loc)

        acc, _, l = carry
        l = l.clamp_min(1e-20)
        o = (acc / l.permute(0, 3, 1, 2)[..., None]) \
            .reshape(B, S_loc, H, hd).to(qs.dtype)
        return engine.all_to_all_tiles(o, axis, split_axis=0, concat_axis=1,
                                       schedule=schedule, callsite=SP_OUT)

    return attn_impl


def make_attn_impl(mode: str, cfg: ModelConfig, mesh, *, axis: str = "x",
                   engine: Optional[CollectiveEngine] = None,
                   schedule: Optional[str] = None) -> Callable:
    """Dispatch on ``mode`` in :data:`ATTN_MODES` (``"tp"`` / ``"sp"``)."""
    if mode == "tp":
        return make_tp_attention(cfg, mesh, axis=axis, engine=engine,
                                 schedule=schedule)
    if mode == "sp":
        return make_sp_attention(cfg, mesh, axis=axis, engine=engine,
                                 schedule=schedule)
    raise ValueError(f"unknown attention mode {mode!r}; modes: {ATTN_MODES}")
