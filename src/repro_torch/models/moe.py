"""Mixture-of-Experts layer with capacity-based scatter dispatch.

Port of ``repro/models/moe.py``. Tokens are routed into a (B, E, C, D)
buffer (batch row, expert, capacity slot) at positions from a per-row
exclusive cumulative count; a slot past an expert's capacity C goes to a
scratch column C that is sliced off, so it is dropped, as in the reference.
There is no dense one-hot dispatch product.

Two execution paths share the routing and scatter internals:

* :func:`apply_moe` — the reference's GSPMD program: one process holds
  every expert, or, on a mesh whose ``tp`` axis divides the experts, each
  rank of ``tp`` holds ``E / tp`` of them (the reference's expert split,
  ``sharding.py:152-156``) and the tokens of its ``data`` row.
* :func:`apply_moe_explicit` / :func:`make_apply_moe_explicit` — the
  expert-parallel path: every rank of a ring axis holds ``E / n`` experts
  (:func:`expert_shard`) and its own batch rows, and the dispatch and
  combine exchanges are ``CollectiveEngine.all_to_all_tiles`` calls under
  the ``moe.dispatch`` / ``moe.combine`` callsite tags, optionally
  pipelined into capacity strips through ``engine.pipelined`` so that the
  combine weighting of strip i follows strip i's landing. The reference
  runs this body under ``shard_map``; here it is the per-rank function of
  a :class:`~repro_torch.launch.mesh.ProcessMesh`.

Dtypes are the reference's: the router's logits and the top-k softmax in
fp32, the expert products in the activation dtype, the combine weights and
weighted outputs in fp32, their sum cast to the dtype, and the shared
expert added after that cast.

The combine sums each token's K weighted expert outputs in one fixed
order, ascending expert id, starting from 0.0: the order in which the
reference's scatter-add walks the (E, C) buffer on the CPU. A CUDA
``index_add_`` adds by atomics in no fixed order, so two greedy runs could
differ; a gather and K ordered additions cannot. ``torch.topk`` does not
promise ``lax.top_k``'s rule (the lower index wins a tie); with continuous
router logits ties do not occur.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import partition as P
from repro_torch.comm.callsites import MOE_COMBINE, MOE_DISPATCH
from repro_torch.comm.engine import CollectiveEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_mlp

# tuning-table callsite tags for the two expert exchanges: they are issued
# back-to-back around the expert FFN, so measured winners may differ from an
# isolated all-to-all's (the paired pattern autotune_mesh measures)
DISPATCH_CALLSITE = MOE_DISPATCH
COMBINE_CALLSITE = MOE_COMBINE


# ---------------------------------------------------------------------------
# explicit expert-parallel exchanges
# ---------------------------------------------------------------------------


def _monolithic(nchunks) -> bool:
    return isinstance(nchunks, int) and nchunks <= 1


def exchange_dispatch(buf: torch.Tensor, axis: str, engine: CollectiveEngine,
                      *, schedule: Optional[str] = None, nchunks=1,
                      consume=None, callsite: str = DISPATCH_CALLSITE
                      ) -> torch.Tensor:
    """Route a rank's dispatch buffer (B_loc, E, C, D) to the expert owners:
    the expert axis is split over the ranks of ``axis`` and the batch
    shards are concatenated, giving (B, E_loc, C, D). ``nchunks`` > 1 (or
    ``"auto"``) pipelines the exchange into capacity strips through
    ``engine.pipelined``; ``consume(strip, start)`` runs per landed
    strip."""
    if consume is None and _monolithic(nchunks):
        return engine.all_to_all_tiles(buf, axis, split_axis=1,
                                       concat_axis=0, schedule=schedule,
                                       callsite=callsite)
    return engine.pipelined("all_to_all_tiles", buf, axis, nchunks=nchunks,
                            split_axis=2, tile_split_axis=1,
                            tile_concat_axis=0, consume=consume,
                            schedule=schedule, callsite=callsite)


def exchange_combine(buf: torch.Tensor, axis: str, engine: CollectiveEngine,
                     *, schedule: Optional[str] = None, nchunks=1,
                     consume=None, callsite: str = COMBINE_CALLSITE
                     ) -> torch.Tensor:
    """Inverse of :func:`exchange_dispatch`: expert outputs (B, E_loc, C, D)
    back to the token-owning ranks as (B_loc, E, C, D), tagged
    ``moe.combine``. The combine weighting is the natural ``consume``."""
    if consume is None and _monolithic(nchunks):
        return engine.all_to_all_tiles(buf, axis, split_axis=0,
                                       concat_axis=1, schedule=schedule,
                                       callsite=callsite)
    return engine.pipelined("all_to_all_tiles", buf, axis, nchunks=nchunks,
                            split_axis=2, tile_split_axis=0,
                            tile_concat_axis=1, consume=consume,
                            schedule=schedule, callsite=callsite)


# ---------------------------------------------------------------------------
# parameters and routing
# ---------------------------------------------------------------------------


def _normal(gen, shape, std, device):
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * std


def init_moe(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """The reference's shapes and scales (normal, std 0.02; ``w_out`` 0.02
    / sqrt(2 * layers)), drawn in fp32 from ``gen``."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    std, out_std = 0.02, 0.02 / math.sqrt(2 * cfg.num_layers)
    p = {"router": _normal(gen, (d, e), std, device),
         "w_gate": _normal(gen, (e, d, f), std, device),
         "w_in": _normal(gen, (e, d, f), std, device),
         "w_out": _normal(gen, (e, f, d), out_std, device)}
    if cfg.shared_expert:
        p["shared"] = {"w_gate": _normal(gen, (d, f), std, device),
                       "w_in": _normal(gen, (d, f), std, device),
                       "w_out": _normal(gen, (f, d), out_std, device)}
    return p


def _capacity(cfg: ModelConfig, seq: int) -> int:
    c = int(math.ceil(seq * cfg.num_experts_per_tok * cfg.capacity_factor
                      / cfg.num_experts))
    return max(c, 1)


def route(p: dict, cfg: ModelConfig, x: torch.Tensor,
          part=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router: (probs (B, S, k) fp32, ids (B, S, k) int64); the top-k logits
    in descending order, renormalized by a softmax over the k. With a
    placement ``part`` the router holds this rank's experts' columns: its
    logits are gathered over ``tp`` into the whole (B, S, E), whose
    gradient is summed over ``tp`` before this rank's slice is kept."""
    logits = torch.matmul(x, p["router"].to(x.dtype)).float()
    if part is not None:
        logits = P.gather_summed(logits, part.mesh, part.tp, -1,
                                 source=P.TP)
    top_logits, ids = torch.topk(logits, cfg.num_experts_per_tok, dim=-1)
    return torch.softmax(top_logits, dim=-1), ids


# ---------------------------------------------------------------------------
# shared routing / scatter internals
# ---------------------------------------------------------------------------


def _dispatch_indices(ids: torch.Tensor, E: int, C: int):
    """Capacity bookkeeping: a per-row exclusive cumulative count gives each
    (token, expert) slot its position in the expert's capacity buffer.

    Returns ``(e_idx, c_idx, keep, onehot)``: e_idx / c_idx (B, S*K) flat
    scatter indices (dropped slots clamped to the scratch position C), keep
    (B, S*K) bool and onehot (B, S*K, E) int32 for the load metrics."""
    B, S, K = ids.shape
    flat_ids = ids.reshape(B, S * K)
    onehot = F.one_hot(flat_ids, E).to(torch.int32)
    pos_in_expert = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    pos = torch.gather(pos_in_expert, 2, flat_ids[..., None])[..., 0]
    keep = pos < C
    c_idx = torch.where(keep, pos, C).long()
    return flat_ids, c_idx, keep, onehot


def _scatter_rows(val: torch.Tensor, e_idx, c_idx, E: int, C: int):
    """``val`` (B, T, ...) into a zeroed (B, E, C + 1, ...) buffer at
    (row, e_idx, c_idx), then the scratch column sliced off. Kept slots
    have distinct positions; only dropped ones share the scratch column."""
    B = val.shape[0]
    out = val.new_zeros((B, E, C + 1) + tuple(val.shape[2:]))
    rows = torch.arange(B, device=val.device)[:, None]
    out[rows, e_idx, c_idx] = val
    return out[:, :, :C]


def _scatter_dispatch(tok: torch.Tensor, e_idx, c_idx, E: int, C: int):
    """(B, S*K, D) token copies into the (B, E, C, D) dispatch buffer."""
    return _scatter_rows(tok, e_idx, c_idx, E, C)


def _expert_ffn(p: dict, buf: torch.Tensor, dtype) -> torch.Tensor:
    """SwiGLU expert FFN on an expert-layout buffer (B, E[_loc], C, D): one
    batched product per expert over its (B * C) rows."""
    B, E, C, D = buf.shape
    xe = buf.permute(1, 0, 2, 3).reshape(E, B * C, D)
    g = torch.bmm(xe, p["w_gate"].to(dtype))
    h = torch.bmm(xe, p["w_in"].to(dtype))
    y = torch.bmm(F.silu(g) * h, p["w_out"].to(dtype))
    return y.reshape(E, B, C, -1).permute(1, 0, 2, 3)


def _combine_weights(probs, keep, e_idx, c_idx, E: int, C: int):
    """Top-k router probs scattered into expert layout: (B, E, C) fp32."""
    B = e_idx.shape[0]
    w = probs.reshape(B, -1) * keep
    return _scatter_rows(w, e_idx, c_idx, E, C)


def _combine_scatter(y_w, e_idx, c_idx, keep, S: int, K: int):
    """Weighted expert outputs (B, E, C, D) fp32 back to tokens (B, S, D)
    fp32: each token's K kept slots gathered and added in ascending expert
    id from 0.0 (a dropped slot adds +0.0). The reference scatter-adds
    them; on the CPU its scatter walks the (E, C) buffer in that order."""
    B, _, C, D = y_w.shape
    e = e_idx.reshape(B, S, K)
    order = torch.argsort(e, dim=-1)
    e = torch.gather(e, 2, order)
    c = torch.gather(c_idx.reshape(B, S, K), 2, order)
    kept = torch.gather(keep.reshape(B, S, K), 2, order)
    rows = torch.arange(B, device=y_w.device)[:, None, None]
    contrib = y_w[rows, e, c.clamp(max=C - 1)]  # (B, S, K, D)
    out = torch.zeros((B, S, D), dtype=torch.float32, device=y_w.device)
    for j in range(K):
        out = out + torch.where(kept[:, :, j, None], contrib[:, :, j], 0.0)
    return out


def _tokens(x: torch.Tensor, K: int) -> torch.Tensor:
    """(B, S, D) -> (B, S*K, D): each token K times, slot s*K + j."""
    return x.repeat_interleave(K, dim=1)


# ---------------------------------------------------------------------------
# single-process path
# ---------------------------------------------------------------------------


def _local_slots(e_idx, c_idx, keep, e0: int, e_loc: int, C: int):
    """The slots of experts [e0, e0 + e_loc) in local ids: (e, c, keep)
    with every other slot sent to the scratch column C of local expert 0
    and not kept."""
    mine = (e_idx >= e0) & (e_idx < e0 + e_loc)
    keep = keep & mine
    return (torch.where(mine, e_idx - e0, 0), torch.where(keep, c_idx, C),
            keep)


def apply_moe(p: dict, cfg: ModelConfig, x: torch.Tensor,
              aux: Optional[dict] = None, shard=None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D), per-batch-row dispatch groups. ``aux``
    (if given) receives ``moe_frac_tokens`` (E,) and ``moe_dropped``, fp32.
    ``shard`` is the activation-constraint callback, the identity on the
    local tensor: on a mesh of several ranks each rank runs its rows.

    On a ``tp`` axis wider than 1 that divides the experts (the layout of
    :func:`repro_torch.sharding.param_specs`) each rank holds ``E / tp``
    experts and their router columns. The router's logits are gathered
    over ``tp``; softmax, top-k and the capacity bookkeeping run over all
    E on every rank alike, so the dropped slots are the one-device
    layer's. The ``tp`` ranks of a data row hold the same tokens, so no
    all-to-all moves them: each rank keeps the slots of its own experts,
    runs them, weighs and scatters their outputs to the tokens in fp32,
    and the partial (B, S, D) sums over ``tp`` (``reduce_from``). That sum
    reorders the combine's fp32 additions, so the output equals the
    one-device layer's within rounding, not bit for bit. The shared expert
    is a dense MLP (its own split, :func:`repro_torch.models.layers.
    apply_mlp`). Where ``tp`` does not divide the experts the layer runs
    whole on every rank (the reference's ``_maybe`` rule). ``aux`` comes
    from the whole routing and is equal on every rank."""
    part = P.tp_of(shard)
    if part is not None and cfg.num_experts % part.tp_n:
        part = None  # experts tp does not divide: the layer stays whole
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    C = _capacity(cfg, S)
    dtype = x.dtype
    xin = x if part is None else P.copy_to(x, part.mesh, part.tp)
    shard_fn = shard or (lambda v, _name: v)

    probs, ids = route(p, cfg, xin, part)
    e_idx, c_idx, keep, onehot = _dispatch_indices(ids, E, C)
    e_loc = p["w_gate"].shape[0]
    slots = (e_idx, c_idx, keep) if part is None else \
        _local_slots(e_idx, c_idx, keep, part.tp_index * e_loc, e_loc, C)
    tok = shard_fn(_tokens(xin, K), "moe_tokens")
    buf = shard_fn(_scatter_dispatch(tok.to(dtype), slots[0], slots[1],
                                     e_loc, C), "moe_buf")
    y = shard_fn(_expert_ffn(p, buf, dtype), "moe_buf")
    del buf, tok
    w_buf = _combine_weights(probs, slots[2], slots[0], slots[1], e_loc, C)
    y_w = y.float() * w_buf[..., None]
    del y
    out = _combine_scatter(y_w, slots[0], slots[1], slots[2], S, K)
    if part is not None:
        out = P.reduce_from(out, part.mesh, part.tp)
    out = shard_fn(out, "moe_tokens").to(dtype)
    if cfg.shared_expert:
        out = out + apply_mlp(p["shared"], x, shard, d_ff=cfg.moe_d_ff)
    if aux is not None:
        aux["moe_frac_tokens"] = onehot.float().mean(dim=(0, 1))
        aux["moe_dropped"] = 1.0 - keep.float().mean()
    return out


# ---------------------------------------------------------------------------
# expert-parallel path (one process per rank of a ring axis)
# ---------------------------------------------------------------------------


def _check_divides(num_experts: int, n: int, axis: str) -> None:
    if num_experts % n:
        raise ValueError(
            f"num_experts={num_experts} must be divisible by the {axis!r} "
            f"axis size {n} for the explicit expert-parallel exchange")


def expert_shard(p: dict, mesh, axis: str = "x") -> dict:
    """This rank's part of an :func:`init_moe` tree under the explicit
    path: the contiguous block ``E / n`` experts at its index on ``axis``
    (the reference's ``P(axis)`` on the expert dim), with the router and
    the shared expert whole. ``ValueError`` when the experts do not
    divide over the axis."""
    ax = mesh.axis(axis)
    E = p["w_gate"].shape[0]
    _check_divides(E, ax.size, axis)
    e_loc = E // ax.size
    out = {k: v.narrow(0, ax.index * e_loc, e_loc)
           for k, v in p.items() if k in ("w_gate", "w_in", "w_out")}
    out["router"] = p["router"]
    if "shared" in p:
        out["shared"] = p["shared"]
    return out


def _explicit_body(p: dict, cfg: ModelConfig, x: torch.Tensor, *, axis: str,
                   engine: CollectiveEngine, schedule: Optional[str] = None,
                   nchunks=1, dispatch_callsite: str = DISPATCH_CALLSITE,
                   combine_callsite: str = COMBINE_CALLSITE) -> torch.Tensor:
    """The per-rank MoE layer. ``x`` is the local batch shard (B_loc, S, D);
    ``p`` holds the local experts (:func:`expert_shard`). Routing uses
    global expert ids, so the exchanges and the capacity bookkeeping match
    :func:`apply_moe` exactly. The two exchanges carry
    ``dispatch_callsite`` / ``combine_callsite`` (the serving decode tags
    both ``decode.moe``)."""
    E, K = cfg.num_experts, cfg.num_experts_per_tok
    B_loc, S, D = x.shape
    C = _capacity(cfg, S)
    dtype = x.dtype
    probs, ids = route(p, cfg, x)
    e_idx, c_idx, keep, _ = _dispatch_indices(ids, E, C)
    buf = _scatter_dispatch(_tokens(x, K).to(dtype), e_idx, c_idx, E, C)
    buf = exchange_dispatch(buf.contiguous(), axis, engine,
                            schedule=schedule, nchunks=nchunks,
                            callsite=dispatch_callsite)  # (B, E_loc, C, D)
    y = _expert_ffn(p, buf, dtype).contiguous()
    del buf
    w_buf = _combine_weights(probs, keep, e_idx, c_idx, E, C)

    def weigh(strip, start):
        # the per-strip combine compute on the landed capacity strip
        return strip.float() * w_buf.narrow(2, start, strip.shape[2])[..., None]

    y_w = exchange_combine(y, axis, engine, schedule=schedule,
                           nchunks=nchunks, consume=weigh,
                           callsite=combine_callsite)
    out = _combine_scatter(y_w, e_idx, c_idx, keep, S, K).to(dtype)
    if cfg.shared_expert:
        out = out + apply_mlp(p["shared"], x)
    return out


def make_apply_moe_explicit(cfg: ModelConfig, mesh, *, axis: str = "x",
                            engine: Optional[CollectiveEngine] = None,
                            schedule: Optional[str] = None, nchunks=1,
                            dispatch_callsite: str = DISPATCH_CALLSITE,
                            combine_callsite: str = COMBINE_CALLSITE):
    """``(p_local, x_local) -> (B_loc, S, D)``: the expert-parallel MoE
    layer on this rank, its exchanges through the collective engine.

    Every rank of ``axis`` holds its batch rows and ``E / n`` experts
    (``E == n`` is the one-expert-per-rank edge). Each routes and scatters
    its rows into a (B_loc, E, C, D) buffer, :func:`exchange_dispatch`
    moves every rank's tokens to their expert owners
    (``all_to_all_tiles @ moe.dispatch``), the local experts run, and
    :func:`exchange_combine` returns the outputs (``@ moe.combine``),
    weighted per landed capacity strip. Routing, drops and the combine's
    order of additions are :func:`apply_moe`'s, so each rank's rows equal
    the single-process layer's for every ``all_to_all_tiles`` schedule and
    chunk count. ``dispatch_callsite`` / ``combine_callsite`` retag the
    two exchanges (reference ``make_moe_impl``)."""
    _check_divides(cfg.num_experts, mesh.axis(axis).size, axis)
    engine = engine or CollectiveEngine.for_mesh(mesh, schedule="auto")

    def apply(p, x):
        return _explicit_body(p, cfg, x, axis=axis, engine=engine,
                              schedule=schedule, nchunks=nchunks,
                              dispatch_callsite=dispatch_callsite,
                              combine_callsite=combine_callsite)

    return apply


# the bare per-rank body, for a whole model whose expert shards ride the
# parameter tree (the whole-model explicit step, and the explicit decode
# step under decode.moe); its exchanges are differentiable, so it trains
make_moe_impl = make_apply_moe_explicit


def apply_moe_explicit(p: dict, cfg: ModelConfig, x: torch.Tensor, mesh, *,
                       axis: str = "x",
                       engine: Optional[CollectiveEngine] = None,
                       schedule: Optional[str] = None,
                       nchunks=1) -> torch.Tensor:
    """One call of the expert-parallel layer from the whole tree ``p`` and
    the whole batch ``x`` (B divisible by the axis size): this rank takes
    its experts and its rows and returns its rows of the output,
    (B / n, S, D)."""
    ax = mesh.axis(axis)
    fn = make_apply_moe_explicit(cfg, mesh, axis=axis, engine=engine,
                                 schedule=schedule, nchunks=nchunks)
    b_loc = x.shape[0] // ax.size
    return fn(expert_shard(p, mesh, axis),
              x.narrow(0, ax.index * b_loc, b_loc))


def reference_moe(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Oracle: dense loop over experts, no capacity drop. For tests with a
    capacity factor large enough that :func:`apply_moe` drops nothing."""
    B, S, D = x.shape
    probs, ids = route(p, cfg, x)
    out = torch.zeros((B, S, D), dtype=torch.float32, device=x.device)
    for e in range(cfg.num_experts):
        w_e = ((ids == e).float() * probs).sum(dim=-1)
        g = torch.matmul(x, p["w_gate"][e].to(x.dtype))
        h = torch.matmul(x, p["w_in"][e].to(x.dtype))
        y = torch.matmul(F.silu(g) * h, p["w_out"][e].to(x.dtype))
        out = out + y.float() * w_e[..., None]
    out = out.to(x.dtype)
    if cfg.shared_expert:
        out = out + apply_mlp(p["shared"], x)
    return out
