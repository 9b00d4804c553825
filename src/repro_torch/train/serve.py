"""Serving steps: prefill + decode against a dense KV cache (and the SSM
layers' conv and state cache), the paged decode step, and batched
generation.

Port of ``repro/train/serve.py`` (``make_prefill_step`` :33,
``make_decode_step`` :46, ``make_paged_decode_step`` :63-87,
``make_decode_step_explicit`` :90-146, ``generate`` :149-198): the
reference's "batched requests" server, and the decode steps of the
continuous-batching engine (:mod:`repro_torch.serve`). With a
one-rank mesh (``launch/mesh.py::single_rank_mesh(("x",))``) the prefill
takes the hand-written flash kernel (``ops.flash_attention``, one launch
per self-attention layer of the decoder) for prompts of 128 tokens or
more, as the reference's ``make_prefill_step(model, mesh)`` takes its
Pallas kernel; with ``mesh=None`` it takes the plain ``attention``. Decode
never takes the flash kernel, nor does the encoder-decoder.

The steps run under ``torch.no_grad`` and write the cache in place (the
reference donates it). ``generate`` casts the weights once into a serving
copy in the compute dtype (the reference casts them inside every call; the
bits are the same), runs on the weights' device, and keeps the reference's
EOS rule: rows that hit ``eos_id`` are held at EOS, decoding stops when
every row has, and the output is padded with EOS to (B, S0 + new). Its
``extras`` (``patch_embeds``, ``frames``) go to the prefill; decode gets
them without ``frames``, as in the reference, so each vlm decode step
recomputes its cross K/V from the patches. Greedy decoding
(``temperature == 0``) is the reference's argmax; sampling draws from
``torch.multinomial`` with the caller's ``generator`` and cannot match
``jax.random.categorical``'s numbers.

On a mesh of several ranks (``launch/mesh.py::make_mesh``) every rank
calls the steps and ``generate``: each holds its ``batch_specs`` rows, its
part of the weights (:func:`repro_torch.sharding.param_specs`; ``generate``
takes the whole weights and cuts them itself) and of the dense cache
(``init_cache(..., mesh=)``), and gets whole logits and tokens for its
rows: the vocab-split logits are gathered over ``tp`` before sampling,
and prefill runs the flash kernel on this rank's heads. ``generate``
also runs a batch that the dp axes do not divide, whole on every rank,
with the plain attention in prefill, as the reference does.

The paged decode steps back the continuous-batching engine (reference
``:63-146``): :func:`make_paged_decode_step` is the GSPMD program, on one
rank or on such a mesh (each rank its :func:`decode_rows` of the slot
batch, its weights (:func:`local_params`) and its pool's KV heads), and
:func:`make_decode_step_explicit` runs the same token forward with every
wire hop an engine call: head-parallel attention under ``decode.qkv`` /
``decode.out`` and the MoE dispatch and combine under ``decode.moe``
(:mod:`repro_torch.comm.callsites`). Per-token payloads are tiny, so these
callsites resolve in the latency band of the cost model, apart from the
training-sized ``tp.*`` / ``moe.*`` entries. Neither takes the flash
kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch import partition as P
from repro_torch import sharding as sh
from repro_torch.models import transformer
from repro_torch.models.model import Model


def _shard_fn(mesh):
    if mesh is None:
        return transformer._noshard
    return sh.make_shard_fn(mesh, sh.rules_for(mesh))


def make_prefill_step(model: Model, mesh=None) -> Callable:
    """(params, batch, cache) -> (logits, cache). Writes positions
    [0, S). On a mesh of several ranks ``batch``, ``params`` and ``cache``
    are this rank's."""
    return _prefill_step(model, _shard_fn(mesh))


def _prefill_step(model: Model, shard) -> Callable:
    @torch.no_grad()
    def prefill(params, batch, cache):
        logits, cache, _ = model.apply(params, batch, cache=cache,
                                       shard=shard)
        return logits, cache

    return prefill


def make_decode_step(model: Model, mesh=None) -> Callable:
    """(params, tokens (B, 1), cache, extras) -> (logits (B, 1, V),
    cache); on a mesh of several ranks as :func:`make_prefill_step`."""
    shard = _shard_fn(mesh)

    @torch.no_grad()
    def decode(params, tokens, cache, extras):
        batch = {"tokens": tokens, **extras}
        logits, cache, _ = model.apply(params, batch, cache=cache,
                                       shard=shard)
        return logits, cache

    return decode


def decode_rows(mesh, batch: int, axis=None) -> slice:
    """This rank's rows of a decode batch of ``batch`` slots: its block
    of ``axis`` for the explicit decode (which needs ``axis`` to divide
    ``batch``); for the GSPMD decode its ``batch_specs`` block over the dp
    axes, or every row where they do not divide ``batch`` (the whole batch
    on every rank, as ``generate`` runs it). All rows without a mesh."""
    if mesh is None:
        return slice(0, batch)
    if axis is not None:
        ax = mesh.axis(axis)
        if batch % ax.size:
            raise ValueError(
                f"a decode batch of {batch} slots does not split over the "
                f"{axis!r} axis of {ax.size} ranks")
        b = batch // ax.size
        return slice(ax.index * b, (ax.index + 1) * b)
    rules = sh.rules_for(mesh)
    if sh._maybe(batch, rules.dp_spec, mesh) is None:
        return slice(0, batch)
    idx, n = sh.block_of(mesh, rules.dp_spec)
    b = batch // n
    return slice(idx * b, (idx + 1) * b)


def local_params(params, mesh, axis=None):
    """Views of this rank's part of the whole weights ``params``, no
    copy: :func:`repro_torch.train.step.whole_model_param_specs` over
    ``axis`` (the explicit decode: the experts split, the rest whole) or
    :func:`repro_torch.sharding.param_specs` (the GSPMD placement).
    ``params`` itself on a one-rank mesh."""
    if axis is not None:
        from repro_torch.train.step import whole_model_param_specs
        specs = whole_model_param_specs(params, axis)
    else:
        if P.placement(_shard_fn(mesh)) is None:
            return params
        specs = sh.param_specs(params, sh.rules_for(mesh), mesh)
    return type(params)(params.cfg, sh.cut(params.tree(), specs, mesh,
                                           copy=False))


def make_paged_decode_step(model: Model, mesh=None) -> Callable:
    """``(params, tokens (B, 1), pages, block_table, lengths) -> (logits
    (B, 1, V), pages)``.

    ``pages`` is :func:`repro_torch.models.transformer.init_paged_cache`'s
    output, written in place; ``block_table`` (B, pmax) and ``lengths``
    (B,) come from the host
    :class:`~repro_torch.models.kvcache.PageAllocator`. Row b attends to
    its pages' positions ``<= lengths[b]`` (the new token is written at
    ``lengths[b]``); rows with a sentinel block-table row are inactive:
    their logits are garbage and their cache writes drop.

    On a mesh of several ranks every rank calls it with its part:
    ``params`` from :func:`local_params`, the rows :func:`decode_rows`
    names of ``tokens``, ``block_table`` and ``lengths``, and its pool
    (``init_paged_cache(..., mesh=mesh)``), which only those rows write
    and read. With a ``tp`` axis wider than 1 the heads split as in
    prefill, a MoE layer holds its share of the experts
    (:func:`repro_torch.models.moe.apply_moe`), and the pool holds this
    rank's KV heads; the logits come back whole for the rank's rows,
    gathered over ``tp``."""
    shard = _shard_fn(mesh)

    @torch.no_grad()
    def decode(params, tokens, pages, block_table, lengths):
        cache = {"pos": lengths, "layers": pages["layers"]}
        page_table = {"block_table": block_table, "lengths": lengths}
        logits, new_cache, _ = model.apply(
            params, {"tokens": tokens}, cache=cache, shard=shard,
            page_table=page_table)
        return logits, {"layers": new_cache["layers"]}

    return decode


def make_decode_step_explicit(model: Model, mesh, *, axis: str = "x",
                              engine=None, schedule: Optional[str] = None,
                              nchunks=1) -> Callable:
    """Engine-routed paged decode (reference ``:90-146``), run by every
    rank of ``mesh``'s ``axis``: ``(params, tokens (B/n, 1), pages,
    block_table (B, pmax), lengths (B,)) -> (logits (B/n, 1, V), pages)``.

    ``params`` are this rank's part of the weights, as the GSPMD step
    takes them: ``local_params(params, mesh, axis)`` (views of the whole
    weights, no copy; each MoE layer's experts over ``axis``, the rest
    whole) or the same cut made by the caller (a rank that cannot hold
    every expert draws only its shard). ``tokens`` are this rank's rows
    (:func:`decode_rows`), ``block_table`` and ``lengths`` the whole
    batch's, and ``pages`` this rank's pool (``init_paged_cache(...,
    mesh=mesh, axis=axis)``: every page, its share of the KV heads),
    written in place. The residual
    stream stays batch-split; per layer the hook of
    :func:`~repro_torch.models.parallel.make_paged_decode_attention`
    exchanges q and the token's k/v head-parallel (``decode.qkv``), runs
    the plain decode attention against the local pool and restores the
    layout (``decode.out``); MoE layers dispatch and combine under
    ``decode.moe``. Requires the slot count, the heads, the KV heads and
    the experts, where present, divisible by the axis size (the hooks
    raise ``ValueError`` when built). Matches
    :func:`make_paged_decode_step`'s logits and pages for every
    registered ``all_to_all_tiles`` schedule."""
    from repro_torch.comm.callsites import DECODE_MOE
    from repro_torch.comm.engine import CollectiveEngine
    from repro_torch.models import moe as MOE
    from repro_torch.models.parallel import make_paged_decode_attention

    cfg = model.cfg
    engine = engine or CollectiveEngine.for_mesh(mesh, schedule="auto")
    attn_impl = make_paged_decode_attention(cfg, mesh, axis=axis,
                                            engine=engine, schedule=schedule)
    moe_impl = None
    if cfg.has_moe:
        moe_impl = MOE.make_moe_impl(cfg, mesh, axis=axis, engine=engine,
                                     schedule=schedule, nchunks=nchunks,
                                     dispatch_callsite=DECODE_MOE,
                                     combine_callsite=DECODE_MOE)

    @torch.no_grad()
    def decode(params, tokens, pages, block_table, lengths):
        rows = decode_rows(mesh, block_table.shape[0], axis)
        if tokens.shape[0] != rows.stop - rows.start:
            raise ValueError(
                f"tokens hold {tokens.shape[0]} rows; this rank decodes "
                f"rows {rows.start}:{rows.stop} of {block_table.shape[0]}")
        cache = {"pos": lengths[rows], "layers": pages["layers"]}
        page_table = {"block_table": block_table, "lengths": lengths}
        logits, new_cache, _ = model.apply(
            params, {"tokens": tokens}, cache=cache, page_table=page_table,
            attn_impl=attn_impl, moe_impl=moe_impl)
        return logits, {"layers": new_cache["layers"]}

    decode.engine = engine
    return decode


@torch.no_grad()
def generate(model: Model, params, prompts, *, max_new_tokens: int = 32,
             max_seq: Optional[int] = None, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None, mesh=None,
             extras: Optional[Dict] = None,
             eos_id: Optional[int] = None) -> torch.Tensor:
    """Batched generation. prompts: (B, S0) integers -> (B, S0 + new) in
    the prompts' dtype, on the weights' device. ``extras`` are the model's
    other inputs (``patch_embeds`` for vlm, ``frames`` for whisper), moved
    to that device.

    On a mesh of several ranks every rank calls it with the same global
    ``prompts``, ``extras`` and whole weights, which it cuts to its part
    (:func:`repro_torch.sharding.param_specs`), and gets the tokens of its
    ``batch_specs`` rows (all rows where the dp axes do not divide them).
    Greedy tokens equal the one-rank ``generate``'s rows."""
    device = params.embed.device
    prompts = torch.as_tensor(prompts).to(device)
    extras = {k: torch.as_tensor(v).to(device)
              for k, v in (extras or {}).items()}
    B_glob = prompts.shape[0]
    shard = _shard_fn(mesh)
    part = P.placement(shard)
    if part is not None:
        rules = shard.rules
        split = sh._maybe(B_glob, rules.dp_spec, mesh) is not None
        if split:
            idx, n = sh.block_of(mesh, rules.dp_spec)
            b = B_glob // n
            prompts = prompts[idx * b:(idx + 1) * b]
            extras = {k: v[idx * b:(idx + 1) * b] for k, v in extras.items()}
        # the whole batch on every rank takes no flash in prefill (B %
        # dp_n); decode takes none
        shard = dataclasses.replace(shard, rows_split=split)
        params = type(params)(params.cfg, sh.cut(
            params.tree(), sh.param_specs(params, rules, mesh), mesh))
    B, S0 = prompts.shape
    max_seq = max_seq or (S0 + max_new_tokens)
    dtype = transformer.dtype_of(model.cfg.dtype)
    params = transformer.cast_params(params, dtype)
    cache = model.init_cache(B_glob, max_seq, dtype, device=device,
                             mesh=mesh if part is not None else None)

    prefill = _prefill_step(model, shard)
    decode = make_decode_step(model, mesh)

    logits, cache = prefill(params, {"tokens": prompts, **extras}, cache)
    last = logits[:, -1]
    decode_extras = {k: v for k, v in extras.items() if k != "frames"}

    def sample(logits_1):
        if temperature <= 0.0:
            return torch.argmax(logits_1, dim=-1).to(prompts.dtype)
        probs = torch.softmax(logits_1.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            prompts.dtype)

    out = [prompts]
    tok = sample(last)[:, None]
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    for i in range(max_new_tokens):
        out.append(tok)
        if eos_id is not None:
            done = done | (tok[:, 0] == eos_id)
            if bool(done.all()):
                break  # every request hit EOS: stop decoding early
        if i == max_new_tokens - 1:
            break
        logits, cache = decode(params, tok, cache, decode_extras)
        tok = sample(logits[:, -1])[:, None]
        if eos_id is not None:
            # finished rows are held at EOS: their continuations never leak
            tok = torch.where(done[:, None], eos_id, tok)
    res = torch.cat(out, dim=1)
    full = S0 + max_new_tokens
    if res.shape[1] < full:  # early EOS stop: pad to the fixed output shape
        pad = torch.full((B, full - res.shape[1]), eos_id, dtype=res.dtype,
                         device=device)
        res = torch.cat([res, pad], dim=1)
    return res

