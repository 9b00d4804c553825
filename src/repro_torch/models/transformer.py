"""Decoder-only LM: the dense, MoE, SSM, hybrid and vlm families.

Port of ``repro/models/transformer.py``. The reference stacks each period
position's parameters over super-blocks and runs the layers as one
``lax.scan``; here the layers are an ``nn.ModuleList`` looped in Python,
layer ``i`` holding what the reference keeps at index ``i // period`` of
``blocks/p{i % period}`` (:func:`repro_torch.models.model.from_reference`
moves weights across). A layer is attention or SSM by
``cfg.layer_kinds()`` (jamba: one attention layer per ``attn_every``), and
its feed-forward is MoE on ``cfg.moe_layer_mask()`` (every ``moe_every``-th
layer), else the dense MLP when ``d_ff`` is set (mamba2 has none). vlm
layers on ``cfg.cross_attn_mask()`` (every ``cross_attn_every``-th) add a
gated cross-attention to the projected patch embeddings. The cache is a
list of per-layer dicts written in place (``{'k', 'v'}`` for attention,
``{'conv_x', 'conv_bc', 'state'}`` for SSM, ``{'k_pages', 'v_pages'}``
pools for paged decode); the reference donates its cache and returns the
updated one.

Encoder-decoder models are :mod:`repro_torch.models.encdec`.

On a mesh of several ranks (a ``shard`` callback from
:func:`repro_torch.sharding.make_shard_fn`) each rank runs its rows of
the batch with its part of the weights (:func:`repro_torch.sharding.
param_specs`): with a ``tp`` axis wider than 1 the embedding is split over
the vocabulary (a masked local lookup, then a ``tp`` allreduce), the
logits are computed for this rank's vocabulary and gathered over ``tp``,
and the attention and MLP blocks are Megatron's
(:mod:`repro_torch.models.layers`), the MoE layer holds ``E / tp``
experts (:func:`repro_torch.models.moe.apply_moe`), the SSM layer ``H /
tp`` heads (:func:`repro_torch.models.ssm.apply_ssm`) and the vlm's
cross-attention splits its heads as self-attention does, from the whole
patch stream. A block whose heads, experts or hidden width ``tp`` does not
divide keeps its weights whole and runs whole on every rank. The dense
cache holds this rank's rows, KV heads and SSM heads; on a mesh whose
``tp`` axis has size 1 every family runs with whole weights on its rows.
With FSDP (``shard.gather``) each layer's dp-split weights are gathered
before its forward, and again in remat's recompute.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch import partition as P
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.kvcache import (PagedCacheConfig, attn_cache_spec,
                                        local_cache_dims,
                                        paged_attn_cache_spec, pool_heads,
                                        scatter_token, ssm_cache_spec,
                                        token_slots)

Shard = Callable[[torch.Tensor, str], torch.Tensor]


def _noshard(x, name):
    return x


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration this decoder-only module does not run."""
    if cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name}: an encoder-decoder model runs in "
                         "repro_torch.models.encdec")


def period_of(cfg: ModelConfig) -> int:
    p = 1
    if cfg.family == "hybrid":
        p = math.lcm(p, cfg.attn_every)
    if cfg.has_moe:
        p = math.lcm(p, cfg.moe_every)
    if cfg.cross_attn_every:
        p = math.lcm(p, cfg.cross_attn_every)
    if cfg.num_layers % p:
        raise ValueError(f"num_layers={cfg.num_layers} not divisible by "
                         f"period={p}")
    return p


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _param(t: torch.Tensor) -> nn.Parameter:
    # frozen, so that serving builds no autograd graph; training turns
    # gradients on for its own copy (repro_torch.train.step.init_train_state)
    return nn.Parameter(t, requires_grad=False)


class ParamTree(nn.Module):
    """A nested dict of weights as a module: a tensor leaf is a parameter,
    a dict a child :class:`ParamTree`. Reads like the dict it was built
    from (``p["wq"]``, ``"shared" in p``, ``p.items()``), so the layer
    functions take it or a plain dict alike."""

    def __init__(self, tree: Dict):
        super().__init__()
        self._names = tuple(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, _param(v))

    def __getitem__(self, key: str):
        if key not in self._names:
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._names

    def items(self):
        return [(k, self[k]) for k in self._names]

    def tree(self, data: bool = True) -> Dict:
        """The nested dict of weights; ``data=False`` gives the parameters
        themselves (with their ``.grad``) instead of their data."""
        return {k: v.tree(data) if isinstance(v, ParamTree)
                else (v.data if data else v) for k, v in self.items()}


class LayerParams(ParamTree):
    """One decoder layer, in the reference's shapes: ``ln1``; ``attn``
    (wq, wk, wv, wo [+ biases] [+ q_norm, k_norm]) or ``ssm``; on a cross
    layer ``cross_ln``, ``cross_attn`` and the scalar ``cross_gate``; then
    ``ln2`` with ``moe`` (router, w_gate, w_in, w_out [+ ``shared``]) or
    ``mlp`` (w_gate, w_in, w_out), or neither (mamba2)."""


class Params(nn.Module):
    """The model's weights: ``embed`` (padded vocab, d_model; also the tied
    LM head), ``final_norm``, ``blocks``, one :class:`LayerParams` per
    layer, and for vlm ``vlm`` (``patch_proj``, ``patch_norm``)."""

    def __init__(self, cfg: ModelConfig, tree: Dict):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(tree["embed"])
        self.final_norm = _param(tree["final_norm"])
        self.blocks = nn.ModuleList(LayerParams(t) for t in tree["blocks"])
        self.vlm = ParamTree(tree["vlm"]) if "vlm" in tree else None

    def tree(self, data: bool = True) -> Dict:
        """``{'embed', 'final_norm', 'blocks': [per-layer dicts]}`` and
        ``'vlm'`` where the model has one; ``data=False`` gives the
        parameters themselves."""
        leaf = (lambda p: p.data) if data else (lambda p: p)
        out = {"embed": leaf(self.embed), "final_norm": leaf(self.final_norm),
               "blocks": [b.tree(data) for b in self.blocks]}
        if self.vlm is not None:
            out["vlm"] = self.vlm.tree(data)
        return out


def tree_map(tree, fn):
    """``fn`` over every tensor of a nested dict / list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(v, fn) for v in tree]
    return fn(tree)


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """A copy of every weight in ``dtype`` (``params`` itself when they all
    have it already). The reference casts each fp32 weight to the compute
    dtype inside every call; one serving copy gives the same bits without
    re-reading the fp32 weights at every decode step."""
    if all(t.dtype == dtype for t in params.parameters()):
        return params
    return type(params)(params.cfg,
                        tree_map(params.tree(), lambda t: t.to(dtype)))


def _init_layer(gen, cfg: ModelConfig, device, kind: str = "attn",
                has_moe: bool = False, has_cross: bool = False) -> Dict:
    p: Dict = {"ln1": L.init_rmsnorm(cfg.d_model, device)}
    if kind == "attn":
        p["attn"] = L.init_attention(gen, cfg, device=device)
    else:
        p["ssm"] = SSM.init_ssm(gen, cfg, device)
    if has_cross:
        p["cross_ln"] = L.init_rmsnorm(cfg.d_model, device)
        p["cross_attn"] = L.init_attention(gen, cfg, kv_in_dim=cfg.d_model,
                                           device=device)
        # llama-vision's gated cross-attention starts closed, as in the
        # reference: tanh(0) hides the whole cross branch
        p["cross_gate"] = torch.zeros((), device=device)
    if has_moe:
        p["ln2"] = L.init_rmsnorm(cfg.d_model, device)
        p["moe"] = MOE.init_moe(gen, cfg, device)
    elif cfg.d_ff:
        p["ln2"] = L.init_rmsnorm(cfg.d_model, device)
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.num_layers,
                              device)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device=None) -> Params:
    """Random weights with the reference's shapes and scales (normal, std
    0.02; output projections 0.02 / sqrt(2 * layers); norms 1; cross gates
    0), drawn in fp32 from ``gen`` on its device (or on ``device``:
    ``"meta"`` gives the shapes without storage). The reference's
    ``jax.random`` draws other numbers: move its weights with
    ``from_reference`` to compare."""
    check_supported(cfg)
    period_of(cfg)
    device = gen.device if device is None else device
    V = cfg.padded_vocab()
    kinds, moe_mask = cfg.layer_kinds(), cfg.moe_layer_mask()
    cross_mask = cfg.cross_attn_mask()
    tree = {"embed": torch.randn((V, cfg.d_model), generator=gen,
                                 device=device) * 0.02,
            "final_norm": L.init_rmsnorm(cfg.d_model, device),
            "blocks": [_init_layer(gen, cfg, device, kinds[i], moe_mask[i],
                                   cross_mask[i])
                       for i in range(cfg.num_layers)]}
    if cfg.family == "vlm":
        tree["vlm"] = {
            "patch_proj": torch.randn((cfg.vision_dim, cfg.d_model),
                                      generator=gen, device=device) * 0.02,
            "patch_norm": L.init_rmsnorm(cfg.d_model, device)}
    return Params(cfg, tree)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None, mesh=None) -> Dict:
    """``{'pos': 0, 'layers': [per layer: {'k', 'v'} (attention) or
    {'conv_x', 'conv_bc', 'state'} (SSM, the state in fp32)]}``. With a
    ``mesh`` (``batch`` the global batch) this rank's part of it
    (:func:`repro_torch.models.kvcache.local_cache_dims`): its rows, its
    KV heads, and its SSM heads in ``conv_x`` and ``state`` (``conv_bc``
    whole)."""
    check_supported(cfg)
    kv = heads = None
    if mesh is not None:
        batch, kv, heads = local_cache_dims(cfg, batch, mesh)
    return {"pos": 0,
            "layers": [attn_cache_spec(cfg, batch, max_seq, dtype, device,
                                       kv_heads=kv)
                       if kind == "attn" else
                       ssm_cache_spec(cfg, batch, dtype, device,
                                      heads=heads)
                       for kind in cfg.layer_kinds()]}


def init_paged_cache(cfg: ModelConfig, pcfg: PagedCacheConfig,
                     dtype=torch.bfloat16, device=None, mesh=None,
                     axis=None) -> Dict:
    """Page pools for every layer: ``{'layers': [{'k_pages', 'v_pages'}]}``
    and no ``'pos'``: the paged decode step supplies each slot's length as
    its position. Attention-only architectures (an SSM state is per slot
    and recurrent, not paged), as in the reference.

    With a ``mesh`` this rank's pool: every page, with the KV heads of
    :func:`repro_torch.models.kvcache.pool_heads` (split over ``axis`` for
    the explicit decode, the GSPMD placement's otherwise)."""
    check_supported(cfg)
    period_of(cfg)
    kinds = cfg.layer_kinds()
    if any(k != "attn" for k in kinds):
        raise ValueError(
            f"paged cache supports attention-only models; {cfg.name} has "
            f"layer kinds {sorted(set(kinds))}")
    kv = pool_heads(cfg, mesh, axis)[1] if mesh is not None else None
    return {"layers": [paged_attn_cache_spec(cfg, pcfg, dtype, device, kv)
                       for _ in kinds]}


# ---------------------------------------------------------------------------
# activation checkpointing (train mode)
# ---------------------------------------------------------------------------

REMAT_POLICIES = ("none", "full", "dots")


def _save_dots(ctx, op, *args, **kwargs):
    # the counterpart of jax's dots_with_no_batch_dims_saveable: the
    # products without batch dimensions (the projections and the MLP, each
    # one ``mm``) are saved; everything else, the attention's batched
    # products (``bmm``) too, is recomputed in the backward pass
    from torch.utils.checkpoint import CheckpointPolicy
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def rematerialize(fn: Callable, remat: str) -> Callable:
    """``fn`` under the activation-checkpoint policy ``remat``: ``"none"``
    keeps every activation, ``"full"`` keeps only ``fn``'s inputs and
    recomputes the rest in the backward pass, ``"dots"`` also keeps the
    products without batch dimensions (the reference's
    ``jax.checkpoint`` policies, ``transformer.py:257-262``)."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}; policies are "
                         f"{REMAT_POLICIES}")
    if remat == "none":
        return fn
    from torch.utils import checkpoint as ckpt
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)

    def run(*args):
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def _vocab_split(cfg: ModelConfig, part) -> bool:
    # param_specs splits the vocabulary over tp where tp divides it
    return part is not None and cfg.padded_vocab() % part.tp_n == 0


def embed_tokens(cfg: ModelConfig, embed: torch.Tensor,
                 tokens: torch.Tensor, part) -> torch.Tensor:
    """Rows ``tokens`` of the (compute-dtype) embedding, split over the
    vocabulary on placement ``part`` where its ``tp`` axis divides it."""
    if _vocab_split(cfg, part):
        return P.embed_lookup(embed, tokens, part)
    return embed[tokens]


def lm_logits(cfg: ModelConfig, embed: torch.Tensor, x: torch.Tensor,
              part, shard: Shard) -> torch.Tensor:
    """The tied LM head: with a vocabulary split over ``tp``, this rank's
    vocabulary's logits gathered over ``tp`` for the loss and sampling."""
    if not _vocab_split(cfg, part):
        return shard(torch.matmul(x, embed.T), "logits")
    x = P.copy_to(x, part.mesh, part.tp)
    return P.gather(shard(torch.matmul(x, embed.T), "logits"),
                    part.mesh, part.tp, dim=-1)


def _apply_layer(lp: LayerParams, cfg: ModelConfig, x, *, kind: str,
                 has_moe: bool, has_cross: bool, cache, pos, cross_kv,
                 shard: Shard, attn_impl=None, moe_impl=None,
                 page_table=None):
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    if kind == "attn":
        a, new_cache = L.apply_attention(lp["attn"], cfg, h, cache=cache,
                                         pos=pos, shard=shard,
                                         attn_impl=attn_impl,
                                         page_table=page_table)
    else:
        a, new_cache = SSM.apply_ssm(lp["ssm"], cfg, h, cache=cache, pos=pos,
                                     shard=shard)
    x = shard(x + a, "residual")
    if has_cross and cross_kv is not None:
        h = L.rmsnorm(x, lp["cross_ln"], cfg.norm_eps)
        c, _ = L.apply_attention(lp["cross_attn"], cfg, h, kv_x=cross_kv,
                                 causal=False, use_rope=False, shard=shard)
        x = shard(x + torch.tanh(lp["cross_gate"]).to(x.dtype) * c,
                  "residual")
    if has_moe:
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        m = (moe_impl(lp["moe"], h) if moe_impl is not None
             else MOE.apply_moe(lp["moe"], cfg, h, shard=shard))
        x = shard(x + m, "residual")
    elif cfg.d_ff:
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = shard(x + L.apply_mlp(lp["mlp"], h, shard=shard, d_ff=cfg.d_ff),
                  "residual")
    return x, new_cache


def apply(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
          cache: Optional[Dict] = None,
          patch_embeds: Optional[torch.Tensor] = None,
          shard: Shard = _noshard, remat: str = "none",
          collect_aux: bool = False, attn_impl=None, moe_impl=None,
          page_table: Optional[Dict] = None
          ) -> Tuple[torch.Tensor, Optional[Dict], Optional[Dict]]:
    """Returns (logits, cache, aux).

    train:   cache=None                  -> logits (B, S, V)
    prefill: cache at pos 0              -> logits (B, S, V), cache filled
    decode:  cache with pos > 0, S == 1  -> logits (B, 1, V), cache advanced
    paged:   cache from ``init_paged_cache`` with ``pos`` the (B,) lengths
             and ``page_table``, S == 1 only: each layer's token is
             written into its slot's current page

    vlm: ``patch_embeds`` (B, P, vision_dim) become the cross layers'
    source, ``rmsnorm(patch_embeds @ patch_proj)``; without them the cross
    layers are skipped, as in the reference. The cache's tensors are
    written in place; the returned dict shares them and carries ``pos +
    S``. ``aux`` is ``{}`` with ``collect_aux`` and None otherwise, as the
    reference returns it (its layers collect no MoE metrics).

    ``remat`` (:data:`REMAT_POLICIES`) checkpoints each period of layers,
    the reference's super-block, in train mode (no cache); serving runs
    without autograd and ignores it.

    ``attn_impl`` and ``moe_impl`` are the explicit whole-model path's
    hooks (:mod:`repro_torch.models.parallel`,
    :func:`repro_torch.models.moe.make_moe_impl`): the first replaces every
    self-attention layer's core attention call, the second every MoE layer,
    called as ``moe_impl(layer_params["moe"], h)``."""
    check_supported(cfg)
    part = P.tp_of(shard)
    gather = getattr(shard, "gather", None)
    dtype = dtype_of(cfg.dtype)
    kinds, moe_mask = cfg.layer_kinds(), cfg.moe_layer_mask()
    cross_mask = cfg.cross_attn_mask()
    embed = params.embed if gather is None else gather("embed", params.embed)
    embed = embed.to(dtype)
    x = shard(embed_tokens(cfg, embed, tokens, part), "residual")

    cross_kv = None
    if cfg.family == "vlm" and patch_embeds is not None:
        vlm = params.vlm if gather is None else gather("vlm", params.vlm)
        pe = torch.matmul(patch_embeds.to(dtype), vlm["patch_proj"].to(dtype))
        cross_kv = L.rmsnorm(pe, vlm["patch_norm"], cfg.norm_eps)

    pos, slots = None, None
    layer_caches = [None] * cfg.num_layers
    if cache is not None:
        layer_caches = cache["layers"]
        is_decode = tokens.shape[1] == 1
        if "k_pages" in layer_caches[0]:
            if not is_decode:
                raise ValueError(
                    "paged cache is decode-only (S == 1); prefill runs "
                    "against a dense cache and is committed into pages via "
                    "repro_torch.models.kvcache.commit_prefill")
            pool = layer_caches[0]["k_pages"]
            slots = token_slots(page_table["block_table"],
                                page_table["lengths"], pool.shape[1],
                                pool.shape[0])
        if is_decode:
            pos = cache["pos"]

    def layer(i, x):
        blk = params.blocks[i]
        if gather is not None:  # inside remat: gathered again in recompute
            blk = gather(("blocks", i), blk)
        return _apply_layer(blk, cfg, x, kind=kinds[i],
                            has_moe=moe_mask[i], has_cross=cross_mask[i],
                            cache=layer_caches[i], pos=pos,
                            cross_kv=cross_kv, shard=shard,
                            attn_impl=attn_impl, moe_impl=moe_impl,
                            page_table=page_table)

    if cache is None:
        period = period_of(cfg)

        def superblock(x, start):
            for i in range(start, start + period):
                x = layer(i, x)[0]
            return x

        body = rematerialize(superblock, remat)
        for start in range(0, cfg.num_layers, period):
            x = body(x, start)
    else:
        for i in range(cfg.num_layers):
            x, upd = layer(i, x)
            if slots is not None:
                # the reference scatters every layer's update after its
                # scan; each layer's pool is its own, so writing it now is
                # the same
                scatter_token(layer_caches[i], upd, slots)

    final_norm = params.final_norm if gather is None \
        else gather("final_norm", params.final_norm)
    x = shard(L.rmsnorm(x, final_norm, cfg.norm_eps), "residual")
    logits = lm_logits(cfg, embed, x, part, shard)

    new_cache = None
    if cache is not None:
        new_cache = {"pos": cache["pos"] + tokens.shape[1],
                     "layers": layer_caches}
    return logits, new_cache, ({} if collect_aux else None)
