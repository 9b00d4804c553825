"""Decoder-only LM: the dense, MoE, SSM and hybrid families.

Port of ``repro/models/transformer.py``. The reference stacks each period
position's parameters over super-blocks and runs the layers as one
``lax.scan``; here the layers are an ``nn.ModuleList`` looped in Python,
layer ``i`` holding what the reference keeps at index ``i // period`` of
``blocks/p{i % period}`` (:func:`repro_torch.models.model.from_reference`
moves weights across). A layer is attention or SSM by
``cfg.layer_kinds()`` (jamba: one attention layer per ``attn_every``), and
its feed-forward is MoE on ``cfg.moe_layer_mask()`` (every ``moe_every``-th
layer), else the dense MLP when ``d_ff`` is set (mamba2 has none). The
cache is a list of per-layer dicts written in place (``{'k', 'v'}`` for
attention, ``{'conv_x', 'conv_bc', 'state'}`` for SSM); the reference
donates its cache and returns the updated one.

Cross-attention (vlm) and encoder-decoder models raise
``NotImplementedError`` naming ROADMAP A11; the paged cache raises naming
A13.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.kvcache import attn_cache_spec, ssm_cache_spec

Shard = Callable[[torch.Tensor, str], torch.Tensor]


def _noshard(x, name):
    return x


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration outside the ported families."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are "
                                  "not ported yet (ROADMAP A11)")
    if cfg.cross_attn_every:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family's cross-attention layers "
            "are not ported yet (ROADMAP A11)")


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
    # serving builds no autograd graph; training comes with ROADMAP A12
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

    def tree(self) -> Dict:
        return {k: v.tree() if isinstance(v, ParamTree) else v.data
                for k, v in self.items()}


class LayerParams(ParamTree):
    """One decoder layer, in the reference's shapes: ``ln1``; ``attn``
    (wq, wk, wv, wo [+ biases] [+ q_norm, k_norm]) or ``ssm``; then ``ln2``
    with ``moe`` (router, w_gate, w_in, w_out [+ ``shared``]) or ``mlp``
    (w_gate, w_in, w_out), or neither (mamba2)."""


class Params(nn.Module):
    """The model's weights: ``embed`` (padded vocab, d_model; also the tied
    LM head), ``final_norm`` and ``blocks``, one :class:`LayerParams` per
    layer."""

    def __init__(self, cfg: ModelConfig, tree: Dict):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(tree["embed"])
        self.final_norm = _param(tree["final_norm"])
        self.blocks = nn.ModuleList(LayerParams(t) for t in tree["blocks"])

    def tree(self) -> Dict:
        """``{'embed', 'final_norm', 'blocks': [per-layer dicts]}``."""
        return {"embed": self.embed.data, "final_norm": self.final_norm.data,
                "blocks": [b.tree() for b in self.blocks]}


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
    return Params(params.cfg, tree_map(params.tree(), lambda t: t.to(dtype)))


def _init_layer(gen, cfg: ModelConfig, device, kind: str = "attn",
                has_moe: bool = False) -> Dict:
    p: Dict = {"ln1": L.init_rmsnorm(cfg.d_model, device)}
    if kind == "attn":
        p["attn"] = L.init_attention(gen, cfg, device=device)
    else:
        p["ssm"] = SSM.init_ssm(gen, cfg, device)
    if has_moe:
        p["ln2"] = L.init_rmsnorm(cfg.d_model, device)
        p["moe"] = MOE.init_moe(gen, cfg, device)
    elif cfg.d_ff:
        p["ln2"] = L.init_rmsnorm(cfg.d_model, device)
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.num_layers,
                              device)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random weights with the reference's shapes and scales (normal, std
    0.02; output projections 0.02 / sqrt(2 * layers); norms 1), drawn in
    fp32 from ``gen`` on its device. The reference's ``jax.random`` draws
    other numbers: move its weights with ``from_reference`` to compare."""
    check_supported(cfg)
    period_of(cfg)
    device = gen.device
    V = cfg.padded_vocab()
    kinds, moe_mask = cfg.layer_kinds(), cfg.moe_layer_mask()
    tree = {"embed": torch.randn((V, cfg.d_model), generator=gen,
                                 device=device) * 0.02,
            "final_norm": L.init_rmsnorm(cfg.d_model, device),
            "blocks": [_init_layer(gen, cfg, device, kinds[i], moe_mask[i])
                       for i in range(cfg.num_layers)]}
    return Params(cfg, tree)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Dict:
    """``{'pos': 0, 'layers': [per layer: {'k', 'v'} (attention) or
    {'conv_x', 'conv_bc', 'state'} (SSM, the state in fp32)]}``."""
    check_supported(cfg)
    return {"pos": 0,
            "layers": [attn_cache_spec(cfg, batch, max_seq, dtype, device)
                       if kind == "attn" else
                       ssm_cache_spec(cfg, batch, dtype, device)
                       for kind in cfg.layer_kinds()]}


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def _apply_layer(lp: LayerParams, cfg: ModelConfig, x, *, kind: str,
                 has_moe: bool, cache, pos, shard: Shard):
    h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
    if kind == "attn":
        a, _ = L.apply_attention(lp["attn"], cfg, h, cache=cache, pos=pos,
                                 shard=shard)
    else:
        a, _ = SSM.apply_ssm(lp["ssm"], cfg, h, cache=cache, pos=pos)
    x = shard(x + a, "residual")
    if has_moe:
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = shard(x + MOE.apply_moe(lp["moe"], cfg, h, shard=shard),
                  "residual")
    elif cfg.d_ff:
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = shard(x + L.apply_mlp(lp["mlp"], h), "residual")
    return x


def apply(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
          cache: Optional[Dict] = None, shard: Shard = _noshard,
          collect_aux: bool = False
          ) -> Tuple[torch.Tensor, Optional[Dict], Optional[Dict]]:
    """Returns (logits, cache, aux).

    train:   cache=None                  -> logits (B, S, V)
    prefill: cache at pos 0              -> logits (B, S, V), cache filled
    decode:  cache with pos > 0, S == 1  -> logits (B, 1, V), cache advanced

    The cache's tensors are written in place; the returned dict shares them
    and carries ``pos + S``. ``aux`` is ``{}`` with ``collect_aux`` and None
    otherwise, as the reference returns it (its layers collect no MoE
    metrics)."""
    check_supported(cfg)
    dtype = dtype_of(cfg.dtype)
    kinds, moe_mask = cfg.layer_kinds(), cfg.moe_layer_mask()
    embed = params.embed.to(dtype)
    x = shard(embed[tokens], "residual")

    pos = None
    layer_caches = [None] * cfg.num_layers
    if cache is not None:
        layer_caches = cache["layers"]
        if any("k_pages" in c for c in layer_caches):
            raise NotImplementedError("the paged KV cache is not ported yet "
                                      "(ROADMAP A13)")
        if tokens.shape[1] == 1:  # decode
            pos = cache["pos"]

    for i, (lp, lc) in enumerate(zip(params.blocks, layer_caches)):
        x = _apply_layer(lp, cfg, x, kind=kinds[i], has_moe=moe_mask[i],
                         cache=lc, pos=pos, shard=shard)

    x = shard(L.rmsnorm(x, params.final_norm, cfg.norm_eps), "residual")
    logits = shard(torch.matmul(x, embed.T), "logits")

    new_cache = None
    if cache is not None:
        new_cache = {"pos": cache["pos"] + tokens.shape[1],
                     "layers": layer_caches}
    return logits, new_cache, ({} if collect_aux else None)
