"""Decoder-only LM: the dense family.

Port of ``repro/models/transformer.py`` for ``family == "dense"``. The
reference stacks each period position's parameters over super-blocks and
runs the layers as one ``lax.scan``; here the layers are an
``nn.ModuleList`` looped in Python, layer ``i`` holding what the reference
keeps at index ``i // period`` of ``blocks/p{i % period}``
(:func:`repro_torch.models.model.from_reference` moves weights across).
The cache is a list of per-layer ``{'k', 'v'}`` pairs written in place
(the reference donates its cache and returns the updated one); decode
writes one position into each layer's cache where the reference merges
token-sized updates after its scan.

Every other family raises ``NotImplementedError`` naming its ROADMAP item:
MoE, SSM, hybrid, cross-attention (vlm) and qk-norm layers (A11),
encoder-decoder (A11), the paged cache (A13).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.kvcache import attn_cache_spec

Shard = Callable[[torch.Tensor, str], torch.Tensor]


def _noshard(x, name):
    return x


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration outside the ported dense family."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are "
                                  "not ported yet (ROADMAP A11)")
    if cfg.family != "dense" or cfg.has_moe or cfg.cross_attn_every \
            or cfg.use_qk_norm:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family (MoE, SSM, hybrid, "
            "cross-attention and qk-norm layers) is not ported yet (ROADMAP "
            "A11); only dense decoders are")


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


class LayerParams(nn.Module):
    """One decoder layer: ``ln1``, ``attn`` (wq, wk, wv, wo [+ biases]),
    ``ln2`` and ``mlp`` (w_gate, w_in, w_out), in the reference's
    shapes."""

    def __init__(self, tree: Dict):
        super().__init__()
        self.ln1 = _param(tree["ln1"])
        self.attn = nn.ParameterDict({k: _param(v)
                                      for k, v in tree["attn"].items()})
        self.ln2 = _param(tree["ln2"])
        self.mlp = nn.ParameterDict({k: _param(v)
                                     for k, v in tree["mlp"].items()})

    def tree(self) -> Dict:
        return {"ln1": self.ln1.data,
                "attn": {k: v.data for k, v in self.attn.items()},
                "ln2": self.ln2.data,
                "mlp": {k: v.data for k, v in self.mlp.items()}}


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


def _init_layer(gen, cfg: ModelConfig, device) -> Dict:
    return {"ln1": L.init_rmsnorm(cfg.d_model, device),
            "attn": L.init_attention(gen, cfg, device=device),
            "ln2": L.init_rmsnorm(cfg.d_model, device),
            "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.num_layers,
                              device)}


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Random weights with the reference's shapes and scales (normal, std
    0.02; output projections 0.02 / sqrt(2 * layers); norms 1), drawn in
    fp32 from ``gen`` on its device. The reference's ``jax.random`` draws
    other numbers: move its weights with ``from_reference`` to compare."""
    check_supported(cfg)
    device = gen.device
    V = cfg.padded_vocab()
    tree = {"embed": torch.randn((V, cfg.d_model), generator=gen,
                                 device=device) * 0.02,
            "final_norm": L.init_rmsnorm(cfg.d_model, device),
            "blocks": [_init_layer(gen, cfg, device)
                       for _ in range(cfg.num_layers)]}
    return Params(cfg, tree)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Dict:
    """``{'pos': 0, 'layers': [{'k', 'v'} per layer]}``."""
    check_supported(cfg)
    return {"pos": 0,
            "layers": [attn_cache_spec(cfg, batch, max_seq, dtype, device)
                       for _ in range(cfg.num_layers)]}


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def _apply_layer(lp: LayerParams, cfg: ModelConfig, x, *, cache, pos,
                 shard: Shard):
    h = L.rmsnorm(x, lp.ln1, cfg.norm_eps)
    a, _ = L.apply_attention(lp.attn, cfg, h, cache=cache, pos=pos,
                             shard=shard)
    x = shard(x + a, "residual")
    h = L.rmsnorm(x, lp.ln2, cfg.norm_eps)
    return shard(x + L.apply_mlp(lp.mlp, h), "residual")


def apply(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
          cache: Optional[Dict] = None, shard: Shard = _noshard
          ) -> Tuple[torch.Tensor, Optional[Dict], None]:
    """Returns (logits, cache, aux); aux (the MoE losses) is None here.

    train:   cache=None                  -> logits (B, S, V)
    prefill: cache at pos 0              -> logits (B, S, V), cache filled
    decode:  cache with pos > 0, S == 1  -> logits (B, 1, V), cache advanced

    The cache's tensors are written in place; the returned dict shares them
    and carries ``pos + S``."""
    check_supported(cfg)
    dtype = dtype_of(cfg.dtype)
    embed = params.embed.to(dtype)
    x = shard(embed[tokens], "residual")

    pos = None
    layer_caches = [None] * cfg.num_layers
    if cache is not None:
        layer_caches = cache["layers"]
        if "k_pages" in layer_caches[0]:
            raise NotImplementedError("the paged KV cache is not ported yet "
                                      "(ROADMAP A13)")
        if tokens.shape[1] == 1:  # decode
            pos = cache["pos"]

    for lp, lc in zip(params.blocks, layer_caches):
        x = _apply_layer(lp, cfg, x, cache=lc, pos=pos, shard=shard)

    x = shard(L.rmsnorm(x, params.final_norm, cfg.norm_eps), "residual")
    logits = shard(torch.matmul(x, embed.T), "logits")

    new_cache = None
    if cache is not None:
        new_cache = {"pos": cache["pos"] + tokens.shape[1],
                     "layers": layer_caches}
    return logits, new_cache, None
