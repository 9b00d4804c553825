"""Whisper-style encoder-decoder backbone.

Port of ``repro/models/encdec.py``. As in the reference, the conv/mel
front end is a stub: the encoder takes precomputed frame embeddings (B,
audio_ctx, d_model). Positions are sinusoidal in the encoder and, from the
cache position, in the decoder; no rope. The encoder's attention is not
causal; each decoder layer runs causal self-attention with a dense cache,
then cross-attention to the encoder's output, then the MLP. No path here
takes the flash kernel: the reference passes no shard function to these
attentions.

On a mesh of several ranks (a ``shard`` from
:func:`repro_torch.sharding.make_shard_fn`) each rank runs its rows; on a
``tp`` axis wider than 1 the embedding and the tied head split over the
vocabulary, and the encoder's attention, the decoder's self- and
cross-attention and both MLPs split their heads and hidden width as the
decoder-only model's do (:mod:`repro_torch.models.layers`), each whole on
every rank where ``tp`` does not divide them. ``encoder_out`` in the
cache stays whole over ``tp``. With FSDP (``shard.gather``) each layer's
dp-split weights are gathered before its forward.

The reference stacks each block list over layers with ``vmap`` and runs it
as a ``lax.scan``; here ``enc_blocks`` and ``dec_blocks`` are per-layer
lists (:func:`repro_torch.models.model.from_reference` moves weights
across). Decode writes its token into each layer's cache in place, where
the reference rebuilds the whole layer cache (``encdec.py:114-121``): the
values are the same.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.kvcache import attn_cache_spec, local_cache_dims
from repro_torch.models.transformer import (ParamTree, Shard, _noshard,
                                            _param, dtype_of, embed_tokens,
                                            lm_logits, rematerialize)
from repro_torch.partition import tp_of


def _init_enc_layer(gen, cfg: ModelConfig, device) -> Dict:
    return {
        "ln1": L.init_rmsnorm(cfg.d_model, device),
        "attn": L.init_attention(gen, cfg,
                                 layers_for_scale=cfg.num_encoder_layers,
                                 device=device),
        "ln2": L.init_rmsnorm(cfg.d_model, device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.num_encoder_layers,
                          device),
    }


def _init_dec_layer(gen, cfg: ModelConfig, device) -> Dict:
    return {
        "ln1": L.init_rmsnorm(cfg.d_model, device),
        "self_attn": L.init_attention(gen, cfg, device=device),
        "cross_ln": L.init_rmsnorm(cfg.d_model, device),
        "cross_attn": L.init_attention(gen, cfg, kv_in_dim=cfg.d_model,
                                       device=device),
        "ln2": L.init_rmsnorm(cfg.d_model, device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.num_layers, device),
    }


class EncDecParams(nn.Module):
    """The weights: ``embed`` (padded vocab, d_model; also the tied LM
    head), ``enc_blocks`` (ln1, attn, ln2, mlp per encoder layer),
    ``enc_norm``, ``dec_blocks`` (ln1, self_attn, cross_ln, cross_attn,
    ln2, mlp per decoder layer) and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, tree: Dict):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(tree["embed"])
        self.enc_blocks = nn.ModuleList(ParamTree(t)
                                        for t in tree["enc_blocks"])
        self.enc_norm = _param(tree["enc_norm"])
        self.dec_blocks = nn.ModuleList(ParamTree(t)
                                        for t in tree["dec_blocks"])
        self.final_norm = _param(tree["final_norm"])

    def tree(self, data: bool = True) -> Dict:
        """The nested dict of weights; ``data=False`` gives the parameters
        themselves."""
        leaf = (lambda p: p.data) if data else (lambda p: p)
        return {"embed": leaf(self.embed),
                "enc_blocks": [b.tree(data) for b in self.enc_blocks],
                "enc_norm": leaf(self.enc_norm),
                "dec_blocks": [b.tree(data) for b in self.dec_blocks],
                "final_norm": leaf(self.final_norm)}


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device=None) -> EncDecParams:
    """Random weights with the reference's shapes and scales, drawn in fp32
    from ``gen`` on its device (or on ``device``; ``"meta"`` gives the
    shapes without storage)."""
    device = gen.device if device is None else device
    V = cfg.padded_vocab()
    return EncDecParams(cfg, {
        "embed": torch.randn((V, cfg.d_model), generator=gen,
                             device=device) * 0.02,
        "enc_blocks": [_init_enc_layer(gen, cfg, device)
                       for _ in range(cfg.num_encoder_layers)],
        "enc_norm": L.init_rmsnorm(cfg.d_model, device),
        "dec_blocks": [_init_dec_layer(gen, cfg, device)
                       for _ in range(cfg.num_layers)],
        "final_norm": L.init_rmsnorm(cfg.d_model, device)})


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None, mesh=None) -> Dict:
    """``{'pos': 0, 'layers': [per decoder layer {'k', 'v'}],
    'encoder_out': (batch, audio_ctx, d_model)}``, all in ``dtype``; with
    a ``mesh`` (``batch`` global) this rank's rows and KV heads, and
    ``encoder_out`` whole over ``tp``."""
    kv = None
    if mesh is not None:
        batch, kv, _ = local_cache_dims(cfg, batch, mesh)
    return {"pos": 0,
            "layers": [attn_cache_spec(cfg, batch, max_seq, dtype, device,
                                       kv_heads=kv)
                       for _ in range(cfg.num_layers)],
            "encoder_out": torch.zeros((batch, cfg.audio_ctx, cfg.d_model),
                                       dtype=dtype, device=device)}


def _gathered(shard, path, sub):
    gather = getattr(shard, "gather", None)
    return sub if gather is None else gather(path, sub)


def encode(params: EncDecParams, cfg: ModelConfig, frames: torch.Tensor,
           shard: Shard = _noshard) -> torch.Tensor:
    """frames: (B, T, d_model) stub embeddings -> (B, T, d_model)."""
    dtype = dtype_of(cfg.dtype)
    T = frames.shape[1]
    x = frames.to(dtype) + L.sinusoidal_positions(
        torch.arange(T, device=frames.device), cfg.d_model)[None].to(dtype)
    x = shard(x, "residual")
    for i in range(cfg.num_encoder_layers):
        lp = _gathered(shard, ("enc_blocks", i), params.enc_blocks[i])
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        a, _ = L.apply_attention(lp["attn"], cfg, h, causal=False,
                                 use_rope=False, shard=shard, flash=False)
        x = shard(x + a, "residual")
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        x = shard(x + L.apply_mlp(lp["mlp"], h, shard=shard, d_ff=cfg.d_ff),
                  "residual")
    return L.rmsnorm(x, _gathered(shard, "enc_norm", params.enc_norm),
                     cfg.norm_eps)


def decode(params: EncDecParams, cfg: ModelConfig, tokens: torch.Tensor,
           encoder_out: torch.Tensor, *, cache: Optional[Dict] = None,
           shard: Shard = _noshard, remat: str = "none") -> torch.Tensor:
    """Decoder logits (B, S, V); with a ``cache``, its layers are written
    in place (positions [0, S) in prefill, ``pos`` in decode). Without one
    (train mode) each decoder layer runs under the checkpoint policy
    ``remat`` (``transformer.REMAT_POLICIES``); the reference checkpoints
    its decoder layers under ``"full"`` only and runs ``"dots"`` as
    ``"none"``, which changes no value."""
    dtype = dtype_of(cfg.dtype)
    part = tp_of(shard)
    S = tokens.shape[1]
    pos = cache["pos"] if cache is not None and S == 1 else None
    positions = (pos if pos is not None else 0) + torch.arange(
        S, device=tokens.device)
    embed = _gathered(shard, "embed", params.embed).to(dtype)
    x = embed_tokens(cfg, embed, tokens, part) + L.sinusoidal_positions(
        positions, cfg.d_model)[None].to(dtype)
    x = shard(x, "residual")
    layer_caches = cache["layers"] if cache is not None else \
        [None] * cfg.num_layers

    def block(x, i):
        # inside remat: gathered again in the recompute
        lp = _gathered(shard, ("dec_blocks", i), params.dec_blocks[i])
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        a, _ = L.apply_attention(lp["self_attn"], cfg, h,
                                 cache=layer_caches[i], pos=pos,
                                 use_rope=False, shard=shard, flash=False)
        x = shard(x + a, "residual")
        h = L.rmsnorm(x, lp["cross_ln"], cfg.norm_eps)
        c, _ = L.apply_attention(lp["cross_attn"], cfg, h, kv_x=encoder_out,
                                 causal=False, use_rope=False, shard=shard)
        x = shard(x + c, "residual")
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        return shard(x + L.apply_mlp(lp["mlp"], h, shard=shard,
                                     d_ff=cfg.d_ff), "residual")

    body = rematerialize(block, remat if cache is None else "none")
    for i in range(cfg.num_layers):
        x = body(x, i)
    x = L.rmsnorm(x, _gathered(shard, "final_norm", params.final_norm),
                  cfg.norm_eps)
    return lm_logits(cfg, embed, x, part, shard)


def apply(params: EncDecParams, cfg: ModelConfig, tokens: torch.Tensor, *,
          frames: Optional[torch.Tensor] = None,
          cache: Optional[Dict] = None, shard: Shard = _noshard,
          remat: str = "none"):
    """Returns (logits, cache, None). train (no cache) and prefill (S > 1)
    run the encoder on ``frames``; prefill stores its output in the
    cache's dtype. Decode (S == 1) reads it back in the compute dtype.
    ``remat`` applies to the decoder in train mode (:func:`decode`)."""
    if cache is None:
        enc = encode(params, cfg, frames, shard=shard)
        return decode(params, cfg, tokens, enc, shard=shard,
                      remat=remat), None, None
    S = tokens.shape[1]
    if S > 1:  # prefill
        enc = encode(params, cfg, frames, shard=shard)
        logits = decode(params, cfg, tokens, enc, cache=cache, shard=shard)
        cache["encoder_out"].copy_(enc)
    else:
        enc = cache["encoder_out"].to(dtype_of(cfg.dtype))
        logits = decode(params, cfg, tokens, enc, cache=cache, shard=shard)
    new_cache = {"pos": cache["pos"] + S, "layers": cache["layers"],
                 "encoder_out": cache["encoder_out"]}
    return logits, new_cache, None
