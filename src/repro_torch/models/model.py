"""Family dispatch: one Model API, and weights to and from the reference.

Port of ``repro/models/model.py``. ``build_model(cfg)`` returns a
:class:`Model` with ``init / apply / init_cache`` closures for every
family: the decoder (dense, MoE, SSM, hybrid and vlm,
:mod:`repro_torch.models.transformer`; its ``apply`` passes
``batch["patch_embeds"]``) and the encoder-decoder (whisper,
:mod:`repro_torch.models.encdec`; its ``apply`` passes
``batch["frames"]``). :func:`from_reference` and :func:`to_reference` move
weights between the reference's parameter tree (numpy arrays) and the
port's per-layer modules, bit for bit, and :func:`state_from_reference` and
:func:`state_to_reference` a whole training state (weights, AdamW moments,
counters and the compression error tree); they are the one place where
layouts change. The decoder's block leaves are stacked over super-blocks,
``blocks/p{i}`` per period position, plus ``vlm`` (``patch_proj``,
``patch_norm``); the encoder-decoder's ``enc_blocks`` and ``dec_blocks``
are stacked over layers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hpcc import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.transformer import _noshard


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable        # (seed=0, *, device=None) -> Params / EncDecParams
    apply: Callable       # (params, batch, cache=None, shard=..., remat=...) -> (logits, cache, aux)
    init_cache: Callable  # (batch, max_seq, dtype=bf16, device=None, mesh=None) -> cache


def _decoder_apply(cfg):
    def apply(params, batch, *, cache=None, shard=_noshard, remat="none",
              attn_impl=None, moe_impl=None, page_table=None):
        return transformer.apply(params, cfg, batch["tokens"], cache=cache,
                                 patch_embeds=batch.get("patch_embeds"),
                                 shard=shard, remat=remat,
                                 attn_impl=attn_impl, moe_impl=moe_impl,
                                 page_table=page_table)
    return apply


def _encdec_apply(cfg):
    def apply(params, batch, *, cache=None, shard=_noshard, remat="none"):
        return encdec.apply(params, cfg, batch["tokens"],
                            frames=batch.get("frames"), cache=cache,
                            shard=shard, remat=remat)
    return apply


def build_model(cfg: ModelConfig) -> Model:
    mod = encdec if cfg.is_encoder_decoder else transformer

    def init(seed: int = 0, *, device=None):
        # device="meta": the shapes without storage (a CPU generator drives
        # nothing there)
        dev = resolve_device(device)
        if dev.type == "meta":
            return mod.init_params(cfg, torch.Generator().manual_seed(seed),
                                   device=dev)
        gen = torch.Generator(device=dev)
        return mod.init_params(cfg, gen.manual_seed(seed))

    def init_cache(batch, max_seq, dtype=torch.bfloat16, device=None,
                   mesh=None):
        return mod.init_cache(cfg, batch, max_seq, dtype,
                              resolve_device(device), mesh=mesh)

    apply = _encdec_apply(cfg) if cfg.is_encoder_decoder \
        else _decoder_apply(cfg)
    return Model(cfg=cfg, init=init, apply=apply, init_cache=init_cache)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    z_loss: float = 1e-4) -> torch.Tensor:
    """Shifted next-token cross entropy (+ z-loss), mean over positions.
    logits: (B, S, V); tokens: (B, S). Position t predicts token t + 1."""
    logits = logits[:, :-1].float()
    targets = tokens[:, 1:].long()
    lse = torch.logsumexp(logits, dim=-1)
    tgt_logit = logits.gather(-1, targets[..., None])[..., 0]
    nll = lse - tgt_logit
    if z_loss:
        nll = nll + z_loss * lse.square()
    return nll.mean()


# ---------------------------------------------------------------------------
# weights to and from the reference
# ---------------------------------------------------------------------------


def from_reference(cfg: ModelConfig, params_np: Dict, *, device=None):
    """The port's weights from the reference's parameter tree (numpy or
    array-like leaves); shapes and values are unchanged. Decoder layer
    ``i`` takes index ``i // period`` of every ``blocks/p{i % period}``
    leaf; encoder-decoder layer ``i`` takes index ``i`` of its block
    list's leaves."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    def layer(stacked, s):
        return transformer.tree_map(stacked, lambda a: t(np.asarray(a)[s]))

    if cfg.is_encoder_decoder:
        return encdec.EncDecParams(cfg, {
            "embed": t(params_np["embed"]),
            "enc_blocks": [layer(params_np["enc_blocks"], i)
                           for i in range(cfg.num_encoder_layers)],
            "enc_norm": t(params_np["enc_norm"]),
            "dec_blocks": [layer(params_np["dec_blocks"], i)
                           for i in range(cfg.num_layers)],
            "final_norm": t(params_np["final_norm"])})
    period = transformer.period_of(cfg)
    tree = {"embed": t(params_np["embed"]),
            "final_norm": t(params_np["final_norm"]),
            "blocks": [layer(params_np["blocks"][f"p{i % period}"],
                             i // period) for i in range(cfg.num_layers)]}
    if "vlm" in params_np:
        tree["vlm"] = transformer.tree_map(params_np["vlm"], t)
    return transformer.Params(cfg, tree)


def to_reference(params) -> Dict:
    """The reference's parameter tree (numpy leaves, block leaves stacked
    over super-blocks, or over layers for the encoder-decoder) of the
    port's weights: a copy, which later in-place updates leave alone."""
    cfg = params.cfg
    tree = transformer.tree_map(params.tree(),
                                lambda x: x.detach().cpu().numpy().copy())
    if cfg.is_encoder_decoder:
        return {**tree, "enc_blocks": _stack(tree["enc_blocks"]),
                "dec_blocks": _stack(tree["dec_blocks"])}
    period = transformer.period_of(cfg)
    return {**tree, "blocks": {f"p{p}": _stack(tree["blocks"][p::period])
                               for p in range(period)}}


def pages_from_reference(cfg: ModelConfig, pages_np: Dict, *, device=None,
                         kv_heads=None) -> Dict:
    """The port's page pools (``{'layers': [per layer {'k_pages',
    'v_pages'}]}``) from the reference's ``init_paged_cache`` layout, whose
    ``layers/p{i % period}`` leaves stack ``(n_super, P, ps, KV, hd)``:
    layer ``i`` takes index ``i // period``. ``kv_heads`` (start, count)
    keeps that slice of the KV heads, a rank's pool
    (:func:`repro_torch.models.kvcache.pool_heads`). A copy."""
    dev = resolve_device(device)
    period = transformer.period_of(cfg)

    def pool(a):
        a = np.asarray(a)
        if kv_heads is not None:
            a = a[:, :, kv_heads[0]:kv_heads[0] + kv_heads[1]]
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return {"layers": [
        {k: pool(v[i // period])
         for k, v in pages_np["layers"][f"p{i % period}"].items()}
        for i in range(cfg.num_layers)]}


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def state_from_reference(cfg: ModelConfig, state_np, *, device=None):
    """The port's :class:`~repro_torch.train.step.TrainState` from the
    reference's (a ``TrainState`` or a dict with ``params``, ``opt``,
    ``step`` and ``error``, numpy or array-like leaves): the weights with
    gradients on, ``mu``, ``nu`` and ``error`` as trees of the port's
    layout, ``count`` and ``step`` as int32 scalars on the host."""
    from repro_torch.train.step import TrainState

    def get(k):
        return state_np[k] if isinstance(state_np, dict) else \
            getattr(state_np, k)

    def tree(t):
        return from_reference(cfg, t, device=device).tree()

    def scalar(v):
        return torch.tensor(int(np.asarray(v)), dtype=torch.int32)

    params = from_reference(cfg, get("params"), device=device)
    params.requires_grad_(True)
    opt, error = get("opt"), get("error")
    return TrainState(params=params,
                      opt={"mu": tree(opt["mu"]), "nu": tree(opt["nu"]),
                           "count": scalar(opt["count"])},
                      step=scalar(get("step")),
                      error=None if error is None else tree(error))


def state_to_reference(state) -> Dict:
    """The reference's layout of a port training state: ``{'params',
    'opt': {'mu', 'nu', 'count'}, 'step', 'error'}`` with numpy leaves."""
    params = state.params
    cls, cfg = type(params), params.cfg

    def ref(tree):
        return to_reference(cls(cfg, tree))

    def scalar(t):
        return np.asarray(int(t), dtype=np.int32)

    return {"params": to_reference(params),
            "opt": {"mu": ref(state.opt["mu"]), "nu": ref(state.opt["nu"]),
                    "count": scalar(state.opt["count"])},
            "step": scalar(state.step),
            "error": None if state.error is None else ref(state.error)}
