"""Family dispatch: one Model API, and weights to and from the reference.

Port of ``repro/models/model.py``. ``build_model(cfg)`` returns a
:class:`Model` with ``init / apply / init_cache`` closures for the dense,
MoE, SSM and hybrid decoder families; cross-attention (vlm) and
encoder-decoder models raise ``NotImplementedError`` naming ROADMAP A11.
:func:`from_reference` and :func:`to_reference` move weights between the
reference's parameter tree (numpy arrays, each block leaf stacked over
super-blocks, ``blocks/p{i}`` per period position with its own kind of
layer: attention or SSM, MoE (with ``shared``) or MLP) and the port's
per-layer modules, bit for bit; they are the one place where layouts
change.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hpcc import resolve_device
from repro_torch.models import transformer
from repro_torch.models.transformer import Params, _noshard


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable        # (seed=0, *, device=None) -> Params
    apply: Callable       # (params, batch, cache=None, shard=...) -> (logits, cache, aux)
    init_cache: Callable  # (batch, max_seq, dtype=bf16, device=None) -> cache


def _decoder_apply(cfg):
    def apply(params, batch, *, cache=None, shard=_noshard):
        return transformer.apply(params, cfg, batch["tokens"], cache=cache,
                                 shard=shard)
    return apply


def build_model(cfg: ModelConfig) -> Model:
    transformer.check_supported(cfg)

    def init(seed: int = 0, *, device=None) -> Params:
        gen = torch.Generator(device=resolve_device(device))
        return transformer.init_params(cfg, gen.manual_seed(seed))

    def init_cache(batch, max_seq, dtype=torch.bfloat16, device=None):
        return transformer.init_cache(cfg, batch, max_seq, dtype,
                                      resolve_device(device))

    return Model(cfg=cfg, init=init, apply=_decoder_apply(cfg),
                 init_cache=init_cache)


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


def from_reference(cfg: ModelConfig, params_np: Dict, *,
                   device=None) -> Params:
    """The port's weights from the reference's parameter tree (numpy or
    array-like leaves): layer ``i`` takes index ``i // period`` of every
    ``blocks/p{i % period}`` leaf; shapes and values are unchanged."""
    transformer.check_supported(cfg)
    dev = resolve_device(device)
    period = transformer.period_of(cfg)

    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    blocks = []
    for i in range(cfg.num_layers):
        s, p = divmod(i, period)
        blocks.append(transformer.tree_map(params_np["blocks"][f"p{p}"],
                                lambda a, s=s: t(np.asarray(a)[s])))
    return Params(cfg, {"embed": t(params_np["embed"]),
                        "final_norm": t(params_np["final_norm"]),
                        "blocks": blocks})


def to_reference(params: Params) -> Dict:
    """The reference's parameter tree (numpy leaves, block leaves stacked
    over super-blocks) of the port's weights."""
    cfg = params.cfg
    period = transformer.period_of(cfg)
    tree = params.tree()

    def n(x):
        return x.detach().cpu().numpy()

    blocks = {}
    for p in range(period):
        layers = tree["blocks"][p::period]
        blocks[f"p{p}"] = _stack([transformer.tree_map(b, n) for b in layers])
    return {"embed": n(tree["embed"]), "final_norm": n(tree["final_norm"]),
            "blocks": blocks}


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)

