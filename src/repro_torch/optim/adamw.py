"""AdamW with fp32 moments, decoupled weight decay and a global-norm clip.

Port of ``repro/optim/adamw.py``: the same formulas in the same order of
operations, over trees of tensors (nested dicts and lists, leaves in
``jax.tree`` order, :mod:`repro_torch.comm.overlap`). :func:`adamw_update`
is the reference's function: it returns new weights and a new state.
:func:`adamw_update_` performs the same operations leaf by leaf in place,
under ``torch.no_grad``, and gives the same bits; the training step uses it.
The reference returns new trees and lets ``jax.jit`` donate the old
buffers; without donation a whole-model update holds old and new weights
and moments at once, which for llama3.2-3b (12.85 GB per fp32 tree) does
not fit beside its state on an 80 GB card.

Each product and sum rounds to fp32 once, as the reference writes it
(``b1 * m + (1 - b1) * g`` is two products and a sum; no fused
multiply-add, which ``add_(alpha=)`` would be on the CPU). The bias
corrections and the learning rate are fp32 scalars on the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.comm.overlap import tree_flatten, tree_unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0


def _map(fn, *trees):
    leaves = [tree_flatten(t)[0] for t in trees]
    return tree_unflatten(tree_flatten(trees[0])[1],
                          [fn(*xs) for xs in zip(*leaves)])


def adamw_init(params) -> Dict:
    """Zero fp32 moments shaped like ``params`` (on its devices) and an
    int32 step count on the host."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"mu": _map(zeros, params), "nu": _map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in tree order, from 0) of each leaf's
    fp32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_flatten(tree)[0]))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor :func:`clip_by_global_norm` multiplies every leaf by."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float) -> Tuple[object,
                                                         torch.Tensor]:
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return _map(lambda g: g.float() * scale, grads), norm


def _corrections(cfg: AdamWConfig, count: torch.Tensor):
    c = count.float().cpu()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32), c)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32), c)
    return b1c, b2c


def _moments(cfg, m, v, g):
    g = g.float()
    return (cfg.b1 * m + (1 - cfg.b1) * g,
            cfg.b2 * v + (1 - cfg.b2) * g * g)


def _stepped(cfg, p, m, v, b1c, b2c, lr):
    update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
    update = update + cfg.weight_decay * p.float()
    return (p.float() - lr * update).to(p.dtype)


def adamw_update(grads, state: Dict, params, cfg: AdamWConfig,
                 lr) -> Tuple[object, Dict]:
    """Returns (new_params, new_state); nothing is written in place."""
    count = state["count"] + 1
    b1c, b2c = _corrections(cfg, count)
    g_leaves, spec = tree_flatten(grads)
    mv = [_moments(cfg, m, v, g) for m, v, g in zip(
        tree_flatten(state["mu"])[0], tree_flatten(state["nu"])[0],
        g_leaves)]
    p_leaves, p_spec = tree_flatten(params)
    new_params = tree_unflatten(p_spec, [
        _stepped(cfg, p, m, v, b1c, b2c, lr)
        for p, (m, v) in zip(p_leaves, mv)])
    return new_params, {"mu": tree_unflatten(spec, [m for m, _ in mv]),
                        "nu": tree_unflatten(spec, [v for _, v in mv]),
                        "count": count}


# elements of a leaf updated at a time: the update's fp32 temporaries (the
# scaled gradient, the new moments, the step) then take a few times this,
# not a few times the largest leaf (llama3.2-3b's 1.58 GB embedding); every
# element goes through the same operations, so the bits do not move
UPDATE_CHUNK = 1 << 26


def _update_(cfg, p, m, v, g, scale, b1c, b2c, lr) -> None:
    if scale is not None:
        g = g.float() * scale
    m_new, v_new = _moments(cfg, m, v, g)
    m.copy_(m_new)
    v.copy_(v_new)
    del m_new, v_new
    p.copy_(_stepped(cfg, p, m, v, b1c, b2c, lr))


@torch.no_grad()
def adamw_update_(grads, state: Dict, params, cfg: AdamWConfig, lr, *,
                  scale: Optional[torch.Tensor] = None) -> None:
    """:func:`adamw_update` in place, leaf by leaf (a leaf of more than
    :data:`UPDATE_CHUNK` elements in runs of that many): ``params``'
    leaves (tensors or parameters) and ``state``'s moments are overwritten
    with the new values and ``state['count']`` is replaced. With ``scale``
    each gradient is first multiplied by it in fp32, as
    :func:`clip_by_global_norm` does, without a clipped copy of the
    tree."""
    count = state["count"] + 1
    b1c, b2c = _corrections(cfg, count)
    for p, m, v, g in zip(tree_flatten(params)[0],
                          tree_flatten(state["mu"])[0],
                          tree_flatten(state["nu"])[0],
                          tree_flatten(grads)[0]):
        n = p.numel()
        if n <= UPDATE_CHUNK or not all(t.is_contiguous()
                                        for t in (p, m, v)):
            _update_(cfg, p, m, v, g, scale, b1c, b2c, lr)
            continue
        flat = (p.view(-1), m.view(-1), v.view(-1), g.reshape(-1))
        for s in range(0, n, UPDATE_CHUNK):
            _update_(cfg, *(t[s:s + UPDATE_CHUNK] for t in flat), scale,
                     b1c, b2c, lr)
    state["count"] = count


def make_lr_schedule(base_lr: float, warmup_steps: int,
                     total_steps: int = 10_000,
                     min_ratio: float = 0.1) -> Callable:
    """Linear warmup, then cosine decay to ``min_ratio * base_lr``; the
    rate at ``step`` as an fp32 scalar on the host."""
    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step).to("cpu", torch.float32)
        warm = step / max(warmup_steps, 1)
        progress = torch.clamp((step - warmup_steps)
                               / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * progress))
        return base_lr * torch.where(step < warmup_steps, warm, cos)
    return schedule
