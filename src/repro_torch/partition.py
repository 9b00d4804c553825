"""The realisation of the sharding specs on a mesh of several ranks.

The reference's counterpart is XLA's GSPMD partitioner: its
``make_train_step`` is one ``jax.jit`` whose shardings come from
:mod:`repro.sharding`'s rules, and the partitioner inserts every
collective where a layout changes. PyTorch has no such partitioner (a
layout on an activation inserts nothing), so here the specs of
:mod:`repro_torch.sharding` are layouts that the layers realise
themselves, with one collective-engine call where GSPMD puts its
collective:

* Megatron's conjugate pair around a tensor-parallel block:
  :func:`copy_to` (identity forward, a ``tp`` allreduce of the gradient
  backward) where a replicated activation enters a column-split product,
  and :func:`reduce_from` (a ``tp`` allreduce forward, identity backward)
  after a row-split product. A whole weight used by a rank's share of the
  heads only (the KV projections when the KV heads do not divide ``tp``,
  the qk-norm scales) goes through :func:`copy_to` too, so that its
  gradient is the sum of every rank's share. A layer whose heads, experts
  or hidden width ``tp`` does not divide keeps its weights whole (the
  reference's ``_maybe`` rule) and runs whole on every rank of ``tp`` on
  the same tokens: it needs no collective, since each rank's gradients are
  the whole ones already;
* :func:`embed_lookup`: the vocab-split embedding, a masked local gather
  then a ``tp`` allreduce;
* :func:`gather`: an all-gather along one dimension (backward: this
  rank's slice of the gradient), for the vocab-split logits before the
  loss and before sampling;
* :func:`gather_summed`: an all-gather whose backward sums the gradient
  over the axis and keeps this rank's slice: the FSDP weights over ``dp``,
  and the MoE router's logits over ``tp`` (each rank's gradient of the
  whole logits reaches only its own experts' combine weights).

The reference leaves these collectives to XLA, its ``native`` path, so
every call here runs the engine's ``native`` schedule (the library's
all-gather for the gathers), resolved by no callsite and priced by no
tuning table. The bytes it stages through the
host count in :func:`repro_torch.comm.engine.staged_bytes`, split in
``staged_bytes_by_callsite`` by their source (:data:`SOURCES`), an
accounting label only. Every function is the
identity on an axis of size 1 and adds no operation there, so a one-rank
mesh runs exactly what it ran before.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.comm.engine import CollectiveEngine
from repro_torch.sharding import _axsize, block_of

SCHEDULE = "native"
# what the staged bytes of each kind of call count under: the tensor-
# parallel blocks and the embedding, the logits' gather, the FSDP weights'
# gathers, the ZeRO-1 blocks' gathers, the data-parallel gradient, loss
# and norm reductions
TP, LOGITS, FSDP, ZERO1, DP = ("gspmd.tp", "gspmd.logits", "gspmd.fsdp",
                               "gspmd.zero1", "gspmd.dp")
SOURCES = (TP, LOGITS, FSDP, ZERO1, DP)

_ENGINES: dict = {}


def engine_for(mesh) -> CollectiveEngine:
    """One ``native`` engine per mesh (kept with the mesh it serves)."""
    hit = _ENGINES.get(id(mesh))
    if hit is None or hit[0] is not mesh:
        hit = (mesh, CollectiveEngine.for_mesh(mesh, schedule=SCHEDULE))
        _ENGINES[id(mesh)] = hit
    return hit[1]


@dataclass(frozen=True)
class Placement:
    """This rank's place on a wide mesh under a ``ShardFn``: the ``tp``
    axis (None when it has size 1), the ``dp`` axes, their sizes and
    this rank's indices on them."""
    mesh: object
    tp: Optional[str]
    tp_n: int
    tp_index: int
    dp: object
    dp_n: int
    dp_index: int

    @property
    def engine(self) -> CollectiveEngine:
        return engine_for(self.mesh)


def placement(shard) -> Optional[Placement]:
    """The placement a shard callback carries, or None when it carries no
    mesh or every axis of its mesh has size 1 (the one-rank path)."""
    mesh = getattr(shard, "mesh", None)
    rules = getattr(shard, "rules", None)
    if mesh is None or rules is None:
        return None
    tp_n = _axsize(mesh, rules.tp)
    dp = rules.dp_spec
    dp_n = _axsize(mesh, dp)
    if tp_n == 1 and dp_n == 1:
        return None
    tp_index = mesh.axis(rules.tp).index if tp_n > 1 else 0
    dp_index = block_of(mesh, dp)[0] if dp_n > 1 else 0
    return Placement(mesh, rules.tp if tp_n > 1 else None, tp_n, tp_index,
                     dp, dp_n, dp_index)


def tp_of(shard) -> Optional[Placement]:
    """The placement when its ``tp`` axis is wider than 1, else None."""
    p = placement(shard)
    return p if p is not None and p.tp is not None else None


# ---------------------------------------------------------------------------
# the engine calls
# ---------------------------------------------------------------------------


def allreduce(x: torch.Tensor, mesh, axis, source: str) -> torch.Tensor:
    """``x`` summed over ``axis`` (not differentiable; the identity on a
    size-1 axis)."""
    if _axsize(mesh, axis) == 1:
        return x
    return engine_for(mesh).allreduce(x.contiguous(), axis,
                                      schedule=SCHEDULE, callsite=source)


def _slice(g: torch.Tensor, mesh, axis, dim: int) -> torch.Tensor:
    idx, n = block_of(mesh, axis)
    size = g.shape[dim] // n
    return g.narrow(dim, idx * size, size).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return allreduce(g, ctx.mesh, ctx.axis, TP), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return allreduce(x, mesh, axis, TP)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, summed, source):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.summed, ctx.source = summed, source
        return torch.cat(engine_for(mesh).all_gather(
            x.detach(), axis, callsite=source), dim=dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = allreduce(g, ctx.mesh, ctx.axis, ctx.source)
        return (_slice(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None,
                None, None)


def copy_to(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """Identity forward; backward: the gradient summed over ``axis``."""
    if _axsize(mesh, axis) == 1:
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """``x`` summed over ``axis``; backward: the identity."""
    if _axsize(mesh, axis) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axis)


def gather(x: torch.Tensor, mesh, axis, dim: int,
           source: str = LOGITS) -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` concatenated on ``dim`` in axis
    order; backward: this rank's slice of the gradient."""
    if _axsize(mesh, axis) == 1:
        return x
    return _Gather.apply(x, mesh, axis, dim % x.dim(), False, source)


def gather_summed(x: torch.Tensor, mesh, axis, dim: int,
                  source: str = FSDP) -> torch.Tensor:
    """:func:`gather` whose backward first sums the gradient over
    ``axis`` (each rank used the whole tensor, but its gradient holds
    only this rank's share): FSDP's weights, the MoE router's logits."""
    if _axsize(mesh, axis) == 1:
        return x
    return _Gather.apply(x, mesh, axis, dim % x.dim(), True, source)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor,
                 part: Placement) -> torch.Tensor:
    """Rows ``tokens`` of a vocabulary split over ``part.tp``: each rank
    gathers the rows it holds (zeros elsewhere), then a ``tp`` allreduce
    adds the one nonzero term of every row."""
    v_loc = embed.shape[0]
    local = tokens.long() - part.tp_index * v_loc
    inside = (local >= 0) & (local < v_loc)
    rows = embed[local.clamp(0, v_loc - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return reduce_from(rows, part.mesh, part.tp)


def kv_block(num_heads: int, num_kv_heads: int,
             part: Placement) -> Tuple[int, int]:
    """(start, count) of the KV heads this rank's contiguous q heads map
    to when the KV heads do not divide ``tp`` (the reference's
    ``_flash_sharded`` block, ``layers.py:233-241``)."""
    h_loc = num_heads // part.tp_n
    group = num_heads // num_kv_heads
    return (part.tp_index * h_loc) // group, max(h_loc // group, 1)
