"""Collective engine: named communication schedules behind one API.

Port of ``repro/comm/engine.py`` (registry ``:95-145``, bcast schedules
``:191-289``, all_to_all_tiles schedules ``:293-340``, allreduce schedules
``:344-505``, ring_exchange ``:510-528``, grid_transpose ``:536-588``,
``CollectiveEngine`` ``:597-1000``). Every collective op has named
implementations ("schedules") registered against it, and a
:class:`CollectiveEngine` selects one per op from ``(CommunicationType,
schedule name)``. Callers hold an engine and never branch on comm or
schedule themselves.

Where the reference runs inside ``shard_map`` and hops with ``ppermute``,
the port runs in one process per rank (:mod:`repro_torch.launch.mesh`) and
each ring hop is an ``isend``/``irecv`` pair to the axis neighbours, posted
together with ``batch_isend_irecv`` and then awaited. The bcast and
exchange schedules move bytes only, so all of them deliver the same bits;
the allreduce schedules add in the reference's order, so on the same inputs
they give the reference's bits (``native`` and ``staged`` sum in the
library's order). On a size-1 axis every schedule is the identity and
touches no process group.

Every payload move goes through one transport helper (:func:`_post` for
point-to-point hops, :func:`_all_gather` (also the engine's one-path
:meth:`CollectiveEngine.all_gather`), :func:`_all_to_all`,
:func:`_broadcast` and :func:`_all_reduce` for the library collectives).
On a gloo group with a CUDA payload it stages the bytes through host
memory: it copies the payload to the host, sends and receives there, and
copies what arrived back to the card, counting the bytes it copies
(:func:`staged_bytes`). Only the bytes
move: every schedule's arithmetic stays on the payload's device. On any
other group (NCCL, one rank per card) device tensors move as they are.
On an axis of a dry mesh (:func:`repro_torch.launch.mesh.dry_mesh`,
whose axes carry :data:`repro_torch.comm.dry.DRY` in place of a group)
each helper moves nothing: it returns meta tensors of its output shape
and logs the op and its wire bytes (:mod:`repro_torch.comm.dry`).

Every op of the reference is ported: ``bcast`` with ``chain``,
``native``, ``staged``, ``ring2d`` and ``chain_rooted``;
``all_to_all_tiles`` with ``native``, ``chain`` and ``staged``;
``allreduce`` with ``native``, ``chain``, ``chain_rooted``, ``staged``,
``rs_ag``, ``ring2d`` and ``int8_ef``, and ``allreduce_tree``;
``ring_exchange`` with ``direct``/``chain`` and ``staged``;
``grid_transpose`` with ``direct``/``chain``, ``staged`` and ``ring2d``,
over the flattened torus (``ProcessMesh.grid``); and ``pipelined`` for
every single-payload op. ``schedule="auto"`` resolves per callsite through
the cost model (:mod:`repro_torch.comm.autotune`) from the payload size and
the axis topology (measured tuning table first, analytic alpha-beta
ranking otherwise), ``nchunks="auto"`` through its pipeline fill cost, and
``allreduce_tree``'s bucket through ``derive_bucket_bytes``.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.comm import autotune
from repro_torch.comm import dry as _dry
from repro_torch.comm.compression import dequantize_ef, quantize_ef
from repro_torch.comm.overlap import (DEFAULT_BUCKET_BYTES, pack_buckets,
                                      tree_flatten, tree_unflatten)
from repro_torch.comm.topology import MeshTopology
from repro_torch.comm.types import CommunicationType, comm_type
from repro_torch.kernels.ring import fused_chunk_add

OPS: Tuple[str, ...] = ("bcast", "all_to_all_tiles", "allreduce",
                        "ring_exchange", "grid_transpose")

_REGISTRY: Dict[str, Dict[str, Callable]] = {op: {} for op in OPS}

# static per-op fallbacks for schedule="auto" — used only when the cost
# model has nothing to go on (no topology, no payload size, unknown axis);
# with both available, auto resolves through repro_torch.comm.autotune
_AUTO = {
    "bcast": "chain",
    "all_to_all_tiles": "native",
    "allreduce": "native",
    "ring_exchange": "direct",
    "grid_transpose": "direct",
}

class UnknownScheduleError(ValueError):
    """Raised for a schedule name no op has registered."""


def register_schedule(op: str, name: str):
    """Decorator: register ``fn(engine, *args, **kw)`` as schedule ``name``
    for collective ``op``."""
    if op not in OPS:
        raise ValueError(f"unknown collective op {op!r}; ops are {OPS}")

    def deco(fn):
        _REGISTRY[op][name] = fn
        return fn
    return deco


def schedules_for(op: str) -> Tuple[str, ...]:
    """Registered schedule names for ``op``, sorted."""
    return tuple(sorted(_REGISTRY[op]))


def known_schedules() -> Tuple[str, ...]:
    names = {"auto"}
    for op in OPS:
        names.update(_REGISTRY[op])
    return tuple(sorted(names))


# ---------------------------------------------------------------------------
# shared ring helpers
# ---------------------------------------------------------------------------


_STAGED = [0]  # bytes copied between card and host by the transport
_STAGED_BY: Dict[Optional[str], int] = {}  # the same, by callsite tag
_CALLSITE: list = [None]  # the tag of the engine op now moving bytes


def staged_bytes() -> int:
    """Bytes this process's transport has copied between a card and the
    host (both directions) since the last :func:`reset_staged_bytes`."""
    return _STAGED[0]


def staged_bytes_by_callsite() -> Dict[Optional[str], int]:
    """:func:`staged_bytes` split by the callsite tag of the engine op that
    moved them (None for an untagged op). The backward of a differentiable
    exchange counts under its forward's tag; under ``remat`` a recomputed
    forward's bytes count again."""
    return dict(_STAGED_BY)


def reset_staged_bytes() -> None:
    _STAGED[0] = 0
    _STAGED_BY.clear()


@contextlib.contextmanager
def _tagged(callsite: Optional[str]):
    """Count the transport's staged bytes under ``callsite`` meanwhile."""
    prev, _CALLSITE[0] = _CALLSITE[0], callsite
    try:
        yield
    finally:
        _CALLSITE[0] = prev


def _count_staged(nbytes: int) -> None:
    _STAGED[0] += nbytes
    _STAGED_BY[_CALLSITE[0]] = _STAGED_BY.get(_CALLSITE[0], 0) + nbytes


def _staged(ax, x: torch.Tensor) -> bool:
    """Whether a payload on ``x``'s device moves through host memory on
    ``ax``'s group: gloo sends and receives only host tensors."""
    return x.device.type == "cuda" and dist.get_backend(ax.group) == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    # .cpu() waits for the stream that produced x; it keeps a dense view's
    # strides, and gloo sends only contiguous tensors
    _count_staged(x.numel() * x.element_size())
    return x.cpu().contiguous()


def _to_device(h: torch.Tensor, device) -> torch.Tensor:
    _count_staged(h.numel() * h.element_size())
    return h.to(device)


def _post(ax, sends, recvs):
    """Post every ``(tensor, global peer)`` of ``sends`` and every
    ``(template, global peer)`` of ``recvs`` on ``ax``'s group in one batch,
    wait for all, and return the received tensors (shaped and typed as
    their templates, on their device). Per peer, sends and receives match
    in posting order."""
    if _dry.is_dry(ax):
        for t, _ in sends:
            _dry.record("collective-permute", ax,
                        t.numel() * t.element_size(), _CALLSITE[0])
        return [_dry.meta_like(t) for t, _ in recvs]
    stage = _staged(ax, sends[0][0])
    bufs = [_to_host(t) if stage else t.contiguous() for t, _ in sends]
    got = [torch.empty(t.shape, dtype=t.dtype,
                       device="cpu" if stage else t.device)
           for t, _ in recvs]
    ops = [dist.P2POp(dist.isend, b, peer, group=ax.group)
           for b, (_, peer) in zip(bufs, sends)]
    ops += [dist.P2POp(dist.irecv, g, peer, group=ax.group)
            for g, (_, peer) in zip(got, recvs)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if stage:
        got = [_to_device(g, t.device) for g, (t, _) in zip(got, recvs)]
    return got


def _ring_shift_all(xs, ax, shift: int = 1) -> list:
    """Every rank of axis ``ax`` sends each tensor of ``xs`` to index
    ``+shift`` and returns what index ``-shift`` sent, in one batch: one
    hop of the ring."""
    right = ax.global_rank(ax.index + shift)
    left = ax.global_rank(ax.index - shift)
    return _post(ax, [(x, right) for x in xs], [(x, left) for x in xs])


def _ring_shift(x: torch.Tensor, ax, shift: int = 1) -> torch.Tensor:
    return _ring_shift_all([x], ax, shift)[0]


def _swap(x: torch.Tensor, ax, peer: int) -> torch.Tensor:
    """Send ``x`` to global rank ``peer`` and return what it sent back."""
    return _post(ax, [(x, peer)], [(x, peer)])[0]


def _all_gather(x: torch.Tensor, ax) -> list:
    """Every rank's ``x`` along ``ax``, in axis-index order."""
    if _dry.is_dry(ax):
        _dry.record("all-gather", ax, x.numel() * x.element_size(),
                    _CALLSITE[0])
        return [_dry.meta_like(x) for _ in range(ax.size)]
    stage = _staged(ax, x)
    buf = _to_host(x) if stage else x.contiguous()
    out = [torch.empty_like(buf) for _ in range(ax.size)]
    dist.all_gather(out, buf, group=ax.group)
    return [_to_device(o, x.device) for o in out] if stage else out


def _all_to_all(tiles, ax) -> list:
    """Tile ``j`` of ``tiles`` to axis index ``j``; the tiles every index
    sent this rank, in axis-index order. Every rank passes tiles of one
    shape and dtype. One ``all_to_all_single`` over the stacked tiles:
    gloo has no list ``all_to_all`` before torch 2.13."""
    stacked = torch.stack(tiles)
    if _dry.is_dry(ax):
        _dry.record("all-to-all", ax,
                    stacked.numel() * stacked.element_size(), _CALLSITE[0])
        return list(_dry.meta_like(stacked).unbind(0))
    stage = _staged(ax, stacked)
    buf = _to_host(stacked) if stage else stacked
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=ax.group)
    if stage:
        out = _to_device(out, stacked.device)
    return list(out.unbind(0))


def _broadcast(x: torch.Tensor, ax, src: int) -> torch.Tensor:
    """Index ``src``'s ``x`` on every rank of ``ax``."""
    if _dry.is_dry(ax):
        _dry.record("collective-broadcast", ax,
                    x.numel() * x.element_size(), _CALLSITE[0])
        return _dry.meta_like(x)
    stage = _staged(ax, x)
    buf = _to_host(x) if stage else x.contiguous().clone()
    dist.broadcast(buf, src=ax.global_rank(src), group=ax.group)
    return _to_device(buf, x.device) if stage else buf


def _all_reduce(x: torch.Tensor, ax) -> torch.Tensor:
    """The library's sum of ``x`` over ``ax`` (gloo sums on the host, NCCL
    on the cards)."""
    if _dry.is_dry(ax):
        _dry.record("all-reduce", ax, x.numel() * x.element_size(),
                    _CALLSITE[0])
        return _dry.meta_like(x)
    stage = _staged(ax, x)
    buf = _to_host(x) if stage else x.contiguous().clone()
    dist.all_reduce(buf, group=ax.group)
    return _to_device(buf, x.device) if stage else buf


def _pack_chunks(x: torch.Tensor, n: int) -> torch.Tensor:
    """Flatten + zero-pad ``x`` into an (n, L) chunk stack."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(n, -1)


# ---------------------------------------------------------------------------
# bcast schedules
# ---------------------------------------------------------------------------


@register_schedule("bcast", "chain")
def _bcast_chain(engine, val, ax, src):
    # (n-1)-hop store-and-forward pipeline: after k hops ranks src..src+k
    # hold the value (the paper's network-kernel forwarding)
    out = val
    for _ in range(ax.size - 1):
        nxt = _ring_shift(out, ax, +1)
        if ax.index != src:
            out = nxt
    return out


@register_schedule("bcast", "native")
def _bcast_native(engine, val, ax, src):
    # the library collective over the axis group
    if ax.size == 1:
        return val
    return _broadcast(val, ax, src)


@register_schedule("bcast", "staged")
def _bcast_staged(engine, val, ax, src):
    # all_gather + select: every byte transits the staging domain (the
    # route HOST_STAGED forces)
    if ax.size == 1:
        return val
    return _all_gather(val, ax)[src]


def _cut_hop(engine, ax) -> int:
    """The hop the rooted chain must not cross: the smallest hard-down hop
    of ``ax`` in the engine's cost-model health mask
    (:class:`repro_torch.comm.autotune.CostModel`), else the wraparound hop
    ``n-1``. With several down hops on one axis the chain can only avoid
    the first; the others stay in its priced route, so resolution never
    picks it there (:func:`repro_torch.comm.autotune.route_links`)."""
    health = getattr(engine._model(), "health", None) or frozenset()
    down = sorted(h for (a, h) in health if a == ax.name)
    return down[0] if down else ax.size - 1


@register_schedule("bcast", "chain_rooted")
def _bcast_chain_rooted(engine, val, ax, src):
    # Bidirectional chain rooted at ``src``, re-indexed so path position 0
    # sits just past the cut and position n-1 just before it: the forward
    # arm relays src -> tail, the backward arm src -> head, and no adopted
    # value ever crosses the cut hop.
    n = ax.size
    if n == 1:
        return val
    cut = _cut_hop(engine, ax)
    pos = (ax.index - (cut + 1)) % n
    spos = (src - (cut + 1)) % n
    f = b = val
    for _ in range(n - 1):
        nf = _ring_shift(f, ax, +1)
        if pos > spos:
            f = nf
        nb = _ring_shift(b, ax, -1)
        if pos < spos:
            b = nb
    return b if pos < spos else f


@register_schedule("bcast", "ring2d")
def _bcast_ring2d(engine, val, ax, src):
    # torus-aware two-phase ring bcast (scatter + ring all-gather): the
    # value is split into n chunks; the scatter pipeline injects chunk d at
    # step n-1-d so every chunk reaches its owner by step n-2, then a ring
    # all-gather circulates the owned chunks. Wire: 2(n-1)/n of the payload
    # per link vs chain's (n-1).
    n = ax.size
    if n == 1:
        return val
    idx = ax.index
    chunks = _pack_chunks(val, n)
    dist_ = (idx - src) % n

    # phase 1 — scatter: src injects chunks n-1, n-2, ..., 0; everyone else
    # forwards. At the final step the rank at distance d carries chunk d.
    carry = chunks[(n - 1) % n]
    for s in range(n - 1):
        recv = _ring_shift(carry, ax, +1)
        carry = chunks[(n - 2 - s) % n] if idx == src else recv
    own = chunks[0] if dist_ == 0 else carry

    # phase 2 — ring all-gather of the owned chunks
    out = torch.zeros_like(chunks)
    out[dist_] = own
    cur = own
    for s in range(n - 1):
        cur = _ring_shift(cur, ax, +1)
        out[(dist_ - 1 - s) % n] = cur
    return out.reshape(-1)[: val.numel()].reshape(val.shape)


# ---------------------------------------------------------------------------
# all_to_all_tiles schedules
# ---------------------------------------------------------------------------
#
# Each takes ``x`` cut into ``ax.size`` equal tiles along ``split_axis``
# (checked by the engine) and returns the tiles addressed to this rank,
# concatenated along ``concat_axis`` in source-rank order.


@register_schedule("all_to_all_tiles", "native")
def _a2a_native(engine, x, ax, *, split_axis, concat_axis):
    # the library collective over the axis group
    tiles = x.chunk(ax.size, dim=split_axis)
    return torch.cat(_all_to_all(tiles, ax), dim=concat_axis)


@register_schedule("all_to_all_tiles", "chain")
def _a2a_chain(engine, x, ax, *, split_axis, concat_axis):
    # n-1 ring rounds (the paper's CSN schedule): the tile this rank owes
    # the rank d hops to its right, split index (idx + d) mod n, travels d
    # hops; round r moves every tile that still has hops to go, in one batch
    n, idx = ax.size, ax.index
    tiles = x.chunk(n, dim=split_axis)
    carry = {d: tiles[(idx + d) % n] for d in range(1, n)}
    for r in range(1, n):
        live = range(r, n)
        carry.update(zip(live, _ring_shift_all([carry[d] for d in live],
                                               ax, +1)))
    # carry[d] now holds the tile from source (idx - d) mod n
    by_src = [tiles[idx] if s == idx else carry[(idx - s) % n]
              for s in range(n)]
    return torch.cat(by_src, dim=concat_axis)


@register_schedule("all_to_all_tiles", "staged")
def _a2a_staged(engine, x, ax, *, split_axis, concat_axis):
    # every byte transits the staging domain (all_gather + local slice)
    chunk = x.shape[split_axis] // ax.size
    return torch.cat([g.narrow(split_axis, ax.index * chunk, chunk)
                      for g in _all_gather(x, ax)], dim=concat_axis)


# ---------------------------------------------------------------------------
# allreduce schedules
# ---------------------------------------------------------------------------
#
# Each takes ``axis`` as the caller gave it: a name or a tuple of names.
# ``native``, ``chain`` and ``staged`` reduce over a tuple as one flattened
# ring or group (the reference's ``axis_size(tuple)``); ``chain_rooted``,
# ``rs_ag``, ``ring2d`` and ``int8_ef`` make one pass per axis, in order.


def _axis_names(axis) -> Tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _fused_add(acc, recv):
    """acc += recv, in place on a row of a schedule's chunk stack: the
    per-hop ``ring_add_step`` for floating dtypes (reference
    ``engine.py:176-183``), the plain add otherwise. On the card the kernel
    takes fp32, bf16 and fp16 and refuses fp64, which the reference (JAX
    without x64) never holds."""
    if acc.is_floating_point():
        return fused_chunk_add(acc, recv, out=acc)
    return torch.add(acc, recv, out=acc)


@register_schedule("allreduce", "native")
def _allreduce_native(engine, x, axis):
    ax = engine._axis(axis)
    if ax.size == 1:
        return x
    return _all_reduce(x, ax)


@register_schedule("allreduce", "chain")
def _allreduce_chain(engine, x, axis):
    # ring reduce: n-1 full-payload hops, paper-style store-and-forward
    ax = engine._axis(axis)
    acc = buf = x
    for _ in range(ax.size - 1):
        buf = _ring_shift(buf, ax, +1)
        acc = acc + buf
    return acc


@register_schedule("allreduce", "chain_rooted")
def _allreduce_chain_rooted(engine, x, axis):
    # Dead-link allreduce: reduce along the open path to its head, then
    # chain-broadcast the total back. Path position 0 sits just past the
    # cut; backward shifts bring position p the payload of position p+r,
    # replaced by zeros whenever p+r walked off the path end (a
    # contribution that would have crossed the cut), so the head holds the
    # path-order sum. The return broadcast is the forward arm of the rooted
    # chain, leaving every rank with the head's total.
    for name in _axis_names(axis):
        ax = engine._axis(name)
        n = ax.size
        if n == 1:
            continue
        pos = (ax.index - (_cut_hop(engine, ax) + 1)) % n
        acc = buf = x
        for r in range(1, n):
            buf = _ring_shift(buf, ax, -1)
            acc = acc + (buf if pos + r <= n - 1 else torch.zeros_like(buf))
        x = acc
        for _ in range(n - 1):
            nxt = _ring_shift(x, ax, +1)
            if pos > 0:
                x = nxt
    return x


@register_schedule("allreduce", "staged")
def _allreduce_staged(engine, x, axis):
    # every byte transits the staging domain: all_gather, then a local sum
    ax = engine._axis(axis)
    if ax.size == 1:
        return x
    return torch.stack(_all_gather(x, ax)).sum(0, dtype=x.dtype)


@register_schedule("allreduce", "rs_ag")
def _allreduce_rs_ag(engine, x, axis):
    # bandwidth-optimal ring allreduce: reduce-scatter then all-gather,
    # 2(n-1)/n of the payload per link, one pass per torus dimension. The
    # per-hop accumulate is ring_add_step, into the chunk stack in place.
    for name in _axis_names(axis):
        ax = engine._axis(name)
        n, idx = ax.size, ax.index
        if n == 1:
            continue
        stack = _pack_chunks(x, n).clone()
        # reduce-scatter: step s sends chunk (idx-s) right and accumulates
        # the incoming chunk (idx-1-s); then rank i owns chunk (i+1) % n
        for s in range(n - 1):
            recv = _ring_shift(stack[(idx - s) % n], ax, +1)
            _fused_add(stack[(idx - 1 - s) % n], recv)
        # all-gather: circulate the owned chunk around the ring
        cur = stack[(idx + 1) % n]
        for s in range(n - 1):
            cur = _ring_shift(cur, ax, +1)
            stack[(idx - s) % n] = cur
        x = stack.reshape(-1)[: x.numel()].reshape(x.shape)
    return x


@register_schedule("allreduce", "ring2d")
def _allreduce_ring2d(engine, x, axis):
    # torus-aware row/column schedule: a ring reduce-scatter/all-gather per
    # torus dimension. For a single axis this is exactly rs_ag.
    return _allreduce_rs_ag(engine, x, axis)


@register_schedule("allreduce", "int8_ef")
def _allreduce_int8_ef(engine, x, axis):
    # int8 block-quantized wire over the rs_ag ring: every reduce-scatter
    # hop quantizes the outgoing partial-sum chunk and its requantization
    # residual and moves both (with their scales); the receiver adds payload
    # + residual into its fp32 chunk. The all-gather half quantizes each
    # owner's reduced chunk once and forwards the wire unchanged, and every
    # rank, the owner too, keeps the dequantized wire value, so all ranks
    # agree bit for bit. Exact whenever every hop's chunk is
    # block-representable. Error feedback across steps is the caller's
    # (compression.compressed_psum).
    for name in _axis_names(axis):
        ax = engine._axis(name)
        n, idx = ax.size, ax.index
        if n == 1:
            continue
        stack = _pack_chunks(x.float(), n).clone()
        shape, size = stack.shape[1:], stack.shape[1]
        for s in range(n - 1):
            wire = _ring_shift_all(quantize_ef(stack[(idx - s) % n]), ax)
            _fused_add(stack[(idx - 1 - s) % n],
                       dequantize_ef(*wire, shape, size))
        wire = quantize_ef(stack[(idx + 1) % n])
        stack[(idx + 1) % n] = dequantize_ef(*wire, shape, size)
        for s in range(n - 1):
            wire = _ring_shift_all(wire, ax)
            stack[(idx - s) % n] = dequantize_ef(*wire, shape, size)
        x = stack.reshape(-1)[: x.numel()].reshape(x.shape).to(x.dtype)
    return x


# ---------------------------------------------------------------------------
# ring_exchange schedules (b_eff)
# ---------------------------------------------------------------------------


@register_schedule("ring_exchange", "direct")
@register_schedule("ring_exchange", "chain")
def _exchange_direct(engine, x_fwd, x_bwd, ax):
    # one hop in each direction, both posted together (b_eff's message
    # pattern): the left neighbour's fwd buffer and the right neighbour's
    # bwd buffer. Per peer, sends and receives match in posting order, so
    # on a size-2 ring (left == right) fwd still lands in recv_l.
    if ax.size == 1:
        return x_fwd, x_bwd
    right = ax.global_rank(ax.index + 1)
    left = ax.global_rank(ax.index - 1)
    recv_l, recv_r = _post(ax, [(x_fwd, right), (x_bwd, left)],
                           [(x_fwd, left), (x_bwd, right)])
    return recv_l, recv_r


@register_schedule("ring_exchange", "staged")
def _exchange_staged(engine, x_fwd, x_bwd, ax):
    # both buffers transit the staging domain (all_gather + select)
    if ax.size == 1:
        return x_fwd, x_bwd
    all_f, all_b = _all_gather(x_fwd, ax), _all_gather(x_bwd, ax)
    return all_f[(ax.index - 1) % ax.size], all_b[(ax.index + 1) % ax.size]


# ---------------------------------------------------------------------------
# the data-movement exchanges under autograd
# ---------------------------------------------------------------------------
#
# The reference differentiates its exchanges through JAX's transpose rules
# inside ``shard_map``; here each is a ``torch.autograd.Function`` whose
# backward is one more exchange of the cotangent on the schedule the forward
# resolved (never resolved again, so every rank runs the same one), its
# staged bytes counted under the forward's callsite. The
# exchanges only move bytes, so gradients through them are exact. Autograd
# issues the backward exchanges in its graph order, on its device thread for
# CUDA tensors: every rank builds the same graph, so every rank issues them
# in the same order. Under ``remat`` the forward exchanges of a checkpointed
# layer run again inside the backward, as the reference recomputes them.


class _AllToAllTiles(torch.autograd.Function):
    """``all_to_all_tiles`` on schedule ``name``; backward: the exchange
    with ``split_axis`` and ``concat_axis`` swapped, its exact inverse."""

    @staticmethod
    def forward(ctx, x, engine, ax, name, split_axis, concat_axis, callsite):
        ctx.engine, ctx.ax, ctx.name = engine, ax, name
        ctx.split_axis, ctx.concat_axis = split_axis, concat_axis
        ctx.callsite = callsite
        return _REGISTRY["all_to_all_tiles"][name](
            engine, x, ax, split_axis=split_axis, concat_axis=concat_axis)

    @staticmethod
    def backward(ctx, g):
        with _tagged(ctx.callsite):
            gx = _REGISTRY["all_to_all_tiles"][ctx.name](
                ctx.engine, g.contiguous(), ctx.ax,
                split_axis=ctx.concat_axis, concat_axis=ctx.split_axis)
        return gx, None, None, None, None, None, None


class _RingExchange(torch.autograd.Function):
    """``ring_exchange`` on schedule ``name``. Rank r's ``recv_from_left``
    is rank r-1's ``x_fwd`` and its ``recv_from_right`` rank r+1's
    ``x_bwd``, so the backward sends the first cotangent back left and the
    second back right: one more exchange with the roles swapped."""

    @staticmethod
    def forward(ctx, x_fwd, x_bwd, engine, ax, name, callsite):
        ctx.engine, ctx.ax, ctx.name = engine, ax, name
        ctx.callsite = callsite
        return _REGISTRY["ring_exchange"][name](engine, x_fwd, x_bwd, ax)

    @staticmethod
    def backward(ctx, g_left, g_right):
        with _tagged(ctx.callsite):
            from_left, from_right = _REGISTRY["ring_exchange"][ctx.name](
                ctx.engine, g_right.contiguous(), g_left.contiguous(),
                ctx.ax)
        # from_right is rank r+1's g_left: the cotangent of what r sent it
        return from_right, from_left, None, None, None, None


# ---------------------------------------------------------------------------
# grid_transpose schedules (PTRANS partner exchange)
# ---------------------------------------------------------------------------


@register_schedule("grid_transpose", "direct")
@register_schedule("grid_transpose", "chain")
def _transpose_direct(engine, x, grid, pg):
    # point-to-point swap with the grid-transpose partner (c, r) (paper
    # §2.2.2); a diagonal rank is its own partner and keeps a local copy
    if pg == 1:
        return x
    r, c = divmod(grid.index, pg)
    if r == c:
        return x.clone()
    return _swap(x, grid, grid.global_rank(c * pg + r))


@register_schedule("grid_transpose", "staged")
def _transpose_staged(engine, x, grid, pg):
    # all_gather over the full grid + local selection: every block transits
    # the staging domain (paper §2.2.1 via PCIe+MPI)
    if pg == 1:
        return x
    r, c = divmod(grid.index, pg)
    return _all_gather(x, grid)[c * pg + r]


@register_schedule("grid_transpose", "ring2d")
def _transpose_ring2d(engine, x, grid, pg):
    # dimension-ordered two-phase torus route (paper Fig. 8): the block from
    # (r, c) reaches its partner (c, r) over row links only, then column
    # links only, relayed by the diagonal rank. Phase 1: ring all-gather
    # along the grid row (axis "cols"), so every rank holds its whole grid
    # row. Phase 2: the diagonal rank (c, c) chain-forwards its stack down
    # grid column c (axis "rows"); rank (r, c) keeps the block of (c, r).
    if pg == 1:
        return x
    r, c = divmod(grid.index, pg)
    row_ax, col_ax = (engine.mesh.axis(name) for name in grid.name)
    stack = x.new_empty((pg,) + tuple(x.shape))
    stack[c] = x
    cur = x
    for s in range(pg - 1):
        cur = _ring_shift(cur, col_ax, +1)  # now from column (c - 1 - s)
        stack[(c - 1 - s) % pg] = cur
    out = stack
    for _ in range(pg - 1):
        nxt = _ring_shift(out, row_ax, +1)
        if r != c:
            out = nxt
    return out[r]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CollectiveEngine:
    """Selects one registered schedule per collective op.

    ``comm``      the paper's Fig. 1 backend selector. ``HOST_STAGED`` forces
                  the ``staged`` schedule for every op.
    ``schedule``  a registered schedule name, or ``"auto"`` to resolve per
                  callsite through the cost model
                  (:mod:`repro_torch.comm.autotune`) from the payload size
                  and the axis topology. Without topology or payload auto
                  falls back to the static per-op defaults. A name
                  registered for some ops only resolves like auto for the
                  others.
    ``topology``  the :class:`MeshTopology` of ``mesh``, for cost-model
                  resolution and provenance (``describe()``).
    ``mesh``      the :class:`repro_torch.launch.mesh.ProcessMesh` whose
                  axis groups the schedules communicate over.
    ``cost_model`` an explicit :class:`repro_torch.comm.autotune.CostModel`;
                  None uses the process-wide default (analytic on the H100
                  model, plus ``results/tuning_torch.json`` when one was
                  measured for this backend).
    """
    comm: CommunicationType = CommunicationType.ICI_DIRECT
    schedule: str = "auto"
    topology: Optional[MeshTopology] = None
    mesh: Optional[object] = None
    cost_model: Optional[object] = None

    def __post_init__(self):
        object.__setattr__(self, "comm", comm_type(self.comm))
        if self.schedule != "auto" and self.schedule not in known_schedules():
            raise UnknownScheduleError(
                f"unknown schedule {self.schedule!r}; registered schedules "
                f"are {sorted(known_schedules())}")

    @classmethod
    def for_mesh(cls, mesh, comm=CommunicationType.ICI_DIRECT,
                 schedule: str = "auto", **kw) -> "CollectiveEngine":
        return cls(comm=comm_type(comm), schedule=schedule,
                   topology=MeshTopology.from_mesh(mesh), mesh=mesh, **kw)

    # -- schedule resolution ------------------------------------------------

    def schedule_for(self, op: str, override: Optional[str] = None, *,
                     nbytes: Optional[int] = None, axis=None,
                     callsite: Optional[str] = None) -> str:
        """The schedule name this engine runs ``op`` with — always a
        registered name, never the literal ``"auto"``.

        With ``nbytes`` (message payload) and ``axis`` (an axis name or
        tuple), ``auto`` resolves through the cost model; without them it
        falls back to the static per-op default. ``callsite`` (a tag of
        :mod:`repro_torch.comm.callsites`, e.g. ``"hpl.panel"``) lets
        measured tuning-table entries for that call pattern win over the
        untagged op's.

        An explicit ``override`` must be registered for ``op``
        (:class:`UnknownScheduleError` otherwise — checked before the
        HOST_STAGED short-circuit so typos fail under every comm type);
        HOST_STAGED always resolves to ``"staged"``; an engine-wide name that
        does not cover ``op`` falls back to auto-resolution rather than
        erroring, so one engine can drive ops with disjoint schedule
        sets."""
        if op not in OPS:
            raise ValueError(f"unknown collective op {op!r}; ops are {OPS}")
        if override is not None and override != "auto" \
                and override not in _REGISTRY[op]:
            raise UnknownScheduleError(
                f"schedule {override!r} is not registered for op {op!r}; "
                f"available: {sorted(_REGISTRY[op])}")
        if self.comm is CommunicationType.HOST_STAGED:
            return "staged"
        name = override or self.schedule
        if name != "auto" and name in _REGISTRY[op]:
            return name
        # "auto", or an engine-wide name that doesn't cover this op
        return self._auto_choice(op, nbytes, axis, callsite)

    def _axes_for(self, axis) -> Optional[Tuple]:
        """The :class:`AxisTopology` of each name of ``axis``; None without
        an axis or a topology, or for a name the topology lacks."""
        if axis is None or self.topology is None:
            return None
        try:
            return tuple(self.topology.axis(a) for a in _axis_names(axis))
        except KeyError:
            return None

    def _model(self):
        if self.cost_model is not None:
            return self.cost_model
        return autotune.default_cost_model()

    def invalidate_resolutions(self, *, table=None, hw=None,
                               health=None) -> None:
        """Drop every memoized ``(op, nbytes, axis, callsite)`` resolution
        so the next ``schedule="auto"`` lookup re-prices.

        ``table`` optionally swaps a refreshed
        :class:`~repro_torch.comm.autotune.TuningTable` into the cost model
        first; ``hw`` swaps the :class:`~repro_torch.comm.types
        .HardwareModel` the analytic ranking prices on; ``health`` swaps the
        link-health mask (``(axis, hop)`` pairs that are hard down; pass
        ``frozenset()`` to declare every link healthy again), so resolution
        excludes any route crossing a down link. Mutates the engine's cost
        model — the process default when no explicit ``cost_model`` was
        given — never the frozen engine."""
        model = self._model()
        if table is not None:
            model.table = table
        if hw is not None:
            model.hw = hw
        if health is not None:
            model.health = frozenset(health)
        model._cache.clear()

    def _auto_choice(self, op: str, nbytes: Optional[int], axis,
                     callsite: Optional[str] = None) -> str:
        """Cost-model resolution; static default when the model has nothing
        to price (no topology / payload / unknown axis)."""
        axes = self._axes_for(axis)
        if nbytes is None or axes is None:
            return _AUTO[op]
        choice = self._model().choose(op, int(nbytes), axes,
                                      callsite=callsite)
        if choice is not None and choice in _REGISTRY[op]:
            return choice
        return _AUTO[op]

    def _axis(self, axis):
        """The :class:`MeshAxis` of ``axis``: a name, or the tuple of both
        torus axes for the flattened grid."""
        if self.mesh is None:
            raise ValueError("the engine has no mesh to communicate over; "
                             "build it with CollectiveEngine.for_mesh")
        if isinstance(axis, (tuple, list)) and len(axis) == 1:
            axis = axis[0]
        return self.mesh.axis(axis)  # raises KeyError with the known axes

    def _check_axis(self, axis) -> None:
        """Raise KeyError unless every name of ``axis`` is a mesh axis."""
        for name in _axis_names(axis):
            self._axis(name)

    def pipeline_chunks(self, op: str, *, nbytes: Optional[int] = None,
                        axis=None, schedule: Optional[str] = None,
                        callsite: Optional[str] = None) -> int:
        """The chunk count ``pipelined`` resolves ``nchunks="auto"`` to:
        :func:`repro_torch.comm.autotune.best_nchunks` on the resolved
        schedule's hop/wire decomposition — pipeline fill cost against
        per-chunk latency. 1 (monolithic) when the model has nothing to
        price. The schedule is resolved all the same, so an unknown op or
        schedule raises here as it will in the exchange."""
        name = self.schedule_for(op, schedule, nbytes=nbytes, axis=axis,
                                 callsite=callsite)
        axes = self._axes_for(axis)
        if nbytes is None or axes is None:
            return 1
        return self._model().best_nchunks(op, name, int(nbytes), axes)[0]

    # -- ops -----------------------------------------------------------------

    def bcast(self, val: torch.Tensor, axis: str, src: int, *,
              schedule: Optional[str] = None,
              callsite: Optional[str] = None) -> torch.Tensor:
        """Broadcast ``val`` from index ``src`` of ``axis`` to every rank of
        the axis. Every rank passes a tensor of the same shape and dtype;
        only the source's contents matter."""
        ax = self._axis(axis)
        name = self.schedule_for("bcast", schedule,
                                 nbytes=val.numel() * val.element_size(),
                                 axis=axis, callsite=callsite)
        with _tagged(callsite):
            return _REGISTRY["bcast"][name](self, val, ax, int(src))

    def all_to_all_tiles(self, x: torch.Tensor, axis, *, split_axis: int,
                         concat_axis: int, schedule: Optional[str] = None,
                         callsite: Optional[str] = None) -> torch.Tensor:
        """Exchange tiles so rank i's j-th split lands on rank j, ordered by
        source rank on ``concat_axis`` (the tiled ``lax.all_to_all``).

        ``x`` is cut into ``axis``-size equal tiles along ``split_axis``
        (:class:`ValueError` if it does not divide); the output
        concatenates the tiles received from indices 0..n-1 along
        ``concat_axis``, so the exchange with the two axes swapped is its
        exact inverse. Every rank passes a tensor of one shape and dtype.
        On a size-1 axis every schedule returns ``x``. Differentiable
        (:class:`_AllToAllTiles`): the backward is that inverse exchange of
        the cotangent."""
        ax = self._axis(axis)
        name = self.schedule_for("all_to_all_tiles", schedule,
                                 nbytes=x.numel() * x.element_size(),
                                 axis=axis, callsite=callsite)
        split_axis, concat_axis = split_axis % x.ndim, concat_axis % x.ndim
        if x.shape[split_axis] % ax.size:
            raise ValueError(
                f"all_to_all_tiles: axis {split_axis} of size "
                f"{x.shape[split_axis]} does not split into {ax.size} tiles")
        if ax.size == 1:
            return x
        with _tagged(callsite):
            return _AllToAllTiles.apply(x, self, ax, name, split_axis,
                                        concat_axis, callsite)

    def allreduce(self, x: torch.Tensor, axis, *,
                  schedule: Optional[str] = None,
                  callsite: Optional[str] = None) -> torch.Tensor:
        """Sum ``x`` over all ranks of ``axis`` (a name or a tuple of
        names). Every rank passes a tensor of one shape and dtype."""
        self._check_axis(axis)
        name = self.schedule_for("allreduce", schedule,
                                 nbytes=x.numel() * x.element_size(),
                                 axis=axis, callsite=callsite)
        with _tagged(callsite):
            return _REGISTRY["allreduce"][name](self, x, axis)

    def all_gather(self, x: torch.Tensor, axis, *,
                   callsite: Optional[str] = None) -> list:
        """Every rank's ``x`` over ``axis`` (a name or a tuple of names),
        in axis-index order: the library's all-gather, the one (native)
        path, which no schedule resolves. Every rank passes a tensor of one
        shape and dtype; on a size-1 axis it returns ``[x]``."""
        ax = self._axis(axis)
        if ax.size == 1:
            return [x]
        with _tagged(callsite):
            return _all_gather(x, ax)

    def bucket_bytes_for(self, axis) -> int:
        """Model-derived bucket size for :meth:`allreduce_tree` over
        ``axis``: pipeline depth x ring hops x per-hop latency-bandwidth
        product (:func:`repro_torch.comm.autotune.derive_bucket_bytes`) on
        the cost model's hardware; ``DEFAULT_BUCKET_BYTES`` (the former
        fixed 32 MiB) without a topology. Raises KeyError for an axis the
        mesh lacks."""
        if self.topology is None:
            self._check_axis(axis)
            return DEFAULT_BUCKET_BYTES
        axes = tuple(self.topology.axis(a) for a in _axis_names(axis))
        return autotune.derive_bucket_bytes(axes, self._model().hw)

    def allreduce_tree(self, tree, axis, *, bucket_bytes: Optional[int] = None,
                       schedule: Optional[str] = None,
                       callsite: Optional[str] = None):
        """Sum a tree of tensors over ``axis`` in ~``bucket_bytes`` buckets.

        Leaves (in ``jax.tree`` order: dict keys sorted) are packed greedily
        in order (:func:`pack_buckets`); each bucket's same-dtype leaves are
        flattened into one payload, concatenated in leaf order, and reduced
        by the allreduce schedule. Zero-size leaves pass through untouched.
        ``bucket_bytes=None`` takes :meth:`bucket_bytes_for`. Returns a new
        tree of the same structure."""
        self._check_axis(axis)
        if bucket_bytes is None:
            bucket_bytes = self.bucket_bytes_for(axis)
        leaves, spec = tree_flatten(tree)
        out = list(leaves)
        for bucket in pack_buckets(leaves, bucket_bytes):
            groups: Dict = {}
            for i in bucket:
                if leaves[i].numel():
                    groups.setdefault(leaves[i].dtype, []).append(i)
            for idxs in groups.values():
                flat = torch.cat([leaves[i].reshape(-1) for i in idxs])
                red = self.allreduce(flat, axis, schedule=schedule,
                                     callsite=callsite)
                off = 0
                for i in idxs:
                    n = leaves[i].numel()
                    out[i] = red[off:off + n].reshape(leaves[i].shape)
                    off += n
        return tree_unflatten(spec, out)

    def ring_exchange(self, x_fwd: torch.Tensor, x_bwd: torch.Tensor,
                      axis: str, *, schedule: Optional[str] = None,
                      callsite: Optional[str] = None):
        """Bidirectional neighbour exchange (b_eff pattern): every rank
        sends ``x_fwd`` to index +1 and ``x_bwd`` to index -1 of ``axis``.
        Returns ``(recv_from_left, recv_from_right)``. Differentiable
        (:class:`_RingExchange`): the cotangents travel back the way the
        payloads came."""
        ax = self._axis(axis)
        name = self.schedule_for("ring_exchange", schedule,
                                 nbytes=x_fwd.numel() * x_fwd.element_size(),
                                 axis=axis, callsite=callsite)
        if ax.size == 1:
            return x_fwd, x_bwd
        with _tagged(callsite):
            return _RingExchange.apply(x_fwd, x_bwd, self, ax, name,
                                       callsite)

    def grid_transpose(self, x: torch.Tensor, axes, pg: int, *,
                       schedule: Optional[str] = None,
                       callsite: Optional[str] = None) -> torch.Tensor:
        """Exchange with the (r, c) <-> (c, r) partner on the ``pg x pg``
        torus flattened over ``axes`` (``("rows", "cols")``; PTRANS
        §2.2.2). Every rank passes a tensor of one shape and dtype."""
        grid = self._axis(tuple(axes))
        if grid.size != pg * pg:
            raise ValueError(f"grid of {grid.size} ranks is not {pg}x{pg}")
        name = self.schedule_for("grid_transpose", schedule,
                                 nbytes=x.numel() * x.element_size(),
                                 axis=tuple(axes), callsite=callsite)
        with _tagged(callsite):
            return _REGISTRY["grid_transpose"][name](self, x, grid, int(pg))

    # -- pipelined transform ------------------------------------------------

    def pipelined(self, op: str, x: torch.Tensor, axis, *, nchunks="auto",
                  split_axis: int = 0, concat_axis: Optional[int] = None,
                  consume: Optional[Callable] = None,
                  schedule: Optional[str] = None,
                  callsite: Optional[str] = None, **opkw) -> torch.Tensor:
        """Software-pipeline a single-payload collective (reference
        ``engine.py:903-1000``).

        ``x`` is split into ``nchunks`` near-equal strips along
        ``split_axis``; each strip goes through ``op`` on its own, and
        ``consume(strip_out, start)`` (if given) is applied to each strip as
        it lands. The results are concatenated along ``concat_axis``
        (default ``split_axis``). ``nchunks`` is clamped to the strips
        available; ``"auto"`` resolves through :meth:`pipeline_chunks`.
        For bcast and grid_transpose every chunking equals the monolithic
        op bit for bit, since chunk boundaries only partition the payload;
        an allreduce strip sums each element over the same ranks, so on
        integer-valued payloads every chunking is exact too (with floats a
        ring schedule's chunk layout, and so its order of additions, moves
        with the strips). For ``all_to_all_tiles`` the strip axis rides
        through the exchange unchanged, so every chunking equals the
        monolithic exchange bit for bit. The schedule is resolved once, at
        the full payload.

        Extra operands ride ``opkw``: ``src=`` for bcast, ``pg=`` for
        grid_transpose, ``tile_split_axis=`` and ``tile_concat_axis=`` for
        all_to_all_tiles (the exchange's tile axes; the strip axis must be
        a third axis, else :class:`ValueError`)."""
        supported = ("bcast", "allreduce", "grid_transpose",
                     "all_to_all_tiles")
        if op not in supported:
            raise ValueError(f"pipelined supports single-payload ops "
                             f"{supported}, got {op!r}")
        required = {"bcast": ("src",), "grid_transpose": ("pg",),
                    "all_to_all_tiles": ("tile_split_axis",
                                         "tile_concat_axis")}.get(op, ())
        for name in required:
            if name not in opkw:
                raise ValueError(f"pipelined({op!r}) requires the {name}= "
                                 "operand")
        if op == "all_to_all_tiles":
            tiles = {int(opkw["tile_split_axis"]) % x.ndim,
                     int(opkw["tile_concat_axis"]) % x.ndim}
            if int(split_axis) % x.ndim in tiles:
                raise ValueError(
                    "pipelined('all_to_all_tiles') strip split_axis "
                    f"{split_axis} collides with a tile axis {sorted(tiles)}; "
                    "strips must partition an axis the exchange leaves alone")
        size = x.shape[split_axis]
        nbytes = x.numel() * x.element_size()
        if nchunks == "auto":
            nchunks = self.pipeline_chunks(op, nbytes=nbytes, axis=axis,
                                           schedule=schedule,
                                           callsite=callsite)
        resolved = self.schedule_for(op, schedule, nbytes=nbytes, axis=axis,
                                     callsite=callsite)
        s = max(min(int(nchunks), size), 1)
        base, extra = divmod(size, s)
        outs, start = [], 0
        for i in range(s):
            stop = start + base + (1 if i < extra else 0)
            strip = x.narrow(split_axis, start, stop - start)
            if op == "bcast":
                out = self.bcast(strip, axis, opkw["src"], schedule=resolved,
                                 callsite=callsite)
            elif op == "allreduce":
                out = self.allreduce(strip, axis, schedule=resolved,
                                     callsite=callsite)
            elif op == "all_to_all_tiles":
                out = self.all_to_all_tiles(
                    strip, axis, split_axis=opkw["tile_split_axis"],
                    concat_axis=opkw["tile_concat_axis"], schedule=resolved,
                    callsite=callsite)
            else:
                out = self.grid_transpose(strip, axis, opkw["pg"],
                                          schedule=resolved,
                                          callsite=callsite)
            if consume is not None:
                out = consume(out, start)
            outs.append(out)
            start = stop
        if len(outs) == 1:
            return outs[0]
        cat = split_axis if concat_axis is None else concat_axis
        return torch.cat(outs, dim=cat)

    # -- provenance ---------------------------------------------------------

    def describe(self) -> Dict[str, object]:
        """Static record of what this engine runs, for benchmark results."""
        d = {
            "comm": self.comm.value,
            "schedule": self.schedule,
            # static (payload-free) resolution; callsites with a payload may
            # refine these through the cost model — benchmarks record the
            # per-callsite resolved name in their own results
            "resolved": {op: self.schedule_for(op) for op in OPS},
        }
        if self.schedule == "auto" \
                and self.comm is not CommunicationType.HOST_STAGED:
            d["auto_resolver"] = ("cost_model" if self.topology is not None
                                  else "static")
        if self.topology is not None:
            d["topology"] = self.topology.describe()
        return d
