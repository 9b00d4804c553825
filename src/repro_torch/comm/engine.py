"""Collective engine: named communication schedules behind one API.

Port of ``repro/comm/engine.py`` (registry ``:95-145``, bcast schedules
``:191-289``, ring_exchange ``:510-528``, grid_transpose ``:536-588``,
``CollectiveEngine`` ``:597-1000``). Every collective op has
named implementations ("schedules") registered against it, and a
:class:`CollectiveEngine` selects one per op from ``(CommunicationType,
schedule name)``. Callers hold an engine and never branch on comm or
schedule themselves.

Where the reference runs inside ``shard_map`` and hops with ``ppermute``,
the port runs in one process per rank (:mod:`repro_torch.launch.mesh`) and
each ring hop is an ``isend``/``irecv`` pair to the axis neighbours, posted
together with ``batch_isend_irecv`` and then awaited. Every schedule moves
bytes only (no arithmetic on the payload), so all of them deliver the same
bits. On a size-1 axis every schedule is the identity and touches no
process group.

Ported so far: ``bcast`` with ``chain``, ``native``, ``staged``, ``ring2d``
and ``chain_rooted``; ``ring_exchange`` with ``direct``/``chain`` and
``staged``; ``grid_transpose`` with ``direct``/``chain``, ``staged`` and
``ring2d``, over the flattened torus (``ProcessMesh.grid``); and
``pipelined`` for ``bcast`` and ``grid_transpose``. The other ops raise
:class:`NotImplementedError` naming the ROADMAP item that ports them. Until
the cost model is ported (ROADMAP A8), ``auto`` resolves to the static
per-op default and ``nchunks="auto"`` to 1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.comm.topology import MeshTopology
from repro_torch.comm.types import CommunicationType, comm_type

OPS: Tuple[str, ...] = ("bcast", "all_to_all_tiles", "allreduce",
                        "ring_exchange", "grid_transpose")

_REGISTRY: Dict[str, Dict[str, Callable]] = {op: {} for op in OPS}

# static per-op defaults for schedule="auto" (the reference's fallbacks when
# its cost model has nothing to price; the port's only resolution until A8)
_AUTO = {
    "bcast": "chain",
    "all_to_all_tiles": "native",
    "allreduce": "native",
    "ring_exchange": "direct",
    "grid_transpose": "direct",
}

# the ROADMAP item that ports each op still missing
_PORTED_BY = {
    "all_to_all_tiles": "A10 (routed RandomAccess) and A11 (MoE)",
    "allreduce": "A7 (allreduce family)",
}


def _not_ported(op: str) -> NotImplementedError:
    return NotImplementedError(
        f"collective {op!r} is not ported yet: ROADMAP {_PORTED_BY[op]}")


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


def _ring_shift(x: torch.Tensor, ax, shift: int = 1) -> torch.Tensor:
    """Every rank of axis ``ax`` sends ``x`` to index ``+shift`` and returns
    what index ``-shift`` sent: one hop of the ring."""
    x = x.contiguous()
    recv = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, ax.global_rank(ax.index + shift),
                      group=ax.group),
           dist.P2POp(dist.irecv, recv, ax.global_rank(ax.index - shift),
                      group=ax.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def _swap(x: torch.Tensor, ax, peer: int) -> torch.Tensor:
    """Send ``x`` to global rank ``peer`` and return what it sent back."""
    x = x.contiguous()
    recv = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, peer, group=ax.group),
           dist.P2POp(dist.irecv, recv, peer, group=ax.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


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
    out = val.contiguous().clone()
    dist.broadcast(out, src=ax.global_rank(src), group=ax.group)
    return out


@register_schedule("bcast", "staged")
def _bcast_staged(engine, val, ax, src):
    # all_gather + select: every byte transits the staging domain (the
    # route HOST_STAGED forces)
    if ax.size == 1:
        return val
    val = val.contiguous()
    allv = [torch.empty_like(val) for _ in range(ax.size)]
    dist.all_gather(allv, val, group=ax.group)
    return allv[src]


def _cut_hop(engine, ax) -> int:
    """The hop the rooted chain must not cross. Until the cost model's
    health mask is ported (ROADMAP A8) no link is known to be down, so it is
    the wraparound hop ``n-1``, as in the reference on a clean ring."""
    return ax.size - 1


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
    x_fwd, x_bwd = x_fwd.contiguous(), x_bwd.contiguous()
    recv_l, recv_r = torch.empty_like(x_fwd), torch.empty_like(x_bwd)
    right = ax.global_rank(ax.index + 1)
    left = ax.global_rank(ax.index - 1)
    ops = [dist.P2POp(dist.isend, x_fwd, right, group=ax.group),
           dist.P2POp(dist.irecv, recv_l, left, group=ax.group),
           dist.P2POp(dist.isend, x_bwd, left, group=ax.group),
           dist.P2POp(dist.irecv, recv_r, right, group=ax.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv_l, recv_r


@register_schedule("ring_exchange", "staged")
def _exchange_staged(engine, x_fwd, x_bwd, ax):
    # both buffers transit the staging domain (all_gather + select)
    if ax.size == 1:
        return x_fwd, x_bwd
    x_fwd, x_bwd = x_fwd.contiguous(), x_bwd.contiguous()
    all_f = [torch.empty_like(x_fwd) for _ in range(ax.size)]
    all_b = [torch.empty_like(x_bwd) for _ in range(ax.size)]
    dist.all_gather(all_f, x_fwd, group=ax.group)
    dist.all_gather(all_b, x_bwd, group=ax.group)
    return all_f[(ax.index - 1) % ax.size], all_b[(ax.index + 1) % ax.size]


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
    x = x.contiguous()
    allx = [torch.empty_like(x) for _ in range(grid.size)]
    dist.all_gather(allx, x, group=grid.group)
    return allx[c * pg + r]


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
    ``schedule``  a registered schedule name, or ``"auto"``. Until the cost
                  model is ported (ROADMAP A8) ``auto`` resolves to the
                  static per-op default (``chain`` for bcast). A name
                  registered for some ops only resolves like auto for the
                  others.
    ``topology``  the :class:`MeshTopology` of ``mesh``, for provenance
                  (``describe()``) and, with A8, the cost model.
    ``mesh``      the :class:`repro_torch.launch.mesh.ProcessMesh` whose
                  axis groups the schedules communicate over.
    """
    comm: CommunicationType = CommunicationType.ICI_DIRECT
    schedule: str = "auto"
    topology: Optional[MeshTopology] = None
    mesh: Optional[object] = None

    def __post_init__(self):
        object.__setattr__(self, "comm", comm_type(self.comm))
        if self.schedule != "auto" and self.schedule not in known_schedules():
            raise UnknownScheduleError(
                f"unknown schedule {self.schedule!r}; registered schedules "
                f"are {sorted(known_schedules())}")

    @classmethod
    def for_mesh(cls, mesh, comm=CommunicationType.ICI_DIRECT,
                 schedule: str = "auto") -> "CollectiveEngine":
        return cls(comm=comm_type(comm), schedule=schedule,
                   topology=MeshTopology.from_mesh(mesh), mesh=mesh)

    # -- schedule resolution ------------------------------------------------

    def schedule_for(self, op: str, override: Optional[str] = None, *,
                     nbytes: Optional[int] = None, axis=None,
                     callsite: Optional[str] = None) -> str:
        """The schedule name this engine runs ``op`` with — always a
        registered name, never the literal ``"auto"``.

        An explicit ``override`` must be registered for ``op``
        (:class:`UnknownScheduleError` otherwise — checked before the
        HOST_STAGED short-circuit so typos fail under every comm type);
        HOST_STAGED always resolves to ``"staged"``; an engine-wide name that
        does not cover ``op`` falls back to auto. ``nbytes``, ``axis`` and
        ``callsite`` are what the cost model will price on; they are
        accepted now so callers already pass them."""
        if op not in OPS:
            raise ValueError(f"unknown collective op {op!r}; ops are {OPS}")
        if not _REGISTRY[op]:
            raise _not_ported(op)
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
        return _AUTO[op]

    def _axis(self, axis):
        """The :class:`MeshAxis` of ``axis``: a name, or the tuple of both
        torus axes for the flattened grid."""
        if self.mesh is None:
            raise ValueError("the engine has no mesh to communicate over; "
                             "build it with CollectiveEngine.for_mesh")
        return self.mesh.axis(axis)  # raises KeyError with the known axes

    def pipeline_chunks(self, op: str, *, nbytes: Optional[int] = None,
                        axis=None, schedule: Optional[str] = None,
                        callsite: Optional[str] = None) -> int:
        """The chunk count ``pipelined`` resolves ``nchunks="auto"`` to: 1
        (monolithic), as the reference resolves it when its cost model has
        nothing to price, until ``best_nchunks`` is ported (ROADMAP A8).
        The schedule is resolved all the same, so an unported op or an
        unknown schedule raises here as it will in the exchange."""
        self.schedule_for(op, schedule, nbytes=nbytes, axis=axis,
                          callsite=callsite)
        return 1

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
        return _REGISTRY["bcast"][name](self, val, ax, int(src))

    def all_to_all_tiles(self, *args, **kw):
        raise _not_ported("all_to_all_tiles")

    def allreduce(self, *args, **kw):
        raise _not_ported("allreduce")

    def ring_exchange(self, x_fwd: torch.Tensor, x_bwd: torch.Tensor,
                      axis: str, *, schedule: Optional[str] = None,
                      callsite: Optional[str] = None):
        """Bidirectional neighbour exchange (b_eff pattern): every rank
        sends ``x_fwd`` to index +1 and ``x_bwd`` to index -1 of ``axis``.
        Returns ``(recv_from_left, recv_from_right)``."""
        ax = self._axis(axis)
        name = self.schedule_for("ring_exchange", schedule,
                                 nbytes=x_fwd.numel() * x_fwd.element_size(),
                                 axis=axis, callsite=callsite)
        return _REGISTRY["ring_exchange"][name](self, x_fwd, x_bwd, ax)

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
        Every chunking equals the monolithic op bit for bit, since chunk
        boundaries only partition the payload. The schedule is resolved
        once, at the full payload.

        Extra operands ride ``opkw``: ``src=`` for bcast, ``pg=`` for
        grid_transpose. ``allreduce`` and ``all_to_all_tiles`` arrive with
        their ops (ROADMAP A7, A10)."""
        if op in ("allreduce", "all_to_all_tiles"):
            raise NotImplementedError(
                f"pipelined({op!r}) is not ported yet: ROADMAP A7 "
                "(allreduce) and A10 (all_to_all_tiles)")
        supported = ("bcast", "grid_transpose")
        if op not in supported:
            raise ValueError(f"pipelined supports single-payload ops "
                             f"{supported}, got {op!r}")
        required = {"bcast": "src", "grid_transpose": "pg"}[op]
        if required not in opkw:
            raise ValueError(f"pipelined({op!r}) requires the {required}= "
                             "operand")
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
