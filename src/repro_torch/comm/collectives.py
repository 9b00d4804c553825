"""Distributed primitives: a thin compatibility layer over the engine.

Port of ``repro/comm/collectives.py``. The schedules live in
:mod:`repro_torch.comm.engine`, selected through
:class:`~repro_torch.comm.engine.CollectiveEngine`; these keyword functions
keep the reference's ad-hoc ``(comm, schedule)`` signatures for external
callers. Where the reference reads the axis from its enclosing
``shard_map``, each function here takes the rank's
:class:`~repro_torch.launch.mesh.ProcessMesh` as the keyword ``mesh``.
"""
from __future__ import annotations

import torch

from repro_torch.comm.engine import CollectiveEngine, _ring_shift
from repro_torch.comm.types import CommunicationType, comm_type


def axis_index(axis: str, *, mesh) -> int:
    return mesh.index(axis)


def _engine(mesh, comm, schedule: str) -> CollectiveEngine:
    return CollectiveEngine.for_mesh(mesh, comm_type(comm), schedule)


def ring_shift(x: torch.Tensor, axis: str, shift: int = 1, *,
               mesh) -> torch.Tensor:
    """Send ``x`` to the neighbour ``shift`` hops along the ring; receive
    the buffer from the opposite neighbour. One hop."""
    ax = mesh.axis(axis)
    return x if ax.size == 1 else _ring_shift(x, ax, shift)


def ring_exchange_bidir(x_fwd: torch.Tensor, x_bwd: torch.Tensor, axis: str,
                        comm=CommunicationType.ICI_DIRECT, *, mesh):
    """Bidirectional neighbour exchange (the b_eff message pattern).
    Returns (recv_from_left, recv_from_right)."""
    return _engine(mesh, comm, "auto").ring_exchange(x_fwd, x_bwd, axis)


def ring_bcast(val: torch.Tensor, axis: str, src: int,
               comm=CommunicationType.ICI_DIRECT, schedule: str = "chain", *,
               mesh) -> torch.Tensor:
    """Broadcast ``val`` from index ``src`` along ``axis`` with the named
    schedule."""
    return _engine(mesh, comm, schedule).bcast(val, axis, src)


def all_to_all_tiles(x: torch.Tensor, axis: str, *, split_axis: int,
                     concat_axis: int, comm=CommunicationType.ICI_DIRECT,
                     schedule: str = "native", mesh) -> torch.Tensor:
    """Exchange tiles so rank i's j-th split lands on rank j, concatenated
    along ``concat_axis`` in source-rank order."""
    return _engine(mesh, comm, schedule).all_to_all_tiles(
        x, axis, split_axis=split_axis, concat_axis=concat_axis)


def roll_with_axis(x: torch.Tensor, shift, axis: int) -> torch.Tensor:
    """``x`` rolled by ``shift`` along ``axis``: out[i] = x[(i - shift) % n],
    as the reference's ``jnp.take`` with a traced shift."""
    n = x.shape[axis]
    idx = (torch.arange(n, device=x.device) - int(shift)) % n
    return x.index_select(axis, idx)


def psum_schedule(x: torch.Tensor, axis, comm=CommunicationType.ICI_DIRECT,
                  schedule: str = "native", *, mesh) -> torch.Tensor:
    """Allreduce over ``axis`` with the named schedule."""
    return _engine(mesh, comm, schedule).allreduce(x, axis)
