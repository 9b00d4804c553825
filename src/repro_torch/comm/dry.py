"""The dry transport: the engine's branch for a mesh without processes.

The meta-device dry run (:mod:`repro_torch.launch.dryrun`) builds a cell's
step on the production mesh as rank 0 sees it, on tensors that hold no
data. Its mesh (:func:`repro_torch.launch.mesh.dry_mesh`) carries
:data:`DRY` on every axis wider than 1 in place of a process group. The
engine's transport helpers (``comm/engine.py``: ``_post``,
``_all_gather``, ``_all_to_all``, ``_broadcast``, ``_all_reduce``) take
their dry branch only on such an axis, never on a real group: it returns
meta tensors of the op's output shape and logs the op, its payload and
its wire bytes (the reference's convention: operand bytes times
:func:`repro_torch.roofline._wire_factor`) under the engine source (the
callsite tag) that moved them. Nothing is sent: the figures are counts,
not measurements.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from repro_torch.roofline import _wire_factor


class _DryGroup:
    """The marker a dry mesh's axes carry in place of a process group."""

    def __repr__(self) -> str:
        return "DRY"


DRY = _DryGroup()


@dataclass(frozen=True)
class DryOp:
    """One collective the dry transport stood in for, as rank 0 sees it."""
    op: str                  # the reference's HLO opcode
    source: Optional[str]    # the engine callsite tag, None if untagged
    ranks: int               # the axis size
    payload_bytes: int       # operand bytes (each send's, for a permute)
    wire_bytes: float        # payload_bytes x _wire_factor(op, ranks)


_LOG: List[DryOp] = []


def is_dry(ax) -> bool:
    """Whether ``ax`` is an axis of a dry mesh."""
    return getattr(ax, "group", None) is DRY


def record(op: str, ax, payload_bytes: int, source: Optional[str]) -> None:
    _LOG.append(DryOp(op, source, ax.size, int(payload_bytes),
                      payload_bytes * _wire_factor(op, ax.size)))


def ops() -> List[DryOp]:
    """Every op logged since the last :func:`reset`, in order."""
    return list(_LOG)


def reset() -> None:
    _LOG.clear()


def wire_by_source(log: Optional[List[DryOp]] = None) -> Dict[str, float]:
    """Wire bytes by engine source (``"untagged"`` for None)."""
    out: Dict[str, float] = {}
    for o in _LOG if log is None else log:
        key = o.source or "untagged"
        out[key] = out.get(key, 0.0) + o.wire_bytes
    return out


def meta_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")
