"""Sharding rules on the port's process mesh: the one-rank form.

Port of ``repro/sharding.py`` (``MeshRules`` :29, ``rules_for`` :40,
``make_shard_fn`` :96) over :class:`repro_torch.launch.mesh.ProcessMesh`.
On a mesh whose every axis has size 1 an activation constraint changes
nothing, so the shard function is the identity; like the reference's, it
carries ``.mesh`` and ``.rules``, which is what makes the model choose the
flash-attention path (``models/layers.py::_flash_sharded``). A mesh with an
axis of size > 1 raises: the GSPMD activation and parameter specs wait for
the GSPMD placement on several ranks (the rest of ROADMAP A12's second
half). The explicit tensor-, sequence- and data-parallel paths do not go
through here: their exchanges are engine calls
(:mod:`repro_torch.models.parallel`, :mod:`repro_torch.train.step`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch


@dataclass(frozen=True)
class MeshRules:
    dp: Tuple[str, ...]          # data-parallel mesh axes, e.g. ('pod', 'data')
    tp: Optional[str] = "model"  # tensor/expert-parallel axis


def rules_for(mesh) -> MeshRules:
    """The reference's data- and tensor-parallel axis roles for a mesh's
    axis names (its sequence-shard and FSDP options wait for the GSPMD
    placement, the rest of A12's second half)."""
    names = tuple(mesh.shape)
    dp = tuple(a for a in ("pod", "data") if a in names)
    if not dp:
        dp = (names[0],)
    if "model" in names:
        tp = "model"
    else:  # no named model axis: TP over the last axis not already used for DP
        spare = [a for a in names if a not in dp]
        tp = spare[-1] if spare else None
    return MeshRules(dp=dp, tp=tp)


def make_shard_fn(mesh, rules: MeshRules) -> Callable:
    """The activation-constraint callback threaded through the model: the
    identity on a one-rank mesh, carrying ``.mesh`` and ``.rules``."""
    wide = {name: size for name, size in mesh.shape.items() if size > 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide}: sharded activations and parameters are not "
            "ported yet (the GSPMD placement, the rest of ROADMAP A12's "
            "second half); use a one-rank mesh")

    def shard(x: torch.Tensor, name: str) -> torch.Tensor:
        return x

    shard.mesh = mesh
    shard.rules = rules
    return shard
