"""Topology helpers: rings and 2-D tori over mesh axes, PQ block ownership.

Port of ``repro/comm/topology.py``. These mirror the paper's network setups:
the b_eff ring, the PTRANS P=Q pair grid and the HPL 2-D torus (paper
Figs. 2, 3, 8). Here the axes are those of a
:class:`repro_torch.launch.mesh.ProcessMesh` of ``torch.distributed`` ranks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class AxisTopology:
    """Static description of one mesh axis as a communication domain.

    ``kind`` is one of:
      ``ring``      — 1-D wraparound ring (b_eff, DP gradient rings)
      ``torus_row`` / ``torus_col`` — one dimension of a 2-D torus (HPL,
                      PTRANS row/column broadcasts)
      ``staging``   — a host-staged domain (the paper's PCIe+MPI network);
                      schedules over it must route every byte through the
                      staging implementation.
    """
    name: str
    size: int
    kind: str = "ring"

    @property
    def wraparound(self) -> bool:
        return self.kind != "staging"

    def perm(self, shift: int = 1) -> List[Tuple[int, int]]:
        return ring_perm(self.size, shift)

    def links(self) -> Tuple[Tuple[str, int], ...]:
        """Every physical link of this axis as ``(name, hop)`` ids — hop
        ``h`` is the bidirectional wire between ranks ``h`` and
        ``h+1 mod size``. A staging axis reports none. On a size-2 ring hops
        0 and 1 are the same wire, so only the canonical hop 0 is reported
        (:meth:`canonical_hop`)."""
        if self.kind == "staging":
            return ()
        return tuple((self.name, h) for h in range(self.n_links))

    @property
    def n_links(self) -> int:
        """Distinct physical wires on this axis (0 for staging domains)."""
        if self.kind == "staging":
            return 0
        return 1 if self.size == 2 else self.size

    def canonical_hop(self, hop: int) -> int:
        """The canonical link id for ``hop`` — on a size-2 axis both hop
        names collapse onto the single wire's id 0."""
        if self.size == 2:
            return 0
        return hop


@dataclass(frozen=True)
class MeshTopology:
    """Topology metadata for every axis of a mesh, keyed by axis name."""
    axes: Tuple[AxisTopology, ...]

    @classmethod
    def from_mesh(cls, mesh, kinds: Optional[Dict[str, str]] = None
                  ) -> "MeshTopology":
        """Derive topology from a :class:`ProcessMesh` (anything with a
        ``shape`` mapping of axis name to size). ``kinds`` overrides the
        per-axis classification; defaults: a lone axis is a ring,
        ('rows','cols') are the 2-D torus dimensions, 'pod' is a staging
        domain."""
        kinds = kinds or {}
        default = {"rows": "torus_row", "cols": "torus_col", "pod": "staging"}
        axes = []
        for name, size in mesh.shape.items():
            kind = kinds.get(name, default.get(name, "ring"))
            axes.append(AxisTopology(name=name, size=int(size), kind=kind))
        return cls(axes=tuple(axes))

    def axis(self, name: str) -> AxisTopology:
        for ax in self.axes:
            if ax.name == name:
                return ax
        raise KeyError(
            f"axis {name!r} not in topology "
            f"(have {[a.name for a in self.axes]})")

    def names(self) -> Tuple[str, ...]:
        return tuple(a.name for a in self.axes)

    def size(self, axis) -> int:
        """Total ranks along ``axis`` (a name or tuple of names)."""
        if isinstance(axis, (tuple, list)):
            n = 1
            for a in axis:
                n *= self.axis(a).size
            return n
        return self.axis(axis).size

    def describe(self) -> Dict[str, str]:
        return {a.name: f"{a.kind}[{a.size}]" for a in self.axes}


def ring_perm(size: int, shift: int = 1) -> List[Tuple[int, int]]:
    """(source, dest) pairs for a ring shift by ``shift``."""
    return [(i, (i + shift) % size) for i in range(size)]


def transpose_perm(p: int) -> List[Tuple[int, int]]:
    """Pair (r, c) <-> (c, r) on a p x p grid flattened row-major —
    the PTRANS partner exchange (paper §2.2.2, P = Q required)."""
    return [(r * p + c, c * p + r) for r in range(p) for c in range(p)]


def torus_neighbors(p: int, q: int) -> dict:
    """Neighbor permutations for a p x q torus flattened row-major:
    right/left along rows, down/up along columns (paper Fig. 8 directions)."""
    def flat(r, c):
        return r * q + c
    return {
        "right": [(flat(r, c), flat(r, (c + 1) % q)) for r in range(p) for c in range(q)],
        "left": [(flat(r, c), flat(r, (c - 1) % q)) for r in range(p) for c in range(q)],
        "down": [(flat(r, c), flat((r + 1) % p, c)) for r in range(p) for c in range(q)],
        "up": [(flat(r, c), flat((r - 1) % p, c)) for r in range(p) for c in range(q)],
    }


def pq_owner(block_i: int, block_j: int, p: int, q: int) -> Tuple[int, int]:
    """Block-cyclic PQ ownership (paper Fig. 3): block (i, j) lives on grid
    coordinate (i mod P, j mod Q)."""
    return block_i % p, block_j % q


def local_block_count(nblocks: int, p: int) -> int:
    """Blocks per grid row/col under block-cyclic distribution."""
    if nblocks % p:
        raise ValueError(f"nblocks={nblocks} not divisible by grid dim {p}")
    return nblocks // p


def grid_from_devices(n_devices: int, *, square: bool = False
                      ) -> Tuple[int, int]:
    """Most-square P x Q factorization of ``n_devices`` (P <= Q, P*Q == n).

    ``square=True`` enforces the P = Q contract of the circuit-switched
    PTRANS/HPL path and raises :class:`ValueError` for non-square counts
    instead of returning a rectangle (e.g. 8 -> 2 x 4)."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    p = math.isqrt(n_devices)
    if square:
        if p * p != n_devices:
            raise ValueError(
                f"{n_devices} devices do not form a P=Q square grid "
                f"(nearest squares: {p * p}, {(p + 1) ** 2}); the "
                "circuit-switched PTRANS/HPL path requires P = Q")
        return p, p
    while p > 1 and n_devices % p:
        p -= 1
    return p, n_devices // p
