"""Process meshes: the port's stand-in for a JAX ``Mesh``.

Port of ``repro/launch/mesh.py`` (``make_local_mesh`` ``:24-33``, the
ring and torus ``:36-42``; ``make_production_mesh`` becomes
:func:`dry_mesh`, which has no processes). Where the reference names the
axes of a device mesh and runs one program over it with ``shard_map``, the
port runs one process per rank under ``torch.distributed`` and gives each
process a :class:`ProcessMesh`: the named axes, each with its size, this
rank's index on it and the process group of the ranks along it. Global rank ``g`` sits at
grid coordinate ``(g // pg, g % pg)`` of a ``pg x pg`` torus, the row-major
flattening the reference's ``P(("rows", "cols"))`` stack uses.

A torus also carries the flattened grid, :attr:`ProcessMesh.grid`: one
axis over every rank in row-major order (global rank ``r*pg + c``), which
the reference addresses as the tuple axis ``("rows", "cols")`` (PTRANS's
partner exchange).

:func:`make_mesh` (reference ``launch/mesh.py:21-22``) lays a rectangular
mesh of any shape over the world in the reference's row-major device
order: on a ``('data', 'model')`` mesh rank ``g`` sits at ``data = g //
n_model``, ``model = g % n_model``. Every axis carries its group, and so
does every run of two or more consecutive axes (:attr:`ProcessMesh.joint`),
which the reference addresses as a tuple axis (``('pod', 'data')``, the
data-parallel axes of a three-axis mesh).

Nothing here touches ``torch.distributed`` at import time. The single-rank
1x1 mesh needs no process group at all: every axis has size 1 and every
collective over it is the identity.
"""
from __future__ import annotations

import math
import os
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class MeshAxis:
    """One named axis as seen from this rank.

    ``ranks`` lists the global ranks along the axis in axis-index order;
    ``group`` is their process group (``None`` for a size-1 axis, which
    never communicates)."""
    name: object              # a str, or a tuple of names for the grid
    size: int
    index: int
    ranks: Tuple[int, ...]
    group: Optional[object] = None

    def global_rank(self, axis_index: int) -> int:
        return self.ranks[axis_index % self.size]


@dataclass(frozen=True)
class ProcessMesh:
    """The named axes of this rank's mesh. ``grid`` is the flattened torus
    (both axes, row-major), ``None`` on a mesh that is not a torus."""
    axes: Tuple[MeshAxis, ...]
    rank: int = 0
    grid: Optional[MeshAxis] = None
    joint: Tuple[MeshAxis, ...] = ()

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a.name for a in self.axes)

    @property
    def shape(self) -> Dict[str, int]:
        return {a.name: a.size for a in self.axes}

    def axis(self, name) -> MeshAxis:
        """The axis ``name``; a tuple of both torus axes, in mesh order,
        names the flattened grid."""
        if isinstance(name, (tuple, list)):
            name = tuple(name)
            if len(name) == 1:
                return self.axis(name[0])
            for ax in ((self.grid,) if self.grid is not None else ()) \
                    + self.joint:
                if ax.name == name:
                    return ax
            raise KeyError(f"axes {name!r} do not name the flattened torus "
                           f"or a joint axis of mesh {list(self.shape)}")
        for ax in self.axes:
            if ax.name == name:
                return ax
        raise KeyError(f"axis {name!r} not in mesh {list(self.shape)}")

    def index(self, name: str) -> int:
        return self.axis(name).index


def world() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process
    group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def single_rank_mesh(names: Sequence[str] = ("rows", "cols")) -> ProcessMesh:
    """The 1 x 1 (or size-1 ring) mesh of one process; no process group."""
    names = tuple(names)
    grid = MeshAxis(names, 1, 0, (0,)) if len(names) == 2 else None
    joint = tuple(MeshAxis(names[a:b], 1, 0, (0,))
                  for a in range(len(names))
                  for b in range(a + 2, len(names) + 1))
    return ProcessMesh(axes=tuple(MeshAxis(n, 1, 0, (0,)) for n in names),
                       grid=grid, joint=joint)


def _group(ranks):
    # every process must call new_group for every group, in the same order
    return dist.new_group(list(ranks)) if len(ranks) > 1 else None


def sub_ring_mesh(ranks: Sequence[int], name: str = "x"
                  ) -> Optional[ProcessMesh]:
    """A ring axis ``name`` over the world ranks ``ranks``, in that order:
    a mesh on a subset of the world, as the survivors of a rank loss
    form. ``dist.new_group`` is collective over the whole world, so every
    process must call this with the same ``ranks``, members and the rest
    alike; a process outside ``ranks`` gets None."""
    ranks = tuple(int(r) for r in ranks)
    group = _group(ranks)
    rank, _ = world()
    if rank not in ranks:
        return None
    return ProcessMesh(axes=(MeshAxis(name, len(ranks), ranks.index(rank),
                                      ranks, group),), rank=rank)


def make_torus_mesh(pg: Optional[int] = None,
                    names: Tuple[str, str] = ("rows", "cols")) -> ProcessMesh:
    """``pg x pg`` torus over the initialized world (``pg`` defaults to its
    square root). Without an initialized process group only ``pg = 1``
    exists: the single-rank mesh."""
    rank, size = world()
    pg = math.isqrt(size) if pg is None else pg
    if pg * pg != size:
        raise ValueError(f"a {pg}x{pg} torus needs {pg * pg} ranks, "
                         f"the world has {size}")
    if size == 1:
        return single_rank_mesh(names)
    r, c = divmod(rank, pg)
    row_name, col_name = names
    # axis "cols" runs along a grid row (fixed r, varying c); axis "rows"
    # along a grid column (fixed c, varying r) — as in the reference mesh
    col_groups = [tuple(i * pg + j for j in range(pg)) for i in range(pg)]
    row_groups = [tuple(i * pg + j for i in range(pg)) for j in range(pg)]
    col_pg = [_group(g) for g in col_groups]
    row_pg = [_group(g) for g in row_groups]
    # the flattened grid is the whole world: its group is the default one
    return ProcessMesh(axes=(
        MeshAxis(row_name, pg, r, row_groups[c], row_pg[c]),
        MeshAxis(col_name, pg, c, col_groups[r], col_pg[r])), rank=rank,
        grid=MeshAxis(tuple(names), size, rank, tuple(range(size)),
                      dist.group.WORLD))


def make_mesh(shape: Sequence[int], names: Sequence[str]) -> ProcessMesh:
    """A rectangular mesh of ``shape`` with axes ``names`` over the whole
    initialized world (``prod(shape)`` ranks), row-major: global rank
    ``g`` sits at the coordinates of ``g`` in ``shape``, the reference's
    device order. Every process must call it with the same arguments, in
    the same order as its other group constructors: it enters
    ``dist.new_group`` for every group of every axis and of every run of
    consecutive axes. Without a process group only the all-ones shape
    exists: the single-rank mesh."""
    shape, names = _checked(shape, names)
    rank, size = world()
    if math.prod(shape) != size:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} ranks, the world has {size}")
    if size == 1:
        return single_rank_mesh(names)

    def group(members):
        return _group(members) if len(members) < size else dist.group.WORLD
    return _rect_mesh(shape, names, rank, group)


def _checked(shape, names):
    shape, names = tuple(int(n) for n in shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in "
                         "length")
    return shape, names


def _rect_mesh(shape, names, rank: int, group) -> ProcessMesh:
    """Rank ``rank``'s view of the row-major ``shape`` mesh; ``group(
    members)`` gives each axis's (and each run of axes') group, and is
    called for every group of the mesh, in one order on every rank."""
    coord = []
    r = rank
    for n in reversed(shape):
        r, c = divmod(r, n)
        coord.append(c)
    coord = tuple(reversed(coord))

    def flat(c):
        g = 0
        for n, i in zip(shape, c):
            g = g * n + i
        return g

    def build(dims):
        # the groups of the axes ``dims`` (consecutive): one per setting of
        # the other coordinates, each listing its ranks row-major over dims
        others = [d for d in range(len(shape)) if d not in dims]
        mine = None
        for fixed in _product([shape[d] for d in others]):
            members = []
            for var in _product([shape[d] for d in dims]):
                c = [0] * len(shape)
                for d, i in zip(others, fixed):
                    c[d] = i
                for d, i in zip(dims, var):
                    c[d] = i
                members.append(flat(c))
            g = group(members) if len(members) > 1 else None
            if rank in members:
                mine = (tuple(members), g)
        ranks, g = mine
        name = names[dims[0]] if len(dims) == 1 else \
            tuple(names[d] for d in dims)
        return MeshAxis(name, len(ranks), ranks.index(rank), ranks,
                        g if len(ranks) > 1 else None)

    axes = tuple(build((d,)) for d in range(len(shape)))
    joint = tuple(build(tuple(range(a, b + 1)))
                  for a in range(len(shape)) for b in range(a + 1, len(shape)))
    return ProcessMesh(axes=axes, rank=rank, joint=joint)


def make_local_mesh(axes: Sequence[str] = ("data", "model")) -> ProcessMesh:
    """A mesh over the whole initialized world (reference
    ``launch/mesh.py:24-33``): one axis gives the ring, two the squarest
    factorization ``(n // a, a)``, ``a`` the largest divisor of ``n`` at
    most ``floor(sqrt(n))``, built by :func:`make_mesh`. Without a process
    group it is ``single_rank_mesh(axes)``."""
    axes = tuple(axes)
    _, n = world()
    if n == 1:
        return single_rank_mesh(axes)
    if len(axes) == 1:
        return make_mesh((n,), axes)
    a = math.isqrt(n)
    while n % a:
        a -= 1
    return make_mesh((n // a, a), axes)


def dry_mesh(shape: Sequence[int] = (16, 16),
             names: Sequence[str] = ("data", "model"), *,
             rank: int = 0) -> ProcessMesh:
    """Rank ``rank``'s view (rank 0's by default) of a mesh that has no
    processes: the counterpart of the reference's
    ``make_production_mesh`` (``launch/mesh.py:11-17``:
    ``(16, 16)`` over ``('data', 'model')``, or ``(2, 16, 16)`` over
    ``('pod', 'data', 'model')``) for the meta-device dry run. Every axis
    wider than 1 carries :data:`repro_torch.comm.dry.DRY` in place of a
    process group, so the engine's transport takes its dry branch there
    (:mod:`repro_torch.comm.dry`). It starts no process and needs no
    process group."""
    from repro_torch.comm.dry import DRY

    shape, names = _checked(shape, names)
    return _rect_mesh(shape, names, rank, lambda members: DRY)


def _product(sizes):
    out = [()]
    for n in sizes:
        out = [c + (i,) for c in out for i in range(n)]
    return out


def make_ring_mesh(name: str = "x") -> ProcessMesh:
    """One ring axis over the whole initialized world."""
    rank, size = world()
    if size == 1:
        return single_rank_mesh((name,))
    return ProcessMesh(axes=(MeshAxis(name, size, rank, tuple(range(size)),
                                      dist.group.WORLD),), rank=rank)


# ---------------------------------------------------------------------------
# gloo worlds for tests
# ---------------------------------------------------------------------------


def _spawn_entry(rank, nprocs, init, axes, timeout, fn, args, out_q):
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=nprocs,
                                timeout=timedelta(seconds=timeout))
        mesh = (make_ring_mesh(axes[0]) if len(axes) == 1
                else make_torus_mesh(names=tuple(axes)))
        out_q.put((rank, True, fn(mesh, *args)))
    except BaseException:  # reported to the parent, which raises
        out_q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_mesh(nprocs: int, fn: Callable, *args,
               axes: Sequence[str] = ("rows", "cols"),
               timeout: float = 120.0) -> list:
    """Run ``fn(mesh, *args)`` on ``nprocs`` fresh gloo processes and return
    the per-rank results in rank order.

    ``axes`` of length 1 builds a ring, of length 2 a square torus. The
    world meets through a ``file://`` store in a private temporary
    directory, so concurrent worlds never collide on a port. Every wait is
    bounded by ``timeout`` seconds: a rank that fails, dies or hangs raises
    here, and the remaining processes are killed."""
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_gloo_")
    init = "file://" + os.path.join(tmp, "store")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=_spawn_entry,
                         args=(r, nprocs, init, tuple(axes), timeout, fn,
                               args, out_q), daemon=True)
             for r in range(nprocs)]
    results: Dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(results) < nprocs:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"gloo world of {nprocs} timed out after {timeout}s; "
                    f"ranks {sorted(results)} finished")
            try:
                rank, ok, payload = out_q.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"gloo ranks {dead} died without a "
                                       "result") from None
                continue
            if not ok:
                raise RuntimeError(f"gloo rank {rank} failed:\n{payload}")
            results[rank] = payload
    finally:
        # after a failure the other ranks may be stuck in a collective
        grace = 10 if len(results) == nprocs else 0
        for p in procs:
            p.join(timeout=grace)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(nprocs)]
