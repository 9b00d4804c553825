"""PTRANS — distributed matrix transposition C = B + A^T (paper §2.2).

Port of ``repro/core/ptrans.py``. Blocks are distributed block-cyclically
over a P x P grid (the paper's PQ scheme, Fig. 3, P = Q): global block
(I, J) lives on grid rank (I % P, J % P), flattened row-major, at local
tile (I // P, J // P). Because the distribution is symmetric, the whole
communication is one exchange with the grid-transpose partner (the
engine's ``grid_transpose``, tag ``ptrans.exchange``), and the local
compute is one full-matrix ``transpose_add``: tile (lj, li)^T lands at
(li, lj) at the block level and within the block at once.

``nchunks=S`` splits the local A into S row strips routed through
:meth:`~repro_torch.comm.engine.CollectiveEngine.pipelined`; each strip's
``transpose_add`` writes a column strip of C, reading the matching column
strip of B in place (a strided view, no copy). The result equals the
monolithic exchange bit for bit for every S: chunk boundaries only
partition the payload and the transpose-add is elementwise.
``nchunks="auto"`` resolves through the cost model's pipeline fill cost
(:meth:`~repro_torch.comm.engine.CollectiveEngine.pipeline_chunks`).

The layout helpers here (:func:`distribute_cyclic`,
:func:`from_reference`, :func:`to_reference`) are shared with HPL.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm.callsites import PTRANS_EXCHANGE
from repro_torch.comm.engine import CollectiveEngine
from repro_torch.comm.types import CommunicationType
from repro_torch.core.hpcc import (BenchResult, device_name, register,
                                   resolve_device, timeit)
from repro_torch.kernels.ops import launch_counts, transpose_add
from repro_torch.launch.mesh import single_rank_mesh, world

CALLSITE = PTRANS_EXCHANGE  # tuning-table tag for the partner exchange
AXES = ("rows", "cols")


# ---------------------------------------------------------------------------
# block-cyclic (de)distribution — shared with HPL
# ---------------------------------------------------------------------------


def distribute_cyclic(mat: np.ndarray, pg: int, b: int) -> np.ndarray:
    """(n, n) -> (pg*pg, m, m) stack of per-device local matrices. Global
    block (I, J) -> device (I%P, J%P), local tile (I//P, J//P)."""
    n = mat.shape[0]
    nb = n // b
    lb = nb // pg
    m = lb * b
    out = np.empty((pg * pg, m, m), mat.dtype)
    for gi in range(nb):
        for gj in range(nb):
            dev = (gi % pg) * pg + (gj % pg)
            li, lj = gi // pg, gj // pg
            out[dev, li * b:(li + 1) * b, lj * b:(lj + 1) * b] = \
                mat[gi * b:(gi + 1) * b, gj * b:(gj + 1) * b]
    return out


def undistribute_cyclic(shards: np.ndarray, pg: int, b: int) -> np.ndarray:
    nshards, m, _ = shards.shape
    lb = m // b
    nb = lb * pg
    n = nb * b
    out = np.empty((n, n), shards.dtype)
    for gi in range(nb):
        for gj in range(nb):
            dev = (gi % pg) * pg + (gj % pg)
            li, lj = gi // pg, gj // pg
            out[gi * b:(gi + 1) * b, gj * b:(gj + 1) * b] = \
                shards[dev, li * b:(li + 1) * b, lj * b:(lj + 1) * b]
    return out


def from_reference(shards_np: np.ndarray, device=None) -> torch.Tensor:
    """This rank's local (m, m) matrix from the reference's (pg*pg, m, m)
    block-cyclic stack (``np.asarray`` of the JAX array, or
    :func:`distribute_cyclic`). Rank ``g`` holds entry ``g`` — grid
    coordinate (g // pg, g % pg), as :func:`make_torus_mesh` lays it out."""
    rank, _ = world()
    local = np.ascontiguousarray(shards_np[rank], dtype=np.float32)
    return torch.from_numpy(local.copy()).to(resolve_device(device))


def to_reference(local: torch.Tensor) -> np.ndarray:
    """The (pg*pg, m, m) stack of every rank's local matrix, in rank order
    (a collective: every rank of the default group calls it)."""
    _, size = world()
    if size == 1:
        return local.detach().cpu().numpy()[None]
    parts = [torch.empty_like(local) for _ in range(size)]
    dist.all_gather(parts, local.contiguous())
    return torch.stack(parts).cpu().numpy()


# ---------------------------------------------------------------------------
# step
# ---------------------------------------------------------------------------


def _ptrans_body(a_loc: torch.Tensor, b_loc: torch.Tensor, *, pg: int,
                 engine: CollectiveEngine, nchunks: int = 1) -> torch.Tensor:
    """This rank's C = B + A^T of the partner's A: the exchange, then
    ``transpose_add`` (per strip, through ``pipelined``, when chunked)."""
    if nchunks <= 1:
        recv = engine.grid_transpose(a_loc, AXES, pg, callsite=CALLSITE)
        return transpose_add(recv, b_loc)

    # strip-wise pipeline: row strip i of A lands, its transpose-add writes
    # column strip i of C from the same column strip of B
    def consume(strip, start):
        return transpose_add(strip, b_loc[:, start:start + strip.shape[0]])

    return engine.pipelined("grid_transpose", a_loc, AXES, pg=pg,
                            nchunks=nchunks, split_axis=0, concat_axis=1,
                            consume=consume, callsite=CALLSITE)


def make_step(mesh, pg: int, engine: CollectiveEngine, nchunks: int = 1):
    """``step(a_loc, b_loc) -> c_loc`` for this rank of ``mesh``; the
    tensors' device picks the kernel (card) or its plain version (CPU)."""
    if mesh.shape["rows"] != pg or mesh.shape["cols"] != pg:
        raise ValueError(f"mesh {mesh.shape} is not a {pg}x{pg} torus")

    def step(a_loc: torch.Tensor, b_loc: torch.Tensor) -> torch.Tensor:
        return _ptrans_body(a_loc, b_loc, pg=pg, engine=engine,
                            nchunks=nchunks)
    return step


def make_inputs(n: int, b: int, pg: int, device=None
                ) -> Tuple[np.ndarray, np.ndarray, torch.Tensor,
                           torch.Tensor]:
    """The reference's A and B (``np.random.default_rng(42)``) and this
    rank's local blocks of each on ``device``."""
    if n % b or (n // b) % pg:
        raise ValueError(f"n={n}, b={b} do not tile a {pg}x{pg} grid")
    rng = np.random.default_rng(42)
    a = rng.standard_normal((n, n), dtype=np.float32)
    bm = rng.standard_normal((n, n), dtype=np.float32)
    return (a, bm, from_reference(distribute_cyclic(a, pg, b), device),
            from_reference(distribute_cyclic(bm, pg, b), device))


@register("ptrans")
def run_ptrans(mesh=None, comm=CommunicationType.ICI_DIRECT, *, n: int = 1024,
               b: int = 128, reps: int = 3, validate: bool = True,
               schedule: str = "auto", nchunks="auto",
               device=None) -> BenchResult:
    """PTRANS on the ``pg x pg`` torus ``mesh`` (axes 'rows', 'cols'; None
    is the single-rank 1x1 grid), on ``device`` (default: the card).

    ``nchunks`` pipelines the exchange into that many row strips (1 =
    monolithic); ``"auto"`` takes the cost model's chunk count.
    Bit-identical output for every value. ``details`` carries the
    reference's keys plus ``device`` and ``launches``: the kernel launches
    of one step (0 for a kernel that ran as its plain version)."""
    device = resolve_device(device)
    mesh = mesh or single_rank_mesh()
    pg = mesh.shape["rows"]
    if mesh.shape["cols"] != pg:
        raise ValueError("paper requires P = Q")
    engine = CollectiveEngine.for_mesh(mesh, comm, schedule)
    a, bm, a_loc, b_loc = make_inputs(n, b, pg, device)

    local_bytes = (n // pg) * (n // pg) * 4
    nchunks_requested = nchunks
    if nchunks == "auto":
        nchunks = engine.pipeline_chunks("grid_transpose",
                                         nbytes=local_bytes, axis=AXES,
                                         callsite=CALLSITE)
    nchunks = max(int(nchunks), 1)

    step = make_step(mesh, pg, engine, nchunks=nchunks)
    before = launch_counts()
    warmup = 1
    out, t = timeit(step, a_loc, b_loc, reps=reps, warmup=warmup)
    launches = {k: (v - before[k]) // (reps + warmup)
                for k, v in launch_counts().items()}

    err = 0.0
    if validate:
        c = undistribute_cyclic(to_reference(out), pg, b)
        err = float(np.max(np.abs(c - (bm + a.T))))

    flops = float(n) * n  # paper: n^2 additions
    resolved = engine.schedule_for("grid_transpose", nbytes=local_bytes,
                                   axis=AXES, callsite=CALLSITE)
    return BenchResult(
        name="ptrans", metric_name="GFLOP/s", metric=flops / t / 1e9,
        error=err, times={"best": t},
        details={"n": n, "block": b, "grid": pg, "comm": engine.comm.value,
                 "schedule": resolved,
                 "schedule_requested": engine.schedule,
                 "nchunks": nchunks,
                 "nchunks_requested": nchunks_requested,
                 "exchange_bytes": local_bytes,
                 "bytes_exchanged": float(n) * n * 4,
                 "device": device_name(device),
                 "launches": launches})
