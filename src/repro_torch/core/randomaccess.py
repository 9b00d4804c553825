"""RandomAccess (GUPS) — paper §2.4's scalable redesign, two ways.

Port of ``repro/core/randomaccess.py``. The table is sharded over the ranks
of the ring axis ``x`` in contiguous blocks, as the reference's ``P("x")``;
every rank runs ``rngs_per_device`` xorshift streams covering a disjoint
slice of the global update sequence.

**Drop-local (legacy reference).** Each rank computes every address of its
streams and scatters only the updates that fall into its own shard (the
paper's replicated-RNG filter: no communication).

**Engine-routed (distributed GUPS).** Each rank buckets its updates by
owning rank into a fixed-capacity ``(n_dev, C, 2)`` int32 buffer of
``(local_index, value)`` pairs (unused lanes carry the sentinel index
``local_size`` and value 0, so nothing is ever dropped), one
``all_to_all_tiles`` under the ``ra.updates`` tag routes bucket ``d`` to
rank ``d``, and one scatter-add applies everything that arrived.
``nchunks > 1`` strips the capacity axis through ``engine.pipelined``,
bit-identical to the monolithic exchange.

The port holds the reference's uint32 bits in int32 (torch's uint32 lacks
the shifts on the CPU): ``x << 1`` wraps as the uint32 shift does, the msb
is the sign, and ``>> 31`` (arithmetic) spreads it into the feedback mask.
Values, addresses, buckets and tables are the reference's bits, and int32
additions wrap as XLA's do, so the scatter-add is exact in any order (on
the card ``index_add_`` adds with atomics). The reference's ``mode="drop"``
scatter becomes :func:`scatter_add` into a table with one scratch slot past
its end, which the sentinel index hits and which is cut off.

Each step returns a new table (the reference's step is functional), so the
timed reps never scatter into one table and the inverse-sequence restore
(``error``: the fraction of words that differ, exactly 0) checks every
update. HPCC's XOR updates become additions, as in the reference.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm.callsites import RA_UPDATES
from repro_torch.comm.engine import CollectiveEngine
from repro_torch.comm.types import CommunicationType
from repro_torch.core.hpcc import (BenchResult, axis_values, device_name,
                                   register, resolve_device, timeit)
from repro_torch.launch.mesh import single_rank_mesh

# the reference's 32-bit HPCC LCG polynomial; table_log must be < 31 here
# (the sentinel index local_size must fit in int32)
POLY = 0x7

CALLSITE = RA_UPDATES  # tuning-table tag for the update-routing exchange
AXIS = "x"


def xorshift_step(x: torch.Tensor) -> torch.Tensor:
    """HPCC-style LCG on uint32 bits held in int32:
    x_{i+1} = (x << 1) ^ (msb(x) ? POLY : 0)."""
    return (x << 1) ^ ((x >> 31) & POLY)


def gen_updates(seeds: torch.Tensor, count: int) -> torch.Tensor:
    """``(len(seeds), count)`` int32: row i is seed i's next ``count``
    values, the reference's ``vmap`` of ``_gen_updates``. One step of every
    stream at a time (a few launches a step on the card)."""
    vals = seeds.new_empty((seeds.shape[0], count))
    x = seeds
    for i in range(count):
        x = xorshift_step(x)
        vals[:, i] = x
    return vals


def _owners(vals: torch.Tensor, table_log: int, local_size: int):
    """(owning rank, index in its shard) of each value's table address."""
    addr = vals & ((1 << table_log) - 1)
    return addr // local_size, addr % local_size


def scatter_add(table: torch.Tensor, index: torch.Tensor,
                upd: torch.Tensor) -> torch.Tensor:
    """A new table: ``table`` plus ``upd`` at ``index``, where index
    ``len(table)`` (the sentinel) is dropped, as the reference's
    ``.at[index].add(upd, mode="drop")``."""
    out = torch.cat([table, table.new_zeros(1)])
    out.index_add_(0, index, upd)
    return out[:-1]


def bucket_updates(vals: torch.Tensor, *, table_log: int, local_size: int,
                   n_dev: int, sign: int) -> torch.Tensor:
    """Bucket a rank's raw values by owning rank: the reference's
    ``_bucket_updates``. Row ``d`` of the ``(n_dev, C, 2)`` int32 buffer
    (C = number of values) holds the ``(local_index, signed_value)`` pairs
    for rank ``d`` in generation order from slot 0; the rest carry the
    sentinel index ``local_size`` and value 0."""
    dest, local = _owners(vals, table_log, local_size)
    upd = vals * sign
    buf = vals.new_zeros((n_dev, vals.shape[0], 2))
    buf[..., 0] = local_size
    for d in range(n_dev):
        mine = dest == d
        idx, val = local[mine], upd[mine]
        buf[d, :idx.shape[0], 0] = idx
        buf[d, :idx.shape[0], 1] = val
    return buf


def exchange_updates(engine: CollectiveEngine, buf: torch.Tensor,
                     nchunks: int = 1) -> torch.Tensor:
    """Route bucket ``d`` of every rank to rank ``d`` (``ra.updates``):
    what arrives, ``(n_dev, C, 2)`` by source rank. ``nchunks > 1`` strips
    the capacity axis; the tile axes stay the exchange's (0 -> 0)."""
    if nchunks <= 1:
        return engine.all_to_all_tiles(buf, AXIS, split_axis=0,
                                       concat_axis=0, callsite=CALLSITE)
    return engine.pipelined("all_to_all_tiles", buf, AXIS, nchunks=nchunks,
                            split_axis=1, concat_axis=1, tile_split_axis=0,
                            tile_concat_axis=0, callsite=CALLSITE)


def _clock(times: Optional[Dict[str, float]], device: torch.device):
    """``tick(name)`` adds the seconds since the previous tick, the device's
    queue drained, to ``times[name]``; a no-op when ``times`` is None."""
    if times is None:
        return lambda name: None

    def now():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    last = [now()]

    def tick(name):
        t = now()
        times[name] = times.get(name, 0.0) + t - last[0]
        last[0] = t
    return tick


def make_step(mesh, *, updates_per_rng: int, table_log: int, sign: int = 1):
    """Drop-local step ``step(table, seeds, times=None) -> table`` for this
    rank of ``mesh``: generate, keep the updates of this rank's shard,
    scatter-add. ``times`` collects seconds by phase (generate, scatter)."""
    index = mesh.index(AXIS)

    def step(table, seeds, times=None):
        tick = _clock(times, table.device)
        local_size = table.shape[0]
        vals = gen_updates(seeds, updates_per_rng).reshape(-1)
        tick("generate")
        dest, local = _owners(vals, table_log, local_size)
        mine = dest == index
        out = scatter_add(table, torch.where(mine, local, local_size),
                          torch.where(mine, vals * sign, 0))
        tick("scatter")
        return out
    return step


def make_routed_step(mesh, engine: CollectiveEngine, *, updates_per_rng: int,
                     table_log: int, sign: int = 1, nchunks: int = 1):
    """Engine-routed step ``step(table, seeds, times=None) -> table``:
    generate, bucket, exchange under ``ra.updates``, scatter-add. Every
    generated update is applied, on its owning rank. ``times`` collects
    seconds by phase (generate, bucket, exchange, scatter)."""
    n_dev = mesh.axis(AXIS).size

    def step(table, seeds, times=None):
        tick = _clock(times, table.device)
        vals = gen_updates(seeds, updates_per_rng).reshape(-1)
        tick("generate")
        buf = bucket_updates(vals, table_log=table_log,
                             local_size=table.shape[0], n_dev=n_dev,
                             sign=sign)
        del vals
        tick("bucket")
        recv = exchange_updates(engine, buf, nchunks)
        del buf
        tick("exchange")
        out = scatter_add(table, recv[..., 0].reshape(-1),
                          recv[..., 1].reshape(-1))
        tick("scatter")
        return out
    return step


# ---------------------------------------------------------------------------
# the reference's state
# ---------------------------------------------------------------------------


def reference_state(n_dev: int, *, table_log: int, rngs_per_device: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's initial table (int32, ``2**table_log``) and seeds
    (uint32, ``(n_dev, rngs_per_device)``), drawn from
    ``np.random.default_rng(3)`` in its order."""
    size = 1 << table_log
    if size % n_dev:
        raise ValueError(f"table size 2**{table_log} = {size} not divisible "
                         f"by {n_dev} devices")
    rng = np.random.default_rng(3)
    init = rng.integers(1, 2 ** 30, size, dtype=np.int32)
    seeds = rng.integers(1, 2 ** 30, (n_dev, rngs_per_device),
                         dtype=np.uint32)
    return init, seeds


def from_reference(table_np: np.ndarray, seeds_np: np.ndarray, mesh,
                   device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's table shard (its contiguous block, as ``P("x")``) and
    its row of seeds (uint32 bits as int32) on ``device``."""
    ax = mesh.axis(AXIS)
    local_size = table_np.shape[0] // ax.size
    lo = ax.index * local_size
    table = torch.from_numpy(table_np[lo:lo + local_size].copy())
    seeds = torch.from_numpy(seeds_np[ax.index].view(np.int32).copy())
    device = resolve_device(device)
    return table.to(device), seeds.to(device)


def to_reference(table: torch.Tensor, mesh) -> np.ndarray:
    """The whole table, every rank's shard in axis order (a collective:
    every rank of the axis calls it; gathered through host memory)."""
    ax = mesh.axis(AXIS)
    local = table.detach().cpu()
    if ax.size == 1:
        return local.numpy()
    parts = [torch.empty_like(local) for _ in range(ax.size)]
    dist.all_gather(parts, local, group=ax.group)
    return torch.cat(parts).numpy()


def _validate(fwd, inv, table, seeds, ax, reps: int):
    """Time ``fwd`` (the slowest rank's best), restore with ``inv``, and
    time one more forward step by phase."""
    out, t = timeit(fwd, table, seeds, reps=reps)
    restored = inv(out, seeds)
    del out
    mismatched = int((restored != table).sum())
    del restored
    phases: Dict[str, float] = {}
    fwd(table, seeds, times=phases)
    size = table.shape[0] * ax.size
    return (max(axis_values(t, ax)), sum(axis_values(mismatched, ax)) / size,
            phases)


def _details(mesh, table_log, rngs_per_device, updates_per_rng, device,
             phases):
    n_dev = mesh.axis(AXIS).size
    return {"table_log": table_log, "devices": n_dev,
            "rngs_per_device": rngs_per_device,
            "updates": float(n_dev * rngs_per_device * updates_per_rng),
            "phase_seconds": phases, "device": device_name(device)}


@register("randomaccess")
def run_randomaccess(mesh=None, comm=CommunicationType.ICI_DIRECT, *,
                     table_log: int = 20, rngs_per_device: int = 4,
                     updates_per_rng: int = 4096, reps: int = 2,
                     device=None) -> BenchResult:
    """Drop-local GUPS over the ranks of ``mesh`` (axis 'x'; None is the
    single-rank ring), on ``device`` (default: the card). ``error`` is the
    fraction of table words the inverse sequence fails to restore;
    ``details["phase_seconds"]`` splits one extra step by phase."""
    device = resolve_device(device)
    mesh = mesh or single_rank_mesh((AXIS,))
    ax = mesh.axis(AXIS)
    table, seeds = from_reference(
        *reference_state(ax.size, table_log=table_log,
                         rngs_per_device=rngs_per_device), mesh, device)
    kw = dict(updates_per_rng=updates_per_rng, table_log=table_log)
    t, err, phases = _validate(make_step(mesh, sign=+1, **kw),
                               make_step(mesh, sign=-1, **kw),
                               table, seeds, ax, reps)
    details = _details(mesh, table_log, rngs_per_device, updates_per_rng,
                       table.device, phases)
    return BenchResult(
        name="randomaccess", metric_name="GUPS",
        metric=details["updates"] / t / 1e9, error=err, times={"best": t},
        details=details)


@register("randomaccess_dist")
def run_randomaccess_dist(mesh=None, comm=CommunicationType.ICI_DIRECT, *,
                          table_log: int = 20, rngs_per_device: int = 4,
                          updates_per_rng: int = 4096, reps: int = 2,
                          schedule: str = "auto", nchunks="auto",
                          device=None) -> BenchResult:
    """Engine-routed GUPS over the ring 'x' of ``mesh`` (None: one rank):
    every update is forwarded to its owning rank through
    ``all_to_all_tiles`` under ``ra.updates``. Validated by exact
    inverse-sequence restore (``error`` 0.0 on every schedule and
    chunking); ``details["phase_seconds"]`` splits one extra step into
    generate, bucket, exchange and scatter."""
    device = resolve_device(device)
    mesh = mesh or single_rank_mesh((AXIS,))
    ax = mesh.axis(AXIS)
    engine = CollectiveEngine.for_mesh(mesh, comm, schedule)
    table, seeds = from_reference(
        *reference_state(ax.size, table_log=table_log,
                         rngs_per_device=rngs_per_device), mesh, device)

    cap = rngs_per_device * updates_per_rng
    payload = ax.size * cap * 2 * 4  # (n_dev, C, 2) int32 per rank
    nchunks_requested = nchunks
    if nchunks == "auto":
        nchunks = engine.pipeline_chunks("all_to_all_tiles", nbytes=payload,
                                         axis=AXIS, callsite=CALLSITE)
    nchunks = max(int(nchunks), 1)

    kw = dict(updates_per_rng=updates_per_rng, table_log=table_log,
              nchunks=nchunks)
    t, err, phases = _validate(make_routed_step(mesh, engine, sign=+1, **kw),
                               make_routed_step(mesh, engine, sign=-1, **kw),
                               table, seeds, ax, reps)
    details = _details(mesh, table_log, rngs_per_device, updates_per_rng,
                       table.device, phases)
    details.update({
        "comm": engine.comm.value,
        "schedule": engine.schedule_for("all_to_all_tiles", nbytes=payload,
                                        axis=AXIS, callsite=CALLSITE),
        "schedule_requested": engine.schedule, "nchunks": nchunks,
        "nchunks_requested": nchunks_requested, "exchange_bytes": payload})
    return BenchResult(
        name="randomaccess_dist", metric_name="GUPS",
        metric=details["updates"] / t / 1e9, error=err, times={"best": t},
        details=details)
