"""Paper Figs. 5/7 analogue, section 3: bucketed vs monolithic gradient
reduction, on a ring of processes.

Port of section 3 of ``benchmarks/overlap_bench.py`` (``:127-183``).

    python -m repro_torch.benchmarks.overlap_bench [--ranks 4] [--arch NAME]
        [--device cuda|cpu] [--schedule NAME ...] [--mode NAME ...]

Each rank of a :func:`~repro_torch.launch.mesh.spawn_mesh` ring (gloo)
holds the gradient of one decoder layer of ``--arch`` at full width (the
shapes of its parameters, under the port's parameter names), on the card
unless ``--device cpu`` is given, and reduces it with
``CollectiveEngine.allreduce_tree`` per allreduce schedule and per bucket
mode: ``monolithic`` (one bucket), ``bucketed`` (a quarter of the tree),
``leafwise`` (one leaf each) and ``model`` (``bucket_bytes_for``, the size
``allreduce_tree`` takes by default). Several ranks on one card talk over
gloo, which stages every payload through host memory: the time is then the
host's loopback, not a link rate. A record holds the time (the slowest
rank's), the bytes each rank staged, the kernels it launched and whether
the result is right.

The reference's sections 1 and 2 (HPL lookahead on a 2x2 torus, chunked
PTRANS) need one rank per card and wait for a multi-card machine (ROADMAP).

The rank body, :func:`reduce_rank`, is a module-level function, so that
spawned processes can import it. Prints a table and writes
``results/bench/torch_overlap_bench.json`` at the root of the checkout.
"""
from __future__ import annotations

import argparse
import hashlib
import time
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.comm.callsites import DP_GRADS
from repro_torch.comm.compression import BLOCK
from repro_torch.comm.engine import (CollectiveEngine, reset_staged_bytes,
                                     schedules_for, staged_bytes)
from repro_torch.comm.overlap import pack_buckets, tree_bytes, tree_flatten, \
    tree_unflatten
from repro_torch.core.hpcc import resolve_device
from repro_torch.kernels import ops, ref

MODES = ("monolithic", "bucketed", "leafwise", "model")
# "ints": integers in [-8, 8) from seed + rank, so every order of additions
# is exact; "normal": standard normal from seed + rank; "int8_exact": one
# tree on every rank, integers in [-100, 100) with 127 at every BLOCK-th
# element of each leaf, which int8_ef carries exactly when every leaf and
# every hop's chunk holds a multiple of BLOCK elements
KINDS = ("ints", "normal", "int8_exact")


def layer_shapes(cfg) -> Dict:
    """The parameter shapes of one decoder layer of ``cfg`` (its gradient's
    leaves), nested as ``LayerParams.tree()``."""
    d, h, kv, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    attn = {"wq": (d, h, hd), "wk": (d, kv, hd), "wv": (d, kv, hd),
            "wo": (h, hd, d)}
    if cfg.qkv_bias:
        attn.update(bq=(h, hd), bk=(kv, hd), bv=(kv, hd))
    return {"ln1": (d,), "attn": attn, "ln2": (d,),
            "mlp": {"w_gate": (d, ff), "w_in": (d, ff), "w_out": (ff, d)}}


def _map_shapes(shapes, fn):
    if isinstance(shapes, dict):
        return {k: _map_shapes(v, fn) for k, v in shapes.items()}
    return fn(tuple(shapes))


def seed_for(kind: str, seed: int, rank: int) -> int:
    return seed if kind == "int8_exact" else seed + rank


def make_tree(shapes, kind: str, seed: int, device) -> Dict:
    """A gradient tree of ``shapes`` drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def leaf(shape):
        if kind == "normal":
            return torch.randn(shape, generator=gen, device=device)
        lo, hi = (-8, 8) if kind == "ints" else (-100, 100)
        t = torch.randint(lo, hi, shape, generator=gen, device=device).float()
        if kind == "int8_exact":
            t.view(-1)[::BLOCK] = 127
        return t

    if kind not in KINDS:
        raise ValueError(f"kind {kind!r} is not one of {KINDS}")
    return _map_shapes(shapes, leaf)


def hop_chunks(shapes, bucket_bytes: int, n: int) -> List[int]:
    """Elements per ring hop of each bucket when a tree of ``shapes`` (one
    dtype) is reduced on a ring of ``n``: the bucket's size over n, rounded
    up (the ring schedules pad each payload to a multiple of n)."""
    leaves = tree_flatten(_map_shapes(
        shapes, lambda s: torch.empty(s, device="meta")))[0]
    return [-(-sum(leaves[i].numel() for i in bucket) // n)
            for bucket in pack_buckets(leaves, bucket_bytes)]


def mode_bucket_bytes(mode: str, total: int, engine, axis) -> int:
    sizes = {"monolithic": 1 << 40, "bucketed": max(total // 4, 1),
             "leafwise": 1}
    return engine.bucket_bytes_for(axis) if mode == "model" else sizes[mode]


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[a.element_size()]
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


def tree_same_bits(got, want) -> bool:
    return all(same_bits(a, b) for a, b in zip(tree_flatten(got)[0],
                                               tree_flatten(want)[0]))


def digest(tree) -> str:
    """sha256 of the tree's leaves, in flatten order."""
    h = hashlib.sha256()
    for t in tree_flatten(tree)[0]:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def _pack(flat: torch.Tensor, n: int) -> torch.Tensor:
    pad = (-flat.numel()) % n
    return torch.cat([flat, flat.new_zeros(pad)]).reshape(n, -1)


def ring_order_sum(trees: Sequence, bucket_bytes: int):
    """What ``rs_ag`` over a ring of ``len(trees)`` ranks (rank r holding
    ``trees[r]``) gives every rank, computed apart from the engine with the
    plain ``ring_add_step``: bucket by bucket, chunk k of the packed payload
    is x[k+n-1] + (... + (x[k+1] + x[k])), the order of the reduce-scatter
    hops."""
    n = len(trees)
    flats = [tree_flatten(t)[0] for t in trees]
    leaves, spec = tree_flatten(trees[0])
    out = list(leaves)
    for bucket in pack_buckets(leaves, bucket_bytes):
        groups: Dict = {}
        for i in bucket:
            if leaves[i].numel():
                groups.setdefault(leaves[i].dtype, []).append(i)
        for idxs in groups.values():
            stacks = [_pack(torch.cat([f[i].reshape(-1) for i in idxs]), n)
                      for f in flats]
            red = torch.empty_like(stacks[0])
            for k in range(n):
                acc = stacks[k][k]
                for j in range(1, n):
                    acc = ref.ring_add_step(stacks[(k + j) % n][k], acc)
                red[k] = acc
            red, off = red.reshape(-1), 0
            for i in idxs:
                size = leaves[i].numel()
                out[i] = red[off:off + size].reshape(leaves[i].shape)
                off += size
    return tree_unflatten(spec, out)


def _add_trees(a, b):
    leaves, spec = tree_flatten(a)
    return tree_unflatten(spec, [x + y for x, y in
                                 zip(leaves, tree_flatten(b)[0])])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reduce_rank(mesh, shapes, runs: Sequence[Tuple[str, str, str]], seed=0,
                device=None, axis: str = "x") -> List[Dict]:
    """Runs on every rank of a ring: for each ``(schedule, mode, kind)`` of
    ``runs``, this rank's tree (drawn on ``device``, the card unless the
    caller asks for another) reduced over ``axis`` by ``allreduce_tree``
    with the ``dp.grads`` tag. Returns one record per run: bucket size and
    count, seconds (from a barrier to the synchronized result), bytes staged
    through the host and kernel launches by this rank, and the result's
    check: ``exact`` for the integer kinds (bit for bit against the sum of
    the ranks' trees, each regenerated from its seed); for ``normal`` a
    ``digest`` to compare across ranks and, under rs_ag or ring2d,
    ``replay_equal`` (bit for bit against :func:`ring_order_sum`)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
        dev = torch.device("cuda", dev.index or 0)
    ax = mesh.axis(axis)
    records = []
    for schedule, mode, kind in runs:
        eng = CollectiveEngine.for_mesh(mesh, schedule=schedule)
        tree = make_tree(shapes, kind, seed_for(kind, seed, ax.index), dev)
        total = tree_bytes(tree)
        bucket_bytes = mode_bucket_bytes(mode, total, eng, axis)
        _sync(dev)
        if ax.size > 1:
            dist.barrier(group=ax.group)
        ops.reset_launch_counts()
        reset_staged_bytes()
        t0 = time.perf_counter()
        out = eng.allreduce_tree(tree, axis, bucket_bytes=bucket_bytes,
                                 callsite=DP_GRADS)
        _sync(dev)
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        rec = dict(schedule=schedule, mode=mode, kind=kind, bytes=total,
                   bucket_bytes=bucket_bytes,
                   buckets=len(pack_buckets(tree_flatten(tree)[0],
                                            bucket_bytes)),
                   seconds=seconds, staged_bytes=staged_bytes(),
                   launches=launches, device=str(dev))
        del tree

        def trees():
            return [make_tree(shapes, kind, seed_for(kind, seed, r), dev)
                    for r in range(ax.size)]

        if kind != "normal":
            want, *rest = trees()
            for t in rest:
                want = _add_trees(want, t)
            rec["exact"] = tree_same_bits(out, want)
        else:
            rec["digest"] = digest(out)
            if schedule in ("rs_ag", "ring2d"):
                rec["replay_equal"] = tree_same_bits(
                    out, ring_order_sum(trees(), bucket_bytes))
        records.append(rec)
    return records


def run(ranks: int, shapes, runs, *, seed: int = 0, device=None,
        timeout: float = 600.0) -> List[List[Dict]]:
    """:func:`reduce_rank` on a ring of ``ranks`` gloo processes; the
    records of every rank, in rank order."""
    from repro_torch.launch.mesh import spawn_mesh
    return spawn_mesh(ranks, reduce_rank, shapes, list(runs), seed, device,
                      axes=("x",), timeout=timeout)


def main(ranks: int = 4, arch: str = "llama3.2-3b", device=None,
         schedules=None, modes=MODES) -> Dict:
    from repro_torch.benchmarks.common import save_result, table
    from repro_torch.configs import get_config

    dev = resolve_device(device)
    schedules = list(schedules or schedules_for("allreduce"))
    shapes = layer_shapes(get_config(arch))
    runs = [(s, m, "int8_exact" if s == "int8_ef" else "ints")
            for s in schedules for m in modes]
    results = run(ranks, shapes, runs, device=str(dev))
    record, rows = {}, []
    for i, (schedule, mode, kind) in enumerate(runs):
        per_rank = [r[i] for r in results]
        first = per_rank[0]
        ok = all(r.get("exact", True) and r.get("replay_equal", True)
                 for r in per_rank) and \
            len({r.get("digest") for r in per_rank}) == 1
        seconds = max(r["seconds"] for r in per_rank)
        record[f"reduce/{schedule}/{mode}"] = dict(
            first, seconds=seconds, ok=ok,
            gbps=first["bytes"] / seconds / 1e9)
        rows.append([schedule, mode, first["buckets"], f"{seconds:.4f}",
                     first["staged_bytes"],
                     first["launches"].get("ring_add_step", 0), ok])
    print(f"== bucketed vs monolithic gradient reduction: one {arch} layer "
          f"({first['bytes']} bytes per rank), ring of {ranks} on {dev} ==")
    print(table(rows, ["schedule", "mode", "buckets", "seconds",
                       "staged B/rank", "ring_add_step", "ok"]))
    save_result("overlap_bench", {"arch": arch, "ranks": ranks,
                                  "device": str(dev), **record})
    return record


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--device", default=None)
    ap.add_argument("--schedule", nargs="*", default=None)
    ap.add_argument("--mode", nargs="*", default=list(MODES))
    args = ap.parse_args()
    main(args.ranks, args.arch, args.device, args.schedule, args.mode)
