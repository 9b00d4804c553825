"""Overlap-friendly gradient reduction: bucket packing and tree helpers.

Port of ``repro/comm/overlap.py``. The bucketed reduction itself is the
engine op :meth:`repro_torch.comm.engine.CollectiveEngine.allreduce_tree`,
so every registered allreduce schedule gets the same bucket structure. This
module keeps the pure packing helper the engine uses and the deprecated
:func:`bucketed_psum_tree` shim.

A tree is a nest of dicts, lists and tuples with tensor leaves. Its leaves
come in ``jax.tree`` order (a dict's keys sorted), so a tree packs into the
same buckets, and concatenates in the same order, as the reference's.
"""
from __future__ import annotations

import warnings
from typing import List, Tuple

# the former fixed bucket size: the ceiling of the cost model's derived one
# (autotune.MAX_BUCKET_BYTES), and what an engine without a topology uses
DEFAULT_BUCKET_BYTES = 32 * 2**20


# The walks below are module-level functions that take their accumulator
# as an argument: a nested recursive function is a reference cycle (the
# function's closure holds its own cell), which would keep every leaf it saw
# alive until the cyclic garbage collector runs, gigabytes of a training
# state on the card.


def _flatten(t, leaves: list):
    if isinstance(t, dict):
        keys = sorted(t)
        return dict, keys, [_flatten(t[k], leaves) for k in keys]
    if isinstance(t, (list, tuple)):
        return type(t), None, [_flatten(v, leaves) for v in t]
    if t is None:
        return None, None, []
    leaves.append(t)
    return None


def tree_flatten(tree) -> Tuple[list, object]:
    """(leaves, spec): the leaves in ``jax.tree.flatten`` order (dict keys
    sorted, lists and tuples in order, None holding no leaf)."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def _build(s, it):
    if s is None:
        return next(it)
    kind, keys, kids = s
    if kind is dict:
        return {k: _build(c, it) for k, c in zip(keys, kids)}
    if kind is None:
        return None
    return kind(_build(c, it) for c in kids)


def tree_unflatten(spec, leaves) -> object:
    """The tree of ``spec`` with ``leaves`` in flatten order."""
    return _build(spec, iter(leaves))


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_flatten(tree)[0])


def pack_buckets(leaves, bucket_bytes: int = DEFAULT_BUCKET_BYTES
                 ) -> List[List[int]]:
    """Greedily pack leaf indices into ~``bucket_bytes`` groups, in order.

    A leaf larger than ``bucket_bytes`` gets its own bucket; a bucket is
    closed as soon as adding the next leaf would overflow it.
    """
    buckets: List[List[int]] = [[]]
    acc = 0
    for i, leaf in enumerate(leaves):
        nbytes = leaf.numel() * leaf.element_size()
        if acc + nbytes > bucket_bytes and buckets[-1]:
            buckets.append([])
            acc = 0
        buckets[-1].append(i)
        acc += nbytes
    return [b for b in buckets if b]


def bucketed_psum_tree(grads, axis: str,
                       bucket_bytes: int = DEFAULT_BUCKET_BYTES, *, mesh):
    """Deprecated: call
    :meth:`repro_torch.comm.engine.CollectiveEngine.allreduce_tree` instead.

    Forwards to the engine op with the ``native`` schedule over ``mesh``
    (the reference's ``lax.psum`` reads the axis from its enclosing
    ``shard_map``; a process has no such context, so the mesh is passed).
    """
    warnings.warn(
        "bucketed_psum_tree is deprecated; use "
        "CollectiveEngine.allreduce_tree(tree, axis, bucket_bytes=...) — "
        "the single engine code path for bucketed reductions",
        DeprecationWarning, stacklevel=2)
    from repro_torch.comm.engine import CollectiveEngine
    engine = CollectiveEngine.for_mesh(mesh, schedule="native")
    return engine.allreduce_tree(grads, axis, bucket_bytes=bucket_bytes)
