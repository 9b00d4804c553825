"""Sharding rules: logical names -> mesh layouts, over the port's process
mesh.

Port of ``repro/sharding.py`` (all of it) over
:class:`repro_torch.launch.mesh.ProcessMesh`, or any object with the
reference's ``shape`` (axis name -> size) and ``axis_names``. The
production mesh has axes ``('data', 'model')`` or ``('pod', 'data',
'model')``: data parallelism over ``pod x data``, tensor and expert
parallelism over ``model``. Rules are divisibility-aware, as in the
reference: a dimension is split only where the axis size divides it.

A spec is a :class:`LeafSpec`, the port's ``PartitionSpec``: per leading
dimension a mesh-axis name, a tuple of names (split over their row-major
product, the reference's ``dp_spec`` over ``('pod', 'data')``) or None.
Specs are layouts: PyTorch has no partitioner that inserts collectives
where a layout changes, so the layers realise them with engine calls
placed where GSPMD puts its collectives (:mod:`repro_torch.partition`).
:func:`cut` is the counterpart of ``to_named``: it cuts a whole tree to
this rank's blocks. The spec functions read only shapes, so they take
``device="meta"`` trees (``model.init(device="meta")``) at full size for
nothing.

The port's layers are a list, not the reference's stack over
super-blocks: a block leaf has no leading scan dimension here, so its spec
is the reference's without that dimension's leading None.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.comm.overlap import tree_flatten, tree_unflatten


@dataclass(frozen=True)
class MeshRules:
    dp: Tuple[str, ...]          # data-parallel mesh axes, e.g. ('pod', 'data')
    tp: Optional[str] = "model"  # tensor/expert-parallel axis
    sp: Optional[str] = None     # sequence-shard axis for long-context decode
    fsdp: bool = False           # additionally shard params over dp (ZeRO-3)

    @property
    def dp_spec(self):
        return self.dp if len(self.dp) > 1 else self.dp[0]


@dataclass(frozen=True)
class LeafSpec:
    """Where a leaf lives: ``dims`` names, per leading dimension, the mesh
    axis (a name or a tuple of names) it is split over, or None (whole);
    the dimensions past ``dims`` are whole. Empty for a replicated
    leaf."""
    dims: Tuple[object, ...] = ()

    @property
    def replicated(self) -> bool:
        return not any(self.dims)

    def __iter__(self):
        return iter(self.dims)

    def __len__(self) -> int:
        return len(self.dims)


def rules_for(mesh, *, seq_shard: bool = False,
              fsdp: bool = False) -> MeshRules:
    names = tuple(mesh.axis_names)
    dp = tuple(a for a in ("pod", "data") if a in names)
    if not dp:
        dp = (names[0],)
    if "model" in names:
        tp = "model"
    else:  # no named model axis: TP over the last axis not already used for DP
        spare = [a for a in names if a not in dp]
        tp = spare[-1] if spare else None
    return MeshRules(dp=dp, tp=tp,
                     sp=("data" if seq_shard and "data" in names else None),
                     fsdp=fsdp)


def _axsize(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _maybe(dim: int, axes, mesh):
    """Return the axes if they evenly divide ``dim``, else None (replicate)."""
    if axes is None or dim % _axsize(mesh, axes):
        return None
    return axes if not (isinstance(axes, tuple) and len(axes) == 1) else axes[0]


# ---------------------------------------------------------------------------
# activation layouts (the ``shard`` callback threaded through the model)
# ---------------------------------------------------------------------------


def activation_spec(name: str, rules: MeshRules) -> LeafSpec:
    dp = rules.dp_spec
    if name == "residual":      # (B, S, D)
        return LeafSpec((dp, rules.sp, None))
    if name == "logits":        # (B, S, V) — vocab stays sharded until the loss
        return LeafSpec((dp, rules.sp, rules.tp))
    if name == "ffn":           # (B, S, F)
        return LeafSpec((dp, rules.sp, rules.tp))
    if name == "heads":         # (B, S, H, hd)
        return LeafSpec((dp, rules.sp, rules.tp, None))
    if name == "moe_buf":       # (B, E, C, D) — expert-parallel dispatch
        return LeafSpec((dp, rules.tp, None, None))
    if name == "moe_tokens":    # (B, T/S, D) — token-side views stay D-sharded
        return LeafSpec((dp, None, rules.tp))
    return LeafSpec()


@dataclass(frozen=True)
class ShardFn:
    """The activation callback: the identity on the local tensor, carrying
    ``mesh`` and ``rules`` (which make the model take the flash path and,
    on a wide mesh, the tensor-parallel layers of
    :mod:`repro_torch.partition`). ``rows_split`` is set by the callers
    that cut the batch themselves (``generate``, the train step): False
    when every rank holds the whole batch, which the dp axes do not
    divide; ``gather`` is the FSDP hook that gathers a tree of dp-split
    weights before use (None without FSDP)."""
    mesh: object
    rules: MeshRules
    rows_split: bool = True
    gather: Optional[Callable] = None

    def __call__(self, x: torch.Tensor, name: str) -> torch.Tensor:
        # each layer keeps the named activation in activation_spec's layout
        # itself: the local tensor is already it
        return x


def make_shard_fn(mesh, rules: MeshRules) -> ShardFn:
    return ShardFn(mesh, rules)


# ---------------------------------------------------------------------------
# parameter specs (name-based rules over the param tree)
# ---------------------------------------------------------------------------

def _leaf_spec(path: Tuple[str, ...], shape: Tuple[int, ...], rules: MeshRules,
               mesh, ssm_whole: bool = False) -> LeafSpec:
    """Partition rule for one parameter leaf; ``path`` is the tuple of
    keys (a list index as its string). ``ssm_whole`` keeps every SSM leaf
    whole (the model's SSM heads do not divide over ``tp``)."""
    tp = rules.tp
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    core = shape

    def out(*axes):  # padded to the leaf's rank, as the reference's P
        return LeafSpec(tuple(axes) + (None,) * (len(core) - len(axes)))

    if name == "embed":                             # (V, D) vocab-parallel
        return out(_maybe(core[0], tp, mesh))
    if name == "wq":                                # (D, H, hd) heads sharded
        return out(None, _maybe(core[1], tp, mesh))
    if name in ("wk", "wv"):                        # (Din, KV, hd) if kv % tp
        return out(None, _maybe(core[1], tp, mesh))
    if name == "wo":                                # (H, hd, D)
        return out(_maybe(core[0], tp, mesh))
    if name == "bq":                                # (H, hd)
        return out(_maybe(core[0], tp, mesh))
    if name in ("bk", "bv"):                        # (KV, hd)
        return out(_maybe(core[0], tp, mesh))
    if parent == "moe":
        if name == "router":                        # (D, E)
            return out(None, _maybe(core[1], tp, mesh))
        if name in ("w_gate", "w_in", "w_out"):     # (E, D, F) / (E, F, D): EP
            return out(_maybe(core[0], tp, mesh))
    if name in ("w_gate", "w_in"):                  # (D, F) mlp/shared
        return out(None, _maybe(core[1], tp, mesh))
    if name == "w_out":                             # (F, D)
        return out(_maybe(core[0], tp, mesh))
    if parent == "ssm":
        if ssm_whole:
            return out()
        if name in ("in_x", "in_z"):                # (D, d_in): channel-shard
            return out(None, _maybe(core[1], tp, mesh))
        if name in ("conv_x",):                     # (k, d_in)
            return out(None, _maybe(core[1], tp, mesh))
        if name in ("conv_x_b", "norm"):            # (d_in,)
            return out(_maybe(core[0], tp, mesh))
        if name == "out_proj":                      # (d_in, D)
            return out(_maybe(core[0], tp, mesh))
        # in_bc, in_dt, conv_bc, A_log, D, dt_bias: small, replicate
        return out()
    if name == "patch_proj":                        # (vision_dim, D)
        return out()
    # norms / scalars / anything unmatched: replicated
    return out()


def _tree(params):
    return params.tree() if isinstance(params, torch.nn.Module) else params


def _map_with_path(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(v, fn, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def param_specs(params, rules: MeshRules, mesh):
    """Tree of :class:`LeafSpec` shaped like ``params.tree()`` (or like
    ``params``, a tree already; meta tensors do).

    With ``rules.fsdp`` the name-based TP spec is extended by sharding the
    largest remaining unsharded dim over the dp axes (fully-sharded /
    ZeRO-3 weights, gathered per layer at use). The reference protects
    its block leaves' scan dimension there (``skip_first``); the port's
    have none.

    One rule differs from the reference's: where ``tp`` does not divide
    the SSM heads (the length of ``A_log``) every SSM weight stays whole,
    since the port's SSM layer splits whole heads only; the reference
    splits ``d_in`` wherever ``tp`` divides it, inside a head."""
    tree = _tree(params)
    ssm_whole = _ssm_heads_undivided(tree, rules, mesh)

    def leaf(path, x):
        spec = _leaf_spec(path, tuple(x.shape), rules, mesh, ssm_whole)
        if rules.fsdp:
            spec = zero1_spec(spec, tuple(x.shape), rules, mesh)
        return spec
    return _map_with_path(tree, leaf)


def _ssm_heads_undivided(tree, rules: MeshRules, mesh) -> bool:
    """Whether an SSM layer of ``tree`` has heads (``A_log``'s length)
    that the ``tp`` axis does not divide."""
    if isinstance(tree, dict):
        if "A_log" in tree:
            return _maybe(tree["A_log"].shape[0], rules.tp, mesh) is None \
                and _axsize(mesh, rules.tp) > 1
        return any(_ssm_heads_undivided(v, rules, mesh)
                   for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_ssm_heads_undivided(v, rules, mesh) for v in tree)
    return False


# ---------------------------------------------------------------------------
# optimizer-state specs (ZeRO-1: moments additionally sharded over dp)
# ---------------------------------------------------------------------------


def zero1_spec(spec: LeafSpec, shape: Tuple[int, ...], rules: MeshRules,
               mesh, *, skip_first: bool = False) -> LeafSpec:
    """Extend a param spec by sharding the largest unsharded dim over dp.

    Used for optimizer-state (ZeRO-1) sharding and — via ``rules.fsdp`` —
    for fully-sharded weights (ZeRO-3). ``skip_first`` leaves dimension 0
    alone (the reference's layer-scan dimension)."""
    dp = rules.dp_spec
    dpn = _axsize(mesh, dp)
    if dpn == 1:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    dp_axes = set(dp) if isinstance(dp, tuple) else {dp}
    for e in entries:  # already dp-sharded (e.g. fsdp params): no-op
        es = set(e) if isinstance(e, tuple) else {e}
        if es & dp_axes:
            return spec
    best, best_dim = -1, -1
    for i, (s, d) in enumerate(zip(entries, shape)):
        if skip_first and i == 0:
            continue
        if s is None and d % dpn == 0 and d > best_dim:
            best, best_dim = i, d
    if best < 0:
        return spec
    entries[best] = dp
    return LeafSpec(tuple(entries))


def opt_state_specs(params, rules: MeshRules, mesh, *, zero1: bool = True):
    pspecs = param_specs(params, rules, mesh)
    if not zero1:
        return pspecs
    leaves, struct = tree_flatten(pspecs)
    shapes = tree_flatten(_tree(params))[0]
    return tree_unflatten(struct, [
        zero1_spec(s, tuple(p.shape), rules, mesh)
        for s, p in zip(leaves, shapes)])


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------


def batch_specs(batch, rules: MeshRules, mesh) -> Dict[str, LeafSpec]:
    """Shard every batch input's leading (batch) dim over dp when divisible."""
    dp = rules.dp_spec
    out = {}
    for k, v in batch.items():
        ax = _maybe(v.shape[0], dp, mesh)
        out[k] = LeafSpec((ax,) + (None,) * (len(v.shape) - 1))
    return out


def cache_specs(cache, rules: MeshRules, mesh, *, seq_shard: bool = False,
                kv_fallback: str = "hd"):
    """KV/SSM cache specs over the reference's stacked cache leaves.
    Attention leaves are (n_super, B, Smax, KV, hd): batch over dp; KV
    heads over tp when divisible, otherwise (``kv_fallback``) head_dim
    (``'hd'``) or the sequence (``'seq'``) over tp. For B=1 long-context
    cells (``seq_shard``) the sequence dim additionally shards over
    'data'. SSM state leaves (n_super, B, nh, hd, N): batch over dp, heads
    over tp. ``cache`` is a nested dict of leaves with ``shape``, in the
    reference's layout (the port's per-layer list is stacked there)."""
    dp, tp = rules.dp_spec, rules.tp

    def leaf(path, x):
        shape = tuple(x.shape)
        if len(shape) == 0:
            return LeafSpec()
        name = path[-1] if path else ""
        if name in ("k", "v") and len(shape) == 5:   # attn: (L, B, S, KV, hd)
            b_ax = _maybe(shape[1], dp, mesh)
            kv_ax = _maybe(shape[3], tp, mesh)
            hd_ax = None
            s_axes = []
            if kv_ax is None and tp is not None:
                if kv_fallback == "hd":
                    hd_ax = _maybe(shape[4], tp, mesh)
                else:
                    s_axes.append(tp)
            if seq_shard and b_ax is None and "data" in mesh.axis_names:
                s_axes.append("data")
            s_ax = _maybe(shape[2], tuple(s_axes), mesh) if s_axes else None
            return LeafSpec((None, b_ax, s_ax, kv_ax, hd_ax))
        if name == "state" and len(shape) == 5:      # ssm: (L, B, nh, hd, N)
            return LeafSpec((None, _maybe(shape[1], dp, mesh),
                             _maybe(shape[2], tp, mesh), None, None))
        if name.startswith("conv") and len(shape) == 4:  # (L, B, k, d_in)
            return LeafSpec((None, _maybe(shape[1], dp, mesh), None,
                             _maybe(shape[3], tp, mesh)))
        if name == "encoder_out":                    # enc-dec: (B, T, D)
            return LeafSpec((_maybe(shape[0], dp, mesh), None, None))
        if len(shape) >= 2:                          # generic (L, B, ...) leaf
            return LeafSpec((None, _maybe(shape[1], dp, mesh)))
        return LeafSpec()

    return _map_with_path(cache, leaf)


# ---------------------------------------------------------------------------
# this rank's blocks (the counterpart of ``to_named``)
# ---------------------------------------------------------------------------


def _as_axes(entry) -> Tuple[str, ...]:
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def block_of(mesh, entry) -> Tuple[int, int]:
    """(index, count) of this rank's block along a dimension split over
    ``entry`` (a name or a tuple of names, row-major over them)."""
    idx, n = 0, 1
    for name in _as_axes(entry):
        ax = mesh.axis(name)
        idx, n = idx * ax.size + ax.index, n * ax.size
    return idx, n


def cut_leaf(t: torch.Tensor, spec: LeafSpec, mesh, *,
             copy: bool = True) -> torch.Tensor:
    """This rank's contiguous block of ``t`` under ``spec``: a copy where
    anything is cut, so that the whole leaf can be freed, or with
    ``copy=False`` a view of ``t`` (a serving engine that keeps the whole
    weights cuts them so, holding no second copy)."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx, n = block_of(mesh, entry)
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {t.shape[dim]} does "
                             f"not split over {entry!r} ({n} ranks)")
        size = t.shape[dim] // n
        t = t.narrow(dim, idx * size, size)
        if copy:
            t = t.clone()
    return t


def cut(tree, specs, mesh, *, copy: bool = True):
    """``tree`` with every leaf cut to this rank's block by its
    :class:`LeafSpec` in ``specs`` (a tree of the same structure); views
    of the leaves with ``copy=False`` (:func:`cut_leaf`)."""
    leaves, struct = tree_flatten(tree)
    return tree_unflatten(struct, [
        cut_leaf(t, s, mesh, copy=copy)
        for t, s in zip(leaves, tree_flatten(specs)[0])])
