"""Atomic checkpointing with retention.

Port of ``repro/checkpoint/manager.py``, with the same layout on disk:

* **Atomicity**: a checkpoint is written to ``step_<k>.tmp/`` and renamed
  to ``step_<k>/`` only after every array and the manifest are on disk; a
  crash mid-write leaves at most a ``.tmp`` directory, which restore
  ignores and the next save removes.
* **Layout**: one ``<name>.npz`` per tree, its arrays keyed by their path
  in the tree (dict keys and list indices joined by ``/``; a
  :class:`~repro_torch.train.step.TrainState` is the tuple ``(params, opt,
  step, error)``, a parameter module its ``tree()``), and a
  ``manifest.json`` with every array's shape and dtype and the caller's
  ``extra``. The port's weights are one entry per layer where the
  reference stacks them per period, so the two packages' files hold the
  same values under other keys.
* **Retention**: the ``keep`` newest checkpoints survive; older ones are
  deleted after a successful save, never before.

:func:`restore` rebuilds each tree in the structure of ``like``, each
tensor on the device and in the dtype of the tensor it replaces, and
reports every missing, unexpected and mis-shaped leaf at once
(:class:`CheckpointMismatchError`). ``restore(reshard_to=mesh)`` is the
elastic path: the files hold whole arrays whatever mesh saved them, and
every rank keeps its own part under the explicit whole-model layout on
``mesh`` (:func:`repro_torch.train.step.shard_whole_model_state`).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_SEP = "/"


class CheckpointMismatchError(ValueError):
    """A checkpoint does not fit the requested structure.

    Raised by :func:`restore` with the complete diagnosis: every missing
    leaf (in ``like`` but not on disk), unexpected leaf (on disk but not in
    ``like``) and shape mismatch across all trees."""

    def __init__(self, missing, unexpected, shape_mismatches):
        self.missing = tuple(missing)
        self.unexpected = tuple(unexpected)
        self.shape_mismatches = tuple(shape_mismatches)
        parts = []
        if self.missing:
            parts.append("missing from checkpoint: "
                         + ", ".join(self.missing))
        if self.unexpected:
            parts.append("unexpected in checkpoint: "
                         + ", ".join(self.unexpected))
        if self.shape_mismatches:
            parts.append("shape mismatches: " + ", ".join(
                f"{key} saved {tuple(got)} != expected {tuple(want)}"
                for key, got, want in self.shape_mismatches))
        super().__init__("checkpoint does not match the requested "
                         "structure — " + "; ".join(parts))


def _children(node):
    """(key, child) pairs of an inner node of a tree, None for a leaf."""
    from repro_torch.train.step import TrainState
    if isinstance(node, TrainState):
        return list(enumerate((node.params, node.opt, node.step,
                               node.error)))
    if isinstance(node, torch.nn.Module):
        node = node.tree(data=False)
    if isinstance(node, dict):
        return sorted(node.items())
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _walk(node, path, out) -> None:
    # module-level, not a nested recursive function: that would be a
    # reference cycle holding every leaf until the garbage collector runs
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        out.append((_SEP.join(path), node))
        return
    for k, child in kids:
        _walk(child, path + (str(k),), out)


def _leaves(tree):
    """(path, leaf) of every leaf of ``tree``, None holding no leaf."""
    out = []
    _walk(tree, (), out)
    return out


def save(directory: str, step: int, trees: Dict[str, object], *,
         keep: int = 3, extra: Optional[dict] = None) -> str:
    """Atomically write ``trees`` (name -> tree) as checkpoint ``step``."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "trees": {}, "extra": extra or {}}
    for name, tree in trees.items():
        flat = {k: _to_numpy(v) for k, v in _leaves(tree)}
        np.savez(os.path.join(tmp, f"{name}.npz"), **flat)
        manifest["trees"][name] = {
            k: {"shape": list(v.shape), "dtype": str(v.dtype)}
            for k, v in flat.items()}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # the atomic commit point

    # retention and stale-tmp garbage collection, only after a good save
    steps = sorted(all_steps(directory))
    for old in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{old:010d}"),
                      ignore_errors=True)
    for entry in os.listdir(directory):
        if entry.endswith(".tmp"):
            shutil.rmtree(os.path.join(directory, entry), ignore_errors=True)
    return final


def all_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for entry in os.listdir(directory):
        if entry.startswith("step_") and not entry.endswith(".tmp") \
                and os.path.exists(os.path.join(directory, entry,
                                                "manifest.json")):
            out.append(int(entry[5:]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _rebuild(node, arrays):
    """``node``'s structure with its leaves taken in order from
    ``arrays``; a tensor leaf becomes a tensor on its device and in its
    dtype, a parameter module a new module of the same class."""
    from repro_torch.train.step import TrainState
    if node is None:
        return None
    if isinstance(node, TrainState):
        return TrainState(*(_rebuild(c, arrays) for c in (
            node.params, node.opt, node.step, node.error)))
    if isinstance(node, torch.nn.Module):
        module = type(node)(node.cfg, _rebuild(node.tree(data=False),
                                               arrays))
        return module.requires_grad_(any(p.requires_grad
                                         for p in node.parameters()))
    if isinstance(node, dict):
        built = {k: _rebuild(node[k], arrays) for k in sorted(node)}
        return {k: built[k] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(c, arrays) for c in node)
    arr = next(arrays)
    if isinstance(node, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=node.device,
                                                  dtype=node.dtype)
    return arr


def restore(directory: str, like: Dict[str, object], *,
            step: Optional[int] = None, reshard_to=None,
            axis: str = "x") -> Tuple[int, Dict[str, object], dict]:
    """Restore (step, trees, extra); ``like`` gives each tree's structure
    and the device and dtype of its tensors. The latest step unless
    ``step`` is given.

    A structure mismatch raises :class:`CheckpointMismatchError` with the
    complete list of missing, unexpected and mis-shaped leaves; leaves on
    disk that ``like`` lacks alone are not an error (a subset restore).

    ``reshard_to`` (a :class:`~repro_torch.launch.mesh.ProcessMesh`) is
    the rank-loss recovery path (reference ``:125-228``): ``like`` has the
    whole shapes, and each restored tree is cut to this rank's part under
    :func:`~repro_torch.train.step.whole_model_param_specs` on ``axis`` of
    that mesh: a ``TrainState``'s weights and moments alike, a weight
    module's weights; any other tree stays whole (replicated)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    d = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    out = {}
    missing: List[str] = []
    unexpected: List[str] = []
    mismatched: List[Tuple[str, tuple, tuple]] = []
    for name, tree in like.items():
        arrays = []
        want = set()
        ok = True
        with np.load(os.path.join(d, f"{name}.npz")) as data:
            for key, leaf in _leaves(tree):
                want.add(key)
                if key not in data:
                    missing.append(f"{name}:{key}")
                    ok = False
                    continue
                arr = data[key]
                shape = tuple(leaf.shape) if hasattr(leaf, "shape") \
                    else np.shape(leaf)
                if tuple(arr.shape) != shape:
                    mismatched.append((f"{name}:{key}", tuple(arr.shape),
                                       shape))
                    ok = False
                    continue
                arrays.append(arr)
            unexpected += sorted(f"{name}:{k}" for k in data.files
                                 if k not in want)
        if ok:
            out[name] = _rebuild(tree, iter(arrays))
    if missing or mismatched:
        raise CheckpointMismatchError(missing, unexpected, mismatched)
    if reshard_to is not None:
        out = {name: _reshard(tree, reshard_to, axis)
               for name, tree in out.items()}
    return step, out, manifest.get("extra", {})


def _reshard(tree, mesh, axis: str):
    """``tree``'s part on this rank of ``mesh`` under the explicit
    whole-model layout (the reference's ``_reshard_shardings``)."""
    from repro_torch.train import step as st
    if isinstance(tree, st.TrainState):
        return st.shard_whole_model_state(tree, mesh, axis)
    if isinstance(tree, torch.nn.Module) and hasattr(tree, "blocks"):
        return st.shard_whole_model_params(tree, mesh, axis)
    return tree


class CheckpointManager:
    """Policy wrapper: save every ``every`` steps, keep ``keep`` newest."""

    def __init__(self, directory: str, *, every: int = 100, keep: int = 3):
        self.directory = directory
        self.every = max(every, 1)
        self.keep = keep

    def save(self, step: int, trees: Dict[str, object], *,
             extra: Optional[dict] = None, force: bool = False
             ) -> Optional[str]:
        """Write checkpoint ``step`` through the retention policy.

        ``force=True`` ignores the cadence: the straggler policy's forced
        checkpoint and the end-of-run save both route here, so every write
        honours ``keep`` and the stale-tmp garbage collection."""
        if not force and step % self.every:
            return None
        return save(self.directory, step, trees, keep=self.keep, extra=extra)

    def maybe_save(self, step: int, trees: Dict[str, object],
                   extra: Optional[dict] = None) -> Optional[str]:
        return self.save(step, trees, extra=extra)

    def restore_latest(self, like, *, reshard_to=None, axis: str = "x"):
        return restore(self.directory, like, reshard_to=reshard_to,
                       axis=axis)

    @property
    def has_checkpoint(self) -> bool:
        return latest_step(self.directory) is not None
