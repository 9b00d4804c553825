"""Meta-device dry run: every (arch x shape x mesh) cell's step on the
production mesh, on tensors that hold no data.

Port of ``repro/launch/dryrun.py``, the scale proof without hardware. The
reference lowers and compiles each cell's ``jax.jit`` step against 512
placeholder devices and reads FLOPs, bytes and collectives from the
compiled program. PyTorch compiles no whole-step program, so here the
step itself runs, once, as rank 0 of the production mesh:

* the mesh is :func:`repro_torch.launch.mesh.dry_mesh` (``(16, 16)`` over
  ``('data', 'model')``, or ``(2, 16, 16)`` with ``'pod'``; ``--mesh-shape``
  overrides the ``(data, model)`` split). Its axes carry a dry marker in
  place of a process group, so every collective of the step takes the
  engine's dry transport (:mod:`repro_torch.comm.dry`): meta tensors of the
  output's shape, and the op's wire bytes logged by engine source;
* every tensor is rank 0's local shard on ``torch.device("meta")``: the
  ZeRO-1 state (with FSDP weights by default) for a train cell, the bf16
  weights and cache for prefill and decode, under the port's
  ``param_specs``, ``batch_specs`` and ``cache_specs``;
* the step runs under ``torch.utils.flop_counter.FlopCounterMode`` (the
  FLOPs) and :class:`Counter`, a dispatch mode that sums every aten op's
  input and output bytes (an unfused upper bound on HBM traffic: a fused
  kernel reads and writes less) and follows the live storages (the peak);
  a kernel wrapper of :mod:`repro_torch.kernels.ops` called on a meta
  tensor adds its kernel's own FLOPs and bytes (``ops.dry_counts``).

The record has the reference's keys, plus ``state_bytes_per_device``
(params, optimizer, cache, batch), ``peak_bytes_per_device`` with
``fits`` against ``H100_80GB.hbm_bytes``, and ``"links": "loopback"``:
until several cards exist the collective term prices the host's loopback
(ROADMAP "Needs several cards"). Its figures are counts and byte sizes,
not measurements. ``lower_s`` is the cell's build time and ``compile_s``
the dry step's run time, both on the host.

A cell that does not apply to its architecture (``long_500k`` on a pure
full-attention model) is recorded ``skipped``; a cell whose program reads a
tensor's value (``.item()``, ``nonzero``) is ``failed``, naming the op.
Neither is ever ``ok``.

Usage:
    python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh both

Records go to ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
import weakref
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import roofline as rl
from repro_torch import sharding as sh
from repro_torch.comm import dry
from repro_torch.comm.overlap import tree_flatten
from repro_torch.comm.types import H100_80GB
from repro_torch.configs import (SHAPES, cell_is_applicable, get_config,
                                 list_archs, shape_for)
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.kernels import ops
from repro_torch.launch.mesh import dry_mesh
from repro_torch.models import transformer
from repro_torch.models.model import build_model

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
META = torch.device("meta")
FIGURES = ("counts and byte sizes of one rank's meta-device run, not "
           "measurements")
HBM_NOTE = ("unfused upper bound: every aten op's inputs and outputs, and "
            "each hand kernel's own operands")

# aten ops that read a tensor's values on the host, or whose output shape
# depends on them: a meta tensor has no values to read
VALUE_READS = frozenset({"_local_scalar_dense", "nonzero", "nonzero_static",
                         "masked_select", "_unique2", "unique_dim",
                         "unique_consecutive", "equal", "is_nonzero",
                         "bincount"})
# allocations and metadata: no bytes move
NO_TRAFFIC = frozenset({"empty", "empty_like", "empty_strided", "detach",
                        "lift_fresh", "set_"})


class SkipCell(Exception):
    pass


class ValueRead(RuntimeError):
    """The cell's program read a tensor's value."""


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Counter(TorchDispatchMode):
    """Per aten op: its calls and the bytes of its inputs and outputs (view
    ops and allocations move none); the live bytes of every storage the
    run holds (``track`` the state first) and their peak. Raises
    :class:`ValueRead` at an op that reads tensor values."""

    def __init__(self):
        super().__init__()
        self.calls: Dict[str, int] = defaultdict(int)
        self.bytes: Dict[str, float] = defaultdict(float)
        self.live = 0
        self.peak = 0
        self._seen = weakref.WeakKeyDictionary()

    def _free(self, n: int) -> None:
        self.live -= n

    def track(self, tensors) -> None:
        for t in tensors:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            self.live += n
            weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in VALUE_READS:
            raise ValueRead(f"aten.{name} reads a tensor's values")
        out = func(*args, **kwargs)
        self.calls[name] += 1
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view and name not in NO_TRAFFIC:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes[name] += sum(_nbytes(t) for t in ins + outs)
        self.track(outs)
        return out


# ---------------------------------------------------------------------------
# cells: the step, its state, its compute dtype
# ---------------------------------------------------------------------------


@dataclass
class Cell:
    run: Callable[[], object]          # runs the step once
    state: Dict[str, list]             # params / optimizer / cache / batch
    dtype: torch.dtype                 # compute dtype (prices the FLOPs)
    fsdp: bool
    seq_shard: bool = False


def _leaves(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def input_batch(cfg: ModelConfig, seq_len: int, global_batch: int,
                kind: str) -> Dict[str, torch.Tensor]:
    """The cell's global inputs on meta (reference ``models/model.py::
    input_specs``): tokens (one a row for decode) and the modality
    inputs."""
    S = 1 if kind == "decode" else seq_len
    act = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    batch = {"tokens": torch.empty((global_batch, S), dtype=torch.int32,
                                   device=META)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.empty(
            (global_batch, cfg.num_patches, cfg.vision_dim), dtype=act,
            device=META)
    if cfg.is_encoder_decoder and kind != "decode":
        batch["frames"] = torch.empty(
            (global_batch, cfg.audio_ctx, cfg.d_model), dtype=act,
            device=META)
    return batch


def local_batch(batch, mesh, rules) -> Tuple[Dict, bool]:
    """This rank's ``batch_specs`` rows (all of them where dp does not
    divide the batch) and whether they split."""
    rows = batch["tokens"].shape[0]
    if sh._maybe(rows, rules.dp_spec, mesh) is None:
        return batch, False
    idx, n = sh.block_of(mesh, rules.dp_spec)
    b = rows // n
    return {k: v[idx * b:(idx + 1) * b] for k, v in batch.items()}, True


def build_train_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     run_cfg: Optional[RunConfig] = None, *,
                     fsdp: bool = True) -> Cell:
    """The GSPMD train step (microbatched, full remat: the reference's
    production default) on rank 0's ZeRO-1 state, FSDP weights by
    default."""
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        shard_state)

    model = build_model(cfg)
    run_cfg = run_cfg or RunConfig(remat="full", microbatches=8)
    step = make_train_step(model, run_cfg, mesh, zero1=True, fsdp=fsdp)
    state = shard_state(init_train_state(model, 0, device=META), mesh,
                        zero1=True, fsdp=fsdp)
    batch = input_batch(cfg, shape.seq_len, shape.global_batch, "train")
    rows = local_batch(batch, mesh, sh.rules_for(mesh, fsdp=fsdp))[0]
    held = {"params": _leaves(state.params.tree()),
            "optimizer": _leaves(state.opt["mu"]) + _leaves(state.opt["nu"]),
            "cache": [], "batch": _leaves(rows)}

    def run():
        return step(state, batch)
    return Cell(run, held, transformer.dtype_of(cfg.dtype), fsdp)


def _serve_state(cfg: ModelConfig, shape: ShapeConfig, mesh, kind: str):
    from repro_torch import partition as P
    from repro_torch.train.serve import _shard_fn

    model = build_model(cfg)
    shard = _shard_fn(mesh)
    rules = shard.rules
    whole = model.init(device=META)
    params = type(whole)(whole.cfg, sh.cut(
        whole.tree(), sh.param_specs(whole, rules, mesh), mesh, copy=False))
    dtype = torch.bfloat16
    params = transformer.cast_params(params, dtype)
    batch = input_batch(cfg, shape.seq_len, shape.global_batch, kind)
    rows, split = local_batch(batch, mesh, rules)
    wide = P.placement(shard) is not None
    cache = model.init_cache(shape.global_batch, shape.seq_len, dtype,
                             device=META, mesh=mesh if wide else None)
    return model, shard, params, rows, split, cache, dtype


def build_prefill_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                       fsdp: bool = False) -> Cell:
    """The GSPMD prefill (``train/serve.py::_prefill_step``) of this
    rank's rows into its part of the bf16 cache. The port's serving
    placement holds no FSDP weights; ``fsdp`` is recorded, not used."""
    from repro_torch.train.serve import _prefill_step

    model, shard, params, rows, split, cache, dtype = _serve_state(
        cfg, shape, mesh, "prefill")
    step = _prefill_step(model, dataclasses.replace(shard, rows_split=split))
    held = {"params": _leaves(params.tree()), "optimizer": [],
            "cache": _leaves(cache), "batch": _leaves(rows)}
    return Cell(lambda: step(params, rows, cache), held, dtype, False)


def build_decode_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                      fsdp: bool = False) -> Cell:
    """One GSPMD decode step (``train/serve.py::make_decode_step``) that
    enters with a full cache: position ``seq_len - 1``."""
    from repro_torch.train.serve import make_decode_step

    model, shard, params, rows, split, cache, dtype = _serve_state(
        cfg, shape, mesh, "decode")
    if cache.get("pos") is not None:
        cache["pos"] = shape.seq_len - 1
    step = make_decode_step(model, mesh)
    tokens = rows.pop("tokens")
    held = {"params": _leaves(params.tree()), "optimizer": [],
            "cache": _leaves(cache), "batch": [tokens] + _leaves(rows)}
    return Cell(lambda: step(params, tokens, cache, rows), held, dtype,
                False, seq_shard=shape.global_batch == 1)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, **kw) -> Cell:
    ok, why = cell_is_applicable(cfg, shape)
    if not ok:
        raise SkipCell(why)
    build = {"train": build_train_cell, "prefill": build_prefill_cell,
             "decode": build_decode_cell}[shape.kind]
    return build(cfg, shape, mesh, **kw)


def production_mesh(mesh_kind: str, mesh_shape=None):
    """The dry mesh of ``mesh_kind``; ``mesh_shape`` overrides the
    ``(data, model)`` split of the single pod (reference ``:175-191``)."""
    if mesh_shape is not None:
        return dry_mesh(tuple(mesh_shape), ("data", "model"))
    return dry_mesh(*MESHES[mesh_kind])


# ---------------------------------------------------------------------------
# run + count
# ---------------------------------------------------------------------------


@dataclass
class Profile:
    """One dry run's counts: the aten ops' calls, FLOPs and bytes, the
    hand kernels' dry counts, the engine's ops, and the peak live
    bytes."""
    calls: Dict[str, int]
    flops: Dict[str, float]
    bytes: Dict[str, float]
    kernels: Dict[str, Dict[str, float]]
    comm: list
    peak_bytes: int
    seconds: float

    def stats(self) -> rl.DryStats:
        operand: Dict[str, float] = {}
        for o in self.comm:
            operand[o.op] = operand.get(o.op, 0.0) + o.payload_bytes
        return rl.DryStats(
            flops=sum(self.flops.values())
            + sum(k["flops"] for k in self.kernels.values()),
            hbm_bytes=sum(self.bytes.values())
            + sum(k["bytes"] for k in self.kernels.values()),
            operand_bytes=operand,
            wire_bytes=sum(o.wire_bytes for o in self.comm),
            collective_count=len(self.comm))


def profile(run: Callable[[], object], held=()) -> Profile:
    """Run ``run()`` once under the counting modes; ``held`` are the
    tensors it starts with (their storages count as live)."""
    from torch.utils.flop_counter import FlopCounterMode

    dry.reset()
    ops.reset_dry_counts()
    counter = Counter()
    counter.track(held)
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, counter:
        out = run()
        counter.track(tree_leaves(out))
    seconds = time.perf_counter() - t0
    flops = {str(getattr(k, "__name__", k)): float(v)
             for k, v in fc.get_flop_counts().get("Global", {}).items()}
    return Profile(dict(counter.calls), flops, dict(counter.bytes),
                   ops.dry_counts(), dry.ops(), counter.peak, seconds)


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             fsdp: Optional[bool] = None, verbose: bool = True,
             mesh_shape=None, cfg: Optional[ModelConfig] = None,
             prof: Optional[list] = None) -> Dict:
    """One cell's record (``status`` ``ok``); raises :class:`SkipCell`
    or the step's error. ``cfg`` overrides the
    arch's config (a reduced one); ``prof``, when given, receives the
    :class:`Profile`."""
    mesh = production_mesh(mesh_kind, mesh_shape)
    chips = math.prod(mesh.shape.values())
    cfg = cfg or get_config(arch)
    shape = shape_for(shape_name)
    kw = {} if fsdp is None else {"fsdp": fsdp}

    t0 = time.perf_counter()
    cell = build_cell(cfg, shape, mesh, **kw)
    t_build = time.perf_counter() - t0
    held = [t for ts in cell.state.values() for t in ts]
    p = profile(cell.run, held)
    if prof is not None:
        prof.append(p)

    state_bytes = {k: sum(_nbytes(t) for t in ts)
                   for k, ts in cell.state.items()}
    stats = p.stats()
    mflops = rl.model_flops_for(cfg, shape.kind, shape.global_batch,
                                shape.seq_len)
    peak_flops = rl.peak_flops_for(cell.dtype, H100_80GB)
    terms = rl.from_stats(stats, chips=chips, hw=H100_80GB,
                          model_flops=mflops, peak_flops=peak_flops)
    args_bytes = sum(state_bytes.values())
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "mesh_shape": dict(mesh.shape), "chips": chips, "kind": shape.kind,
        "status": "ok",
        "lower_s": round(t_build, 2), "compile_s": round(p.seconds, 2),
        "memory_analysis": {"argument_size_in_bytes": args_bytes,
                            "temp_size_in_bytes": max(p.peak_bytes
                                                      - args_bytes, 0)},
        "flops_per_device": terms.flops,
        "hbm_bytes_per_device": terms.hbm_bytes,
        "collective_operand_bytes": terms.coll_operand_bytes,
        "collective_wire_bytes": terms.coll_wire_bytes,
        "per_op_bytes": terms.details["per_op_bytes"],
        "collective_count": terms.details["collective_count"],
        "unresolved_loops": terms.details["unresolved_loops"],
        "compute_s": terms.compute_s,
        "memory_s": terms.memory_s,
        "collective_s": terms.collective_s,
        "dominant": terms.dominant,
        "model_flops": mflops,
        "useful_ratio": terms.useful_ratio,
        "step_s": terms.step_s,
        "state_bytes_per_device": state_bytes,
        "peak_bytes_per_device": p.peak_bytes,
        "hbm_capacity_bytes": H100_80GB.hbm_bytes,
        "fits": p.peak_bytes <= H100_80GB.hbm_bytes,
        "links": "loopback",
        "fsdp": cell.fsdp, "seq_shard": cell.seq_shard,
        "compute_dtype": str(cell.dtype).replace("torch.", ""),
        "peak_flops": peak_flops,
        "wire_bytes_by_source": dry.wire_by_source(p.comm),
        "kernels": p.kernels,
        "hbm_bytes_note": HBM_NOTE, "figures": FIGURES,
    }
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_kind}] dry step in "
              f"{p.seconds:.1f}s -> {terms.row()}")
        print(f"  state/dev: " + ", ".join(
            f"{k} {v / 2**30:.2f}GiB" for k, v in state_bytes.items())
              + f"; peak {p.peak_bytes / 2**30:.2f}GiB "
              f"(fits 80 GB: {record['fits']}); {FIGURES}")
    return record


def cell_record(arch: str, shape_name: str, mesh_kind: str,
                **kw) -> Dict:
    """:func:`run_cell`'s record, or a ``skipped`` / ``failed`` one."""
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    try:
        return run_cell(arch, shape_name, mesh_kind, **kw)
    except SkipCell as e:
        return {**base, "status": "skipped", "reason": str(e)}
    except Exception as e:  # noqa: BLE001 — record and continue
        return {**base, "status": "failed",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:]}


def cell_list(mesh_kind: str):
    for arch in list_archs():
        for shape_name in SHAPES:
            yield arch, shape_name, mesh_kind


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--mesh-shape", default=None, metavar="DATAxMODEL",
                    help="override the single pod's (data, model) split, "
                         "e.g. 32x8")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--fsdp", default=None, choices=[None, "on", "off"])
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    mesh_shape = (tuple(int(n) for n in args.mesh_shape.split("x"))
                  if args.mesh_shape else None)
    if args.all:
        cells = [(a, s, m) for m in meshes for a, s, _ in cell_list(m)]
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch/--shape or --all")
        cells = [(args.arch, args.shape, m) for m in meshes]

    failures = 0
    for arch, shape_name, mesh_kind in cells:
        tag = f"{arch}__{shape_name}__{mesh_kind}".replace("/", "_")
        path = out / (tag + ".json")
        if path.exists() and not args.force:
            print(f"[skip cached] {tag}")
            continue
        fsdp = None if args.fsdp is None else (args.fsdp == "on")
        rec = cell_record(arch, shape_name, mesh_kind, fsdp=fsdp,
                          mesh_shape=mesh_shape)
        if rec["status"] == "skipped":
            print(f"[skipped] {tag}: {rec['reason']}")
        elif rec["status"] == "failed":
            failures += 1
            print(f"[FAILED] {tag}: {rec['error']}")
        path.write_text(json.dumps(rec, indent=1))
        print(json.dumps({k: v for k, v in rec.items()
                          if k not in ("traceback", "kernels",
                                       "per_op_bytes")}))
    print(f"done; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
