"""Fault-tolerant training loop.

Port of ``repro/train/loop.py`` (``train_loop``, ``largest_divisible``,
``train_loop_elastic``):

* auto-resume: on start, if the checkpoint directory holds a valid step,
  restore it (onto the current mesh, which may differ from the saving
  mesh: ``checkpoint.restore(reshard_to=)``);
* periodic atomic checkpoints, and a forced one when the straggler policy
  is 'checkpoint' and a step blows its deadline;
* crash injection for tests: ``fail_at_step`` raises after the optimizer
  update but before that step's checkpoint, so a restart loses at most
  ``checkpoint_every`` steps;
* deterministic data: batches are a pure function of (seed, step), so a
  resumed run consumes exactly the batches the crashed run would have;
* a scripted fault timeline (:class:`repro_torch.comm.faults.
  FaultSchedule`) applied at each step's start, its host delay inside the
  timed region, and a retune controller fed every step's duration;
* elastic rank-loss recovery (:func:`train_loop_elastic`): when the
  schedule declares a rank lost the loop raises
  :class:`~repro_torch.comm.faults.RankLostError`, and the survivors
  rebuild the mesh on the largest count dividing the global batch, restore
  the latest checkpoint resharded onto it and resume.

``step_mode="gspmd"`` runs :func:`repro_torch.train.step.make_train_step`
on the one-rank mesh, or on every rank of a wide mesh (``launch/mesh.py::
make_mesh``), each process calling the loop: the state is cut by
:func:`~repro_torch.train.step.shard_state` at step 0 (its moments over
dp with ``TrainLoopConfig.zero1``), a restored one into the same layout;
``"explicit_tp"`` and ``"explicit_sp"`` run
:func:`~repro_torch.train.step.make_whole_model_train_step_explicit` on
every rank of a ring :class:`~repro_torch.launch.mesh.ProcessMesh`, each
process calling the loop, on the card unless ``device="cpu"``. On a mesh of
several ranks one rank writes the checkpoints (whole arrays, every split
leaf gathered through the engine), every rank waits at a barrier before
anyone reads or writes the directory again, and the ranks agree on a
forced checkpoint (any rank's straggler flag).
"""
from __future__ import annotations

import logging
import shutil
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import checkpoint as ckpt
from repro_torch.comm.faults import RankLostError
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.hpcc import resolve_device
from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
from repro_torch.launch.mesh import sub_ring_mesh
from repro_torch.models.model import build_model
from repro_torch.train.step import (gather_state, gather_whole_model_state,
                                    init_train_state, make_train_step,
                                    make_whole_model_train_step_explicit,
                                    shard_state, shard_whole_model_state)
from repro_torch.train.straggler import StepTimer, StragglerMonitor

log = logging.getLogger("repro_torch.train")

STEP_MODES = ("gspmd", "explicit_tp", "explicit_sp")


@dataclass
class TrainLoopConfig:
    steps: int = 100
    log_every: int = 10
    fail_at_step: Optional[int] = None  # crash injection (tests)
    # "gspmd": AdamW's moments split over the dp axes (ZeRO-1) on a mesh
    # of several ranks
    zero1: bool = True
    # "gspmd" (the GSPMD step) | "explicit_tp" | "explicit_sp": the
    # explicit modes run the whole-model step with engine-routed exchanges
    # on every rank of a mesh (make_whole_model_train_step_explicit)
    step_mode: str = "gspmd"
    # straggler reaction (repro_torch.train.straggler.POLICIES): 'warn' |
    # 'checkpoint' (force an early save) | 'retune' (hand the flag to the
    # RetuneController below)
    straggler_policy: str = "checkpoint"
    # scripted degraded-link timeline (repro_torch.comm.faults.
    # FaultSchedule): applied at each step's start, its host delays land
    # inside the timed region so the StragglerMonitor sees them
    fault_schedule: Optional[object] = None
    # adaptive retuning (repro_torch.comm.retune.RetuneController):
    # observes every step duration; on a retune event under an explicit
    # step_mode the step is rebuilt, as the reference rebuilds its jitted
    # step
    retune: Optional[object] = None


class InjectedFailure(RuntimeError):
    pass


class _Ranks:
    """The checkpoint discipline of a loop on a mesh of several ranks: one
    writer, a barrier after every write and before the first read, and
    one answer to "force a checkpoint?" on every rank. On one rank every
    method is the plain call."""

    def __init__(self, mesh, axis: str, explicit: bool, model=None,
                 zero1: bool = True):
        ax = None
        if explicit:
            ax = mesh.axis(axis)
        elif mesh is not None:  # every rank of the mesh, one group
            ax = mesh.axis(tuple(a.name for a in mesh.axes))
        self.ax = ax if ax is not None and ax.size > 1 else None
        self.mesh, self.axis, self.explicit = mesh, axis, explicit
        self.model, self.zero1 = model, zero1

    def barrier(self) -> None:
        if self.ax is not None:
            dist.barrier(group=self.ax.group)

    def any(self, flag: bool) -> bool:
        if self.ax is None:
            return flag
        t = torch.tensor([int(flag)])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.ax.group)
        return bool(t.item())

    def save(self, manager, step: int, state, *, extra, force: bool) -> None:
        if not force and step % manager.every:
            return
        if self.explicit:
            state = gather_whole_model_state(state, self.mesh, self.axis)
        elif self.ax is not None:
            state = gather_state(state, self.model, self.mesh,
                                 zero1=self.zero1)
        if self.ax is None or self.ax.index == 0:
            manager.save(step, {"state": state}, extra=extra, force=True)
        self.barrier()


def train_loop(model_cfg: ModelConfig, run_cfg: RunConfig,
               data_cfg: DataConfig, loop_cfg: TrainLoopConfig, *,
               mesh=None, key: Optional[int] = None, axis: str = "x",
               device=None) -> Dict[str, List[float]]:
    """Returns the metric history (``loss``, ``step_time``, ``step``,
    ``straggler`` and, with a controller, ``retune_events``). Resumes from
    ``run_cfg.checkpoint_dir`` if it holds a checkpoint. ``key`` is the
    weights' seed (default ``run_cfg.seed``); ``mesh`` a one-rank mesh for
    ``"gspmd"`` or a mesh of several ranks whose every rank calls this
    loop, and for the explicit modes the ring (axis ``axis``) whose every
    rank calls this loop."""
    if loop_cfg.step_mode not in STEP_MODES:
        raise ValueError(f"unknown step_mode {loop_cfg.step_mode!r}; "
                         "use 'gspmd', 'explicit_tp', or 'explicit_sp'")
    explicit = loop_cfg.step_mode != "gspmd"
    if explicit and mesh is None:
        raise ValueError("explicit step_mode requires a mesh")
    device = resolve_device(device)
    model = build_model(model_cfg)
    dataset = SyntheticLMDataset(data_cfg)
    state = init_train_state(model, run_cfg.seed if key is None else key,
                             device=device)
    ranks = _Ranks(mesh, axis, explicit, model, loop_cfg.zero1)
    start_step, resumed = 0, False

    manager = None
    if run_cfg.checkpoint_dir:
        manager = ckpt.CheckpointManager(
            run_cfg.checkpoint_dir, every=run_cfg.checkpoint_every,
            keep=run_cfg.keep_checkpoints)
        ranks.barrier()  # no rank reads while another still writes
        if manager.has_checkpoint:
            # the explicit layout lands on the *current* mesh: the elastic
            # path when it differs from the saving mesh
            start_step, trees, _ = manager.restore_latest(
                {"state": state}, reshard_to=mesh if explicit else None,
                axis=axis)
            state = trees["state"]
            resumed = True
            log.info("resumed from checkpoint step %d", start_step)
    if explicit and not resumed:
        state = shard_whole_model_state(state, mesh, axis)
    elif not explicit and ranks.ax is not None:
        # the GSPMD layout, from step 0's state or the restored whole one
        state = shard_state(state, mesh, zero1=loop_cfg.zero1)

    def build_step():
        if explicit:
            return make_whole_model_train_step_explicit(
                model, run_cfg, mesh, axis=axis,
                attn_mode=loop_cfg.step_mode[len("explicit_"):],
                total_steps=loop_cfg.steps)
        return make_train_step(model, run_cfg, mesh, zero1=loop_cfg.zero1,
                               total_steps=loop_cfg.steps)

    step_fn = build_step()
    monitor = StragglerMonitor(deadline_factor=run_cfg.step_deadline_factor,
                               policy=loop_cfg.straggler_policy)
    retuner = loop_cfg.retune
    schedule = loop_cfg.fault_schedule
    history: Dict[str, List[float]] = {"loss": [], "step_time": [],
                                       "step": []}

    for step in range(start_step, loop_cfg.steps):
        if schedule is not None:
            schedule.apply(step)
            lost = schedule.injector.lost_ranks
            if lost:
                # the mesh as built no longer exists: surface the loss with
                # the partial history attached, so that train_loop_elastic
                # can rebuild on the survivors and resume
                err = RankLostError(lost, step)
                err.history = history
                raise err
        batch = dataset.batch(step)

        with StepTimer() as t:
            if schedule is not None:
                # inside the timed region: the monitor and the retune
                # controller both see the injected degradation
                schedule.injector.sleep("train.step")
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
        straggled = monitor.record(step, t.duration)

        if retuner is not None:
            if straggled and monitor.policy == "retune":
                event = retuner.on_straggler(step)
            else:
                event = retuner.observe(step, t.duration)
            if event is not None and explicit:
                # resolutions swapped: rebuild the step, as the reference
                # rebuilds its jitted one
                step_fn = build_step()

        history["loss"].append(loss)
        history["step_time"].append(t.duration)
        history["step"].append(step)
        if step % loop_cfg.log_every == 0:
            log.info("step %d loss %.4f (%.3fs)", step, loss, t.duration)

        next_step = step + 1
        if loop_cfg.fail_at_step is not None and \
                next_step == loop_cfg.fail_at_step:
            raise InjectedFailure(f"injected failure before step {next_step}")

        if manager is not None:
            if ranks.any(straggled and monitor.policy == "checkpoint"):
                ranks.save(manager, next_step, state,
                           extra={"loss": loss, "forced": True}, force=True)
            else:
                ranks.save(manager, next_step, state, extra={"loss": loss},
                           force=False)

    if manager is not None:
        ranks.save(manager, loop_cfg.steps, state, extra={"final": True},
                   force=True)
    history["straggler"] = monitor.summary()  # type: ignore[assignment]
    if retuner is not None:
        history["retune_events"] = retuner.events  # type: ignore[assignment]
    return history


def largest_divisible(survivors: int, global_batch: int) -> int:
    """The largest rank count <= ``survivors`` dividing ``global_batch``:
    the biggest mesh the fixed batch reshards onto evenly."""
    if survivors < 1:
        raise ValueError(f"no survivors ({survivors})")
    for n in range(survivors, 1, -1):
        if global_batch % n == 0:
            return n
    return 1


def train_loop_elastic(model_cfg: ModelConfig, run_cfg: RunConfig,
                       data_cfg: DataConfig, loop_cfg: TrainLoopConfig, *,
                       mesh, key: Optional[int] = None,
                       snapshot_dir: Optional[str] = None, axis: str = "x",
                       device=None
                       ) -> Tuple[Dict[str, List[float]], Optional[Dict]]:
    """:func:`train_loop` that survives a scripted rank loss, called by
    every process of the world (reference ``train/loop.py:220-289``).

    Runs the loop on ``mesh``; when the fault schedule fires ``fail_rank``
    every process sees :class:`~repro_torch.comm.faults.RankLostError` at
    the same step, and then

    1. the new mesh is the first :func:`largest_divisible` (survivors,
       global batch) survivors of ``mesh``'s axis, in axis order (the batch
       layout, not the hardware, caps elasticity). Every process of the
       world enters its ``dist.new_group``, the lost rank's and the idle
       survivors' too, as torch requires;
    2. with ``snapshot_dir``, the new mesh's first rank copies the
       checkpoint directory there before anyone resumes, behind a barrier
       of the world (so that a control run can restore the exact
       checkpoint the recovery used);
    3. the injector forgets the lost ranks (the one-shot schedule does not
       fire again) and the new mesh's ranks re-enter :func:`train_loop`,
       whose auto-resume restores the latest checkpoint resharded onto it.

    Returns ``(history, recovery)``: the merged history (the steps before
    the resumed one, then the resumed run's) and a recovery record (None
    when no rank was lost) with the lost ranks, the fail and resume steps,
    the old and new mesh sizes and the recovery's seconds. A process
    outside the new mesh returns its history so far and a record with
    ``"sat_out": True``."""
    try:
        return train_loop(model_cfg, run_cfg, data_cfg, loop_cfg,
                          mesh=mesh, key=key, axis=axis,
                          device=device), None
    except RankLostError as e:
        t0 = time.perf_counter()
        if not run_cfg.checkpoint_dir:
            raise RuntimeError(
                "elastic recovery needs run_cfg.checkpoint_dir") from e
        old = mesh.axis(axis).ranks
        survivors = [g for i, g in enumerate(old) if i not in e.ranks]
        if not survivors:
            raise RuntimeError("every rank lost; nothing to resume on") from e
        n = largest_divisible(len(survivors), data_cfg.global_batch)
        new_mesh = sub_ring_mesh(survivors[:n], axis)
        log.warning("rank(s) %s lost at step %d; resuming on %d survivors",
                    e.ranks, e.step, n)
        if snapshot_dir is not None and new_mesh is not None \
                and new_mesh.axis(axis).index == 0:
            shutil.copytree(run_cfg.checkpoint_dir, snapshot_dir,
                            dirs_exist_ok=True)
        if dist.is_initialized():
            dist.barrier()  # the whole world: no one resumes before the copy
        schedule = loop_cfg.fault_schedule
        if schedule is not None:
            schedule.injector.restore_ranks()
        partial = getattr(e, "history", None) or {}
        recovery = {"lost_ranks": list(e.ranks), "fail_step": e.step,
                    "old_size": len(old), "new_size": n}
        if new_mesh is None:
            recovery.update(sat_out=True, resume_step=None,
                            recovery_s=time.perf_counter() - t0)
            return dict(partial), recovery
        resumed = train_loop(model_cfg, run_cfg, data_cfg, loop_cfg,
                             mesh=new_mesh, key=key, axis=axis,
                             device=device)
        recovery.update(
            sat_out=False,
            resume_step=(int(resumed["step"][0]) if resumed["step"]
                         else e.step),
            recovery_s=time.perf_counter() - t0)
        merged: Dict[str, List[float]] = dict(resumed)
        pre_steps = list(partial.get("step", ()))
        for k in ("loss", "step_time", "step"):
            merged[k] = [v for s, v in zip(pre_steps, partial.get(k, ()))
                         if s < recovery["resume_step"]] \
                + list(resumed.get(k, ()))
        return merged, recovery
