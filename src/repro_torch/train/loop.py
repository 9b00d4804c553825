"""Fault-tolerant training loop on one rank.

Port of ``repro/train/loop.py`` (``train_loop`` in ``step_mode="gspmd"``,
``largest_divisible``):

* auto-resume: on start, if the checkpoint directory holds a valid step,
  restore it;
* periodic atomic checkpoints, and a forced one when the straggler policy
  is 'checkpoint' and a step blows its deadline;
* crash injection for tests: ``fail_at_step`` raises after the optimizer
  update but before that step's checkpoint, so a restart loses at most
  ``checkpoint_every`` steps;
* deterministic data: batches are a pure function of (seed, step), so a
  resumed run consumes exactly the batches the crashed run would have;
* a scripted fault timeline (:class:`repro_torch.comm.faults.
  FaultSchedule`) applied at each step's start, its host delay inside the
  timed region, and a retune controller fed every step's duration.

The loop runs :func:`repro_torch.train.step.make_train_step` on the
one-rank mesh, on the card unless ``device="cpu"``. A fault schedule that
declares a rank lost raises :class:`~repro_torch.comm.faults.RankLostError`
as in the reference. The explicit step modes (``"explicit_tp"``,
``"explicit_sp"``) and ``train_loop_elastic`` wait for ROADMAP A12's second
half (the parallel model, ``checkpoint.restore(reshard_to=)``).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch import checkpoint as ckpt
from repro_torch.comm.faults import RankLostError
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.hpcc import resolve_device
from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
from repro_torch.models.model import build_model
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.train.straggler import StepTimer, StragglerMonitor

log = logging.getLogger("repro_torch.train")

STEP_MODES = ("gspmd", "explicit_tp", "explicit_sp")


@dataclass
class TrainLoopConfig:
    steps: int = 100
    log_every: int = 10
    fail_at_step: Optional[int] = None  # crash injection (tests)
    # "gspmd" (the one-rank step) | "explicit_tp" | "explicit_sp" (the
    # whole-model explicit steps, ROADMAP A12's second half)
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
    # observes every step duration
    retune: Optional[object] = None


class InjectedFailure(RuntimeError):
    pass


def train_loop(model_cfg: ModelConfig, run_cfg: RunConfig,
               data_cfg: DataConfig, loop_cfg: TrainLoopConfig, *,
               mesh=None, key: Optional[int] = None,
               device=None) -> Dict[str, List[float]]:
    """Returns the metric history (``loss``, ``step_time``, ``step``,
    ``straggler`` and, with a controller, ``retune_events``). Resumes from
    ``run_cfg.checkpoint_dir`` if it holds a checkpoint. ``key`` is the
    weights' seed (default ``run_cfg.seed``); ``mesh`` a one-rank mesh."""
    if loop_cfg.step_mode not in STEP_MODES:
        raise ValueError(f"unknown step_mode {loop_cfg.step_mode!r}; "
                         "use 'gspmd', 'explicit_tp', or 'explicit_sp'")
    if loop_cfg.step_mode != "gspmd":
        raise NotImplementedError(
            f"step_mode={loop_cfg.step_mode!r} runs the whole-model "
            "explicit step, which needs the parallel model of ROADMAP "
            "A12's second half")
    device = resolve_device(device)
    model = build_model(model_cfg)
    dataset = SyntheticLMDataset(data_cfg)
    state = init_train_state(model, run_cfg.seed if key is None else key,
                             device=device)
    start_step = 0

    manager = None
    if run_cfg.checkpoint_dir:
        manager = ckpt.CheckpointManager(
            run_cfg.checkpoint_dir, every=run_cfg.checkpoint_every,
            keep=run_cfg.keep_checkpoints)
        if manager.has_checkpoint:
            start_step, trees, _ = manager.restore_latest({"state": state})
            state = trees["state"]
            log.info("resumed from checkpoint step %d", start_step)

    step_fn = make_train_step(model, run_cfg, mesh,
                              total_steps=loop_cfg.steps)
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
                # the partial history attached
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
                retuner.on_straggler(step)
            else:
                retuner.observe(step, t.duration)

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
            if straggled and monitor.policy == "checkpoint":
                manager.save(next_step, {"state": state},
                             extra={"loss": loss, "forced": True}, force=True)
            else:
                manager.maybe_save(next_step, {"state": state},
                                   extra={"loss": loss})

    if manager is not None:
        manager.save(loop_cfg.steps, {"state": state}, extra={"final": True},
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
                       snapshot_dir: Optional[str] = None):
    """The reference's rank-loss recovery around :func:`train_loop`
    (rebuild the mesh on the survivors, restore the checkpoint resharded
    onto it, resume). It needs a mesh of several ranks for the step and
    ``checkpoint.restore(reshard_to=)``, both of ROADMAP A12's second
    half."""
    raise NotImplementedError(
        "train_loop_elastic resumes on a survivor mesh, which needs the "
        "sharded step and checkpoint.restore(reshard_to=) of ROADMAP A12's "
        "second half")
