"""The port's fault-tolerant training loop on the CPU: the cases of the
reference's ``tests/test_train_loop.py``, held against the reference where
they compute the same thing.

The loop trains a reduced llama3.2-3b (2 layers, d_model 32; batch 4 x 32
synthetic tokens; lr 1e-2 after 2 warmup steps). Its losses decrease; a run
crashed at step 12 and resumed from its step-10 checkpoint equals the
uninterrupted run bit for bit (losses and final state). Both start from
the reference's initial weights, written as the loop's step-0 checkpoint,
so the uninterrupted run is also held against ``repro.train.loop.
train_loop`` on the same configuration: losses within rtol 1e-4 over 14
steps (the port sums in other orders).

The straggler tests run on a fake clock (ROADMAP C4: the reference's
assert wall-clock deadlines and are flaky when the suite runs in parallel):
``StepTimer``'s ``perf_counter`` advances by :data:`TICK` per call and the
fault injector's ``sleep`` adds exactly its delay, so every step takes one
tick plus its injected delay, whatever the machine's load.
"""
from __future__ import annotations

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import DataConfig as JDataConfig
from repro.train import loop as jloop
from repro.train import step as jstep
from repro.train import straggler as jstraggler
from repro_torch import checkpoint as ckpt
from repro_torch.benchmarks import resilience_bench
from repro_torch.comm import faults
from repro_torch.comm.faults import (FaultInjector, FaultSchedule,
                                     RankLostError)
from repro_torch.configs import RunConfig, get_config, reduced
from repro_torch.data import DataConfig
from repro_torch.models.model import state_from_reference
from repro_torch.train import straggler
from repro_torch.train.loop import (InjectedFailure, TrainLoopConfig,
                                    largest_divisible, train_loop,
                                    train_loop_elastic)
from repro_torch.train.straggler import POLICIES, StragglerMonitor

TICK = 0.01  # seconds per clock reading on the fake clock


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's tiny models: under six test
    workers the default (one thread per core in every process)
    oversubscribes the cores and slows each small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(tmp_path, every=5):
    cfg = reduced(get_config("llama3.2-3b"), layers=2, d_model=32)
    run = RunConfig(checkpoint_dir=str(tmp_path / "ck"),
                    checkpoint_every=every, learning_rate=1e-2,
                    warmup_steps=2)
    data = DataConfig(vocab_size=cfg.vocab_size, global_batch=4, seq_len=32)
    return cfg, run, data


def _cfgs_noop():
    cfg = reduced(get_config("llama3.2-3b"), layers=2, d_model=32)
    run = RunConfig(learning_rate=1e-2, warmup_steps=2)  # no checkpointing
    data = DataConfig(vocab_size=cfg.vocab_size, global_batch=4, seq_len=32)
    return cfg, run, data


@pytest.fixture
def clock(monkeypatch):
    """A fake clock for ``StepTimer`` and the injector's ``sleep``."""
    now = [0.0]

    def perf_counter():
        now[0] += TICK
        return now[0]

    def sleep(seconds):
        now[0] += seconds

    fake = types.SimpleNamespace(perf_counter=perf_counter, sleep=sleep)
    monkeypatch.setattr(straggler, "time", fake)
    monkeypatch.setattr(faults, "time", fake)
    return now


@pytest.fixture(scope="module")
def reference_start():
    """The reference's initial state for the loop's configuration (its
    ``init_train_state`` under ``jax.random.key(run.seed)``, run eagerly
    as the reference loop runs it: after the loop its operations are
    compiled already), and the reference loop's losses over 14 steps."""
    cfg, run, data = _cfgs_noop()
    jcfg = jconfigs.ModelConfig(**dataclasses.asdict(cfg))
    hist = jloop.train_loop(
        jcfg, jconfigs.RunConfig(**dataclasses.asdict(run)),
        JDataConfig(**dataclasses.asdict(data)),
        jloop.TrainLoopConfig(steps=14))
    state = jax.tree.map(np.asarray, jstep.init_train_state(
        jloop.build_model(jcfg), jax.random.key(run.seed)))
    return state, hist["loss"]


def _seed_checkpoint(run, cfg, state_np):
    ckpt.save(run.checkpoint_dir, 0, {"state": state_from_reference(
        cfg, state_np, device="cpu")})


def test_loss_decreases(tmp_path):
    cfg, run, data = _cfgs(tmp_path)
    hist = train_loop(cfg, run, data, TrainLoopConfig(steps=14),
                      device="cpu")
    assert hist["loss"][-1] < hist["loss"][0]
    assert hist["step"] == list(range(14))


def test_crash_resume_bit_exact(tmp_path, reference_start):
    state_np, ref_losses = reference_start
    cfg, run, data = _cfgs(tmp_path / "crash")
    _seed_checkpoint(run, cfg, state_np)
    with pytest.raises(InjectedFailure):
        train_loop(cfg, run, data, TrainLoopConfig(steps=14, fail_at_step=12),
                   device="cpu")
    resumed = train_loop(cfg, run, data, TrainLoopConfig(steps=14),
                         device="cpu")
    assert resumed["step"] == list(range(10, 14))  # from the step-10 save

    cfg2, run2, data2 = _cfgs(tmp_path / "fresh")
    _seed_checkpoint(run2, cfg2, state_np)
    clean = train_loop(cfg2, run2, data2, TrainLoopConfig(steps=14),
                       device="cpu")
    assert clean["step"] == list(range(14))
    assert resumed["loss"] == clean["loss"][10:]
    final = [ckpt.restore(r.checkpoint_dir, {}, step=14)[0] for r in (run,
                                                                      run2)]
    assert final == [14, 14]
    a = np.load(f"{run.checkpoint_dir}/step_0000000014/state.npz")
    b = np.load(f"{run2.checkpoint_dir}/step_0000000014/state.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_allclose(clean["loss"], ref_losses, rtol=1e-4)


def test_straggler_monitor_flags():
    mon = StragglerMonitor(deadline_factor=2.0)
    for i in range(10):
        assert not mon.record(i, 0.1)
    assert mon.record(10, 0.5)           # 5x median -> flagged
    assert not mon.record(11, 0.15)
    assert list(mon.flagged) == [10]
    s = mon.summary()
    assert s["median_s"] == pytest.approx(0.1, rel=0.2)
    assert mon.deadline() == pytest.approx(0.2, rel=0.2)


@pytest.mark.parametrize("factor,window", [(2.0, 128), (3.0, 8), (1.5, 5)])
def test_straggler_monitor_matches_reference(factor, window):
    rng = np.random.default_rng(int(factor * 10) + window)
    times = rng.lognormal(-2.0, 0.6, 60).tolist()
    mon = StragglerMonitor(deadline_factor=factor, window=window)
    jmon = jstraggler.StragglerMonitor(deadline_factor=factor, window=window)
    for i, t in enumerate(times):
        assert mon.record(i, t) == jmon.record(i, t)
        assert mon.deadline() == jmon.deadline()
    assert mon.summary() == jmon.summary()


def test_straggler_policy_validated():
    assert POLICIES == jstraggler.POLICIES == ("warn", "checkpoint",
                                               "retune")
    with pytest.raises(ValueError, match="straggler policy"):
        StragglerMonitor(policy="evict")
    with pytest.raises(ValueError, match="straggler policy"):
        train_loop(*_cfgs_noop(), TrainLoopConfig(
            steps=1, straggler_policy="evict"), device="cpu")


def test_forced_checkpoint_on_injected_straggler(tmp_path, clock):
    """An injected host delay blows the step deadline; under policy
    'checkpoint' every flagged step forces an off-cadence save."""
    cfg, run, data = _cfgs(tmp_path, every=100)  # cadence never hits
    inj = FaultInjector()
    fault = FaultSchedule.degrade_window(inj, 9, 11, axis="x",
                                         host_delay_s=0.3,
                                         callsite="train.step")
    hist = train_loop(cfg, run, data, TrainLoopConfig(
        steps=12, straggler_policy="checkpoint", fault_schedule=fault),
        device="cpu")

    assert hist["step_time"] == pytest.approx(
        [TICK] * 9 + [TICK + 0.3] * 2 + [TICK])
    flagged = hist["straggler"]["flagged"]
    assert flagged == [9, 10]  # only the injected window
    steps = ckpt.all_steps(str(tmp_path / "ck"))
    forced = [s for s in steps
              if ckpt.restore(str(tmp_path / "ck"), {},
                              step=s)[2].get("forced")]
    assert forced == [s + 1 for s in flagged]  # saved right after each flag
    assert steps[-1] == 12  # the final save still lands


def test_retune_policy_routes_straggler_flags(clock):
    """Under policy 'retune' a flagged step goes to the controller's
    ``on_straggler``; nominal steps feed ``observe``. The loop needs only
    ``observe``, ``on_straggler`` and ``events``."""

    class _FakeController:
        def __init__(self):
            self.observed, self.straggled, self.events = [], [], []

        def observe(self, step, duration):
            self.observed.append(step)

        def on_straggler(self, step):
            self.straggled.append(step)

    cfg, run, data = _cfgs_noop()
    inj = FaultInjector()
    fault = FaultSchedule.degrade_window(inj, 9, 11, axis="x",
                                         host_delay_s=0.3,
                                         callsite="train.step")
    ctrl = _FakeController()
    hist = train_loop(cfg, run, data, TrainLoopConfig(
        steps=12, straggler_policy="retune", fault_schedule=fault,
        retune=ctrl), device="cpu")

    assert ctrl.straggled == hist["straggler"]["flagged"] == [9, 10]
    assert sorted(ctrl.observed + ctrl.straggled) == list(range(12))
    assert hist["retune_events"] is ctrl.events


def test_rank_loss_raises_with_partial_history():
    cfg, run, data = _cfgs_noop()
    schedule = FaultSchedule.rank_loss(FaultInjector(), 3, rank=1)
    with pytest.raises(RankLostError) as ei:
        train_loop(cfg, run, data, TrainLoopConfig(
            steps=6, fault_schedule=schedule), device="cpu")
    assert ei.value.step == 3 and set(ei.value.ranks) == {1}
    assert ei.value.history["step"] == [0, 1, 2]


@pytest.mark.parametrize("mode", ["explicit_tp", "explicit_sp", "bogus"])
def test_other_step_modes(mode):
    """An unknown mode is refused; the explicit modes need a mesh (the
    reference's ValueError; with one they run on four gloo processes in
    tests/test_torch_parallel.py)."""
    with pytest.raises(ValueError, match="unknown step_mode" if mode ==
                       "bogus" else "explicit step_mode requires a mesh"):
        train_loop(*_cfgs_noop(), TrainLoopConfig(steps=1, step_mode=mode),
                   device="cpu")


def test_train_loop_elastic_waits_for_the_parallel_model():
    """Without a checkpoint directory a rank loss cannot be survived: the
    reference's RuntimeError, chained to the RankLostError (the elastic
    resume itself runs on four gloo processes in
    tests/test_torch_elastic.py)."""
    schedule = FaultSchedule.rank_loss(FaultInjector(), 1, rank=0)
    with pytest.raises(RuntimeError, match="needs run_cfg.checkpoint_dir") \
            as ei:
        train_loop_elastic(*_cfgs_noop(), TrainLoopConfig(
            steps=3, fault_schedule=schedule), mesh=None, device="cpu")
    assert isinstance(ei.value.__cause__, RankLostError)
    assert ei.value.__cause__.step == 1


@pytest.mark.parametrize("survivors,batch", [(3, 8), (4, 8), (3, 9), (7, 4),
                                             (5, 7), (1, 8)])
def test_largest_divisible_matches_reference(survivors, batch):
    assert largest_divisible(survivors, batch) == \
        jloop.largest_divisible(survivors, batch)
    with pytest.raises(ValueError, match="no survivors"):
        largest_divisible(0, batch)


def test_train_degradation_section_and_gate(clock):
    """``resilience_bench``'s train-degradation section on the CPU: the
    delayed steps are flagged and force off-cadence checkpoints, so its
    gate passes; the gate fails a record that saw nothing."""
    sec = resilience_bench.train_degradation_section("cpu")
    lo, hi = resilience_bench.TRAIN_WINDOW
    assert sec["flagged"] == list(range(lo, hi))
    assert sec["detected"] and sec["forced_checkpoints"]
    assert sec["median_during_s"] == pytest.approx(
        TICK + resilience_bench.TRAIN_DELAY_S)
    assert resilience_bench.gate_train_degradation(sec) == []
    assert len(resilience_bench.gate_train_degradation(
        {**sec, "detected": False, "forced_checkpoints": []})) == 2
