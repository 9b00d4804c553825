"""Deterministic fault injection: degraded/down links and lost ranks.

Port of ``repro/comm/faults.py``. The paper's barrier discipline ("the
slowest execution time among all FPGAs is reported") means one degraded
link paces the whole machine, and its circuit-switched network can
silently fall back to slower routing: the failure mode a long-running job
must detect and adapt to, not just measure once. This module makes that
failure mode injectable, three ways, all driven by the same
:class:`FaultInjector`:

* **Cost-model view** — :meth:`FaultInjector.hardware_view` returns a
  :class:`~repro_torch.comm.types.HardwareModel` with per-hop latency
  inflated by ``alpha_scale`` and link bandwidth deflated by
  ``beta_scale`` for the worst fault touching the queried axes. Feeding it
  to a :class:`~repro_torch.comm.autotune.CostModel` (or through
  ``CollectiveEngine.invalidate_resolutions(hw=...)``) makes the analytic
  ranking, and therefore ``schedule="auto"``, see the slow link.
* **Measured mode** — while an injector is :func:`activate`-d,
  :func:`repro_torch.comm.autotune.autotune_mesh` adds
  :func:`measured_extra_time` to every timed job: the degraded-minus-clean
  analytic cost of that exact ``(op, schedule, nbytes, axes)`` run, so
  measured winners flip consistently with the perturbed model
  (``delay_scale`` amplifies the deltas above the host's timing noise).
  The port times its jobs in spawned gloo processes, which never see this
  process's injector, so the delay is added in the process that called
  ``autotune_mesh``, after the ranks' times are gathered.
* **Host-side delays** — :meth:`FaultInjector.sleep` stalls the host
  around a tagged callsite's step, how a training or serving loop observes
  degradation as wall-clock drift.

Beyond degradation, the same injector models hard failures, the
circuit-switched network's binary mode. :meth:`FaultInjector.down_link`
marks a link unestablishable; the mask (:meth:`FaultInjector.down_links`)
reaches the cost model as ``CostModel.health``, so any route traversing a
down link prices as infinite and resolution reroutes (``chain_rooted``)
or falls back to ``staged``. :meth:`FaultInjector.fail_rank` declares a
rank lost; consuming loops raise :class:`RankLostError`.

:class:`FaultSchedule` scripts a timeline over all of these ("degrade
link at step k, heal at step m", "down at k", "fail_rank at k"),
consumable by ``repro_torch.benchmarks.failover_bench`` and
``repro_torch.benchmarks.resilience_bench`` and, via
:meth:`FaultSchedule.parse`, by a command-line flag.

The default hardware is the port's :data:`~repro_torch.comm.types.H100_80GB`.
Everything is seedable and deterministic: with ``jitter=0`` (default) two
runs of the same schedule inject byte-identical perturbations, and with a
seed the jitter draws equal the reference's draw for draw
(``np.random.default_rng``).
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.comm.topology import AxisTopology
from repro_torch.comm.types import H100_80GB, HardwareModel

FAULT_ACTIONS = ("degrade", "heal", "delay", "clear_delay", "down",
                 "fail_rank")


class RankLostError(RuntimeError):
    """A scripted rank loss fired: the mesh as built no longer exists.

    Raised by loops that consume a :class:`FaultSchedule` when
    :meth:`FaultInjector.lost_ranks` becomes non-empty. Carries enough to
    rebuild: which ranks died and at which loop step.
    """

    def __init__(self, ranks, step: int):
        self.ranks = tuple(sorted(ranks))
        self.step = int(step)
        super().__init__(
            f"rank(s) {self.ranks} lost at step {self.step}")


@dataclass(frozen=True)
class LinkFault:
    """One faulted link: hop ``hop`` of mesh axis ``axis``.

    Soft fault (``down=False``): ``alpha_scale`` multiplies the per-hop
    latency, ``beta_scale`` divides the link bandwidth. Under the barrier
    discipline every ring pass on the faulted axis is paced by the slow
    link, so the degraded view reprices the whole axis at the faulted
    numbers.

    Hard fault (``down=True``): the circuit cannot be established at all.
    A down link never contributes scales; it surfaces as a link-health mask
    (:meth:`FaultInjector.down_links`) that the cost model prices as
    infinite and schedule resolution must route around.
    """
    axis: str
    hop: int = 0
    alpha_scale: float = 1.0
    beta_scale: float = 1.0
    down: bool = False

    def __post_init__(self):
        if self.alpha_scale < 1.0 or self.beta_scale < 1.0:
            raise ValueError(
                f"fault scales must be >= 1 (a fault never speeds a link "
                f"up): alpha_scale={self.alpha_scale}, "
                f"beta_scale={self.beta_scale}")


def _axis_names(axes) -> Optional[set]:
    if axes is None:
        return None
    return {a.name if isinstance(a, AxisTopology) else str(a) for a in axes}


class FaultInjector:
    """Deterministic, seedable source of injected link degradation.

    ``hw``           the clean :class:`HardwareModel` degraded views derive
                     from (:data:`H100_80GB` by default).
    ``delay_scale``  multiplies :meth:`extra_time`: amplifies the link
                     deltas into measurable host delays (1.0 = modeled).
    ``jitter``       relative uniform noise on injected delays (0 = exactly
                     reproducible); drawn from ``seed``.
    """

    def __init__(self, *, hw: HardwareModel = H100_80GB, seed: int = 0,
                 delay_scale: float = 1.0, jitter: float = 0.0):
        self.hw = hw
        self.delay_scale = float(delay_scale)
        self.jitter = float(jitter)
        self._rng = np.random.default_rng(seed)
        self._faults: Dict[Tuple[str, int], LinkFault] = {}
        self._host_delays: Dict[Optional[str], float] = {}
        self._lost_ranks: set = set()

    # -- fault state --------------------------------------------------------

    def degrade_link(self, axis: str, hop: int = 0, *,
                     alpha_scale: float = 1.0,
                     beta_scale: float = 1.0) -> LinkFault:
        """Install (or overwrite) the fault on ``(axis, hop)``."""
        fault = LinkFault(axis=axis, hop=hop, alpha_scale=alpha_scale,
                          beta_scale=beta_scale)
        self._faults[(axis, hop)] = fault
        return fault

    def down_link(self, axis: str, hop: int = 0) -> LinkFault:
        """Mark ``(axis, hop)`` hard-down: no circuit, route around it."""
        fault = LinkFault(axis=axis, hop=hop, down=True)
        self._faults[(axis, hop)] = fault
        return fault

    def down_links(self, axes: Optional[Sequence] = None) -> frozenset:
        """The link-health mask: ``frozenset`` of ``(axis, hop)`` pairs
        currently hard-down on the named axes (all axes when ``None``).
        Link ``hop`` is the wire between ranks ``hop`` and ``hop+1 mod n``
        on that axis, severed in both directions."""
        names = _axis_names(axes)
        return frozenset((f.axis, f.hop) for f in self._faults.values()
                         if f.down and (names is None or f.axis in names))

    def fail_rank(self, rank: int) -> None:
        """Declare rank ``rank`` (mesh-linear index) lost. Loops that
        consume a schedule observe :attr:`lost_ranks` and raise
        :class:`RankLostError`."""
        self._lost_ranks.add(int(rank))

    def restore_ranks(self) -> None:
        """Forget lost ranks, once recovery has rebuilt the mesh on the
        survivors, so the resumed loop does not re-fire."""
        self._lost_ranks.clear()

    @property
    def lost_ranks(self) -> frozenset:
        return frozenset(self._lost_ranks)

    def heal(self, axis: Optional[str] = None,
             hop: Optional[int] = None) -> None:
        """Remove faults: all of them, one axis's, or one (axis, hop)."""
        if axis is None:
            self._faults.clear()
            return
        self._faults = {k: f for k, f in self._faults.items()
                        if not (f.axis == axis
                                and (hop is None or f.hop == hop))}

    @property
    def active(self) -> bool:
        return (bool(self._faults) or any(self._host_delays.values())
                or bool(self._lost_ranks))

    @property
    def faults(self) -> Tuple[LinkFault, ...]:
        return tuple(self._faults.values())

    def scales(self, axes: Optional[Sequence] = None) -> Tuple[float, float]:
        """``(alpha_scale, beta_scale)`` the barrier discipline imposes on
        the named axes (axis names or :class:`AxisTopology`): the worst
        fault touching any of them; ``(1.0, 1.0)`` when clean. ``axes=None``
        means every axis."""
        names = _axis_names(axes)
        hit = [f for f in self._faults.values()
               if not f.down and (names is None or f.axis in names)]
        return (max((f.alpha_scale for f in hit), default=1.0),
                max((f.beta_scale for f in hit), default=1.0))

    # -- degraded views -----------------------------------------------------

    def hardware_view(self, hw: Optional[HardwareModel] = None,
                      axes: Optional[Sequence] = None) -> HardwareModel:
        """``hw`` with the active faults' scales applied (the object itself,
        unchanged, when no fault touches ``axes``)."""
        hw = hw or self.hw
        a, b = self.scales(axes)
        if a == 1.0 and b == 1.0:
            return hw
        return replace(hw, ici_latency=hw.ici_latency * a,
                       ici_link_bw=hw.ici_link_bw / b)

    def cost_model_view(self, hw: Optional[HardwareModel] = None):
        """A fresh analytic :class:`~repro_torch.comm.autotune.CostModel` on
        the degraded hardware, carrying the link-health mask so down links
        price as infinite. Deliberately table-free: measured tuning entries
        predate the fault and would report the clean winners."""
        from repro_torch.comm.autotune import CostModel
        return CostModel(hw=self.hardware_view(hw), table=None,
                         health=self.down_links())

    def extra_time(self, op: str, schedule: str, nbytes: float,
                   axes: Sequence[AxisTopology],
                   hw: Optional[HardwareModel] = None) -> float:
        """Injected wall-clock seconds for one ``(op, schedule)`` run over
        ``axes``: degraded-minus-clean analytic cost, times ``delay_scale``
        (plus seeded jitter). Zero when no fault touches the axes or the
        model has no formula for the schedule. Infinite when the run's
        route traverses a hard-down link: a circuit that cannot be
        established never completes."""
        from repro_torch.comm.autotune import (_seg_time, canonical_health,
                                               route_links, segments)
        hw = hw or self.hw
        down = self.down_links(axes)
        if down:
            # route_links reports canonical link ids (size-2 hop aliasing),
            # so the mask must be canonicalized before intersecting
            down = canonical_health(down, axes)
            links = route_links(op, schedule, axes, health=down)
            if links is None or links & down:
                return float("inf")
        dhw = self.hardware_view(hw, axes)
        if dhw is hw:
            return 0.0
        segs = segments(op, schedule, nbytes, axes, hw)
        if segs is None:
            return 0.0
        extra = sum(_seg_time(s, dhw) - _seg_time(s, hw) for s in segs)
        extra = max(extra, 0.0) * self.delay_scale
        if self.jitter > 0.0:
            extra *= 1.0 + self.jitter * float(self._rng.uniform(-1.0, 1.0))
        return extra

    # -- host-side delays ---------------------------------------------------

    def add_host_delay(self, callsite: Optional[str],
                       seconds: float) -> None:
        """Stall :meth:`sleep` callers by ``seconds``; ``callsite=None``
        applies to every callsite."""
        self._host_delays[callsite] = float(seconds)

    def clear_host_delay(self, callsite: Optional[str] = None) -> None:
        self._host_delays.pop(callsite, None)

    def host_delay(self, callsite: Optional[str] = None) -> float:
        d = self._host_delays.get(None, 0.0)
        if callsite is not None:
            d += self._host_delays.get(callsite, 0.0)
        return d

    def sleep(self, callsite: Optional[str] = None) -> float:
        """Sleep the registered host delay for ``callsite``; returns it."""
        d = self.host_delay(callsite)
        if d > 0.0:
            time.sleep(d)
        return d


# ---------------------------------------------------------------------------
# module-level activation (the measured-mode hook)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultInjector] = None


def activate(injector: FaultInjector) -> FaultInjector:
    """Make ``injector`` the process-wide active one: the measured mode
    (:func:`repro_torch.comm.autotune.autotune_mesh`) consults it through
    :func:`measured_extra_time`."""
    global _ACTIVE
    _ACTIVE = injector
    return injector


def deactivate() -> None:
    global _ACTIVE
    _ACTIVE = None


def active_injector() -> Optional[FaultInjector]:
    return _ACTIVE


@contextmanager
def injected(injector: FaultInjector):
    """``with injected(inj): ...``: scoped :func:`activate`."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = injector
    try:
        yield injector
    finally:
        _ACTIVE = prev


def measured_extra_time(op: str, schedule: str, nbytes: float,
                        axes: Sequence[AxisTopology],
                        hw: Optional[HardwareModel] = None) -> float:
    """The active injector's :meth:`FaultInjector.extra_time` (0 clean)."""
    if _ACTIVE is None:
        return 0.0
    return _ACTIVE.extra_time(op, schedule, nbytes, axes, hw)


# ---------------------------------------------------------------------------
# scripted fault timelines
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FaultEvent:
    """One scripted action at loop step ``step``.

    ``action`` is one of :data:`FAULT_ACTIONS`: ``degrade`` installs a
    :class:`LinkFault` on ``(axis, hop)``; ``down`` marks that link
    hard-down; ``heal`` removes either; ``delay`` / ``clear_delay`` manage
    a host-side stall for ``callsite``; ``fail_rank`` declares mesh-linear
    rank ``rank`` lost.
    """
    step: int
    action: str
    axis: str = "x"
    hop: int = 0
    alpha_scale: float = 1.0
    beta_scale: float = 1.0
    seconds: float = 0.0
    callsite: Optional[str] = None
    rank: int = 0

    def __post_init__(self):
        if self.action not in FAULT_ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}; "
                             f"actions are {FAULT_ACTIONS}")


class FaultSchedule:
    """A scripted timeline of :class:`FaultEvent`-s over one injector.

    The consuming loop calls :meth:`apply` once per step; events whose
    ``step`` matches fire (idempotently: installing the same fault twice
    overwrites, healing an absent one no-ops), and land in ``applied`` for
    provenance. Steps are loop-local indices, so the same schedule drives a
    train loop, a serve loop, or a benchmark unchanged.
    """

    def __init__(self, injector: FaultInjector,
                 events: Sequence[FaultEvent]):
        self.injector = injector
        self.events: Tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: e.step))
        self.applied: List[FaultEvent] = []

    @classmethod
    def degrade_window(cls, injector: FaultInjector, start: int, end: int, *,
                       axis: str = "x", hop: int = 0,
                       alpha_scale: float = 1.0, beta_scale: float = 1.0,
                       host_delay_s: float = 0.0,
                       callsite: Optional[str] = None) -> "FaultSchedule":
        """The canonical script: degrade at ``start``, heal at ``end``,
        optionally stalling ``callsite`` by ``host_delay_s`` meanwhile."""
        if end <= start:
            raise ValueError(f"degrade window [{start}, {end}) is empty")
        events = [FaultEvent(start, "degrade", axis=axis, hop=hop,
                             alpha_scale=alpha_scale, beta_scale=beta_scale),
                  FaultEvent(end, "heal", axis=axis, hop=hop)]
        if host_delay_s > 0.0:
            events += [FaultEvent(start, "delay", seconds=host_delay_s,
                                  callsite=callsite),
                       FaultEvent(end, "clear_delay", callsite=callsite)]
        return cls(injector, events)

    @classmethod
    def down_window(cls, injector: FaultInjector, start: int, end: int, *,
                    axis: str = "x", hop: int = 0) -> "FaultSchedule":
        """Hard variant of :meth:`degrade_window`: link down at ``start``,
        restored at ``end``."""
        if end <= start:
            raise ValueError(f"down window [{start}, {end}) is empty")
        return cls(injector, [FaultEvent(start, "down", axis=axis, hop=hop),
                              FaultEvent(end, "heal", axis=axis, hop=hop)])

    @classmethod
    def rank_loss(cls, injector: FaultInjector, step: int, *,
                  rank: int) -> "FaultSchedule":
        """Lose mesh-linear rank ``rank`` at ``step``."""
        return cls(injector, [FaultEvent(step, "fail_rank", rank=rank)])

    @classmethod
    def parse(cls, injector: FaultInjector, spec: str) -> "FaultSchedule":
        """Build a schedule from a spec string.

        Grammar: events separated by ``;``, each
        ``action@start[-end][:key=value,...]``:

        * ``degrade@5-20:axis=x,hop=1,beta_scale=64``: soft window
          (``-end`` appends the matching ``heal``);
        * ``down@5-20:axis=x,hop=3``: hard-down window;
        * ``delay@5-20:seconds=0.05,callsite=train.step``: host stall
          window (``-end`` appends ``clear_delay``);
        * ``fail_rank@12:rank=3``: rank loss (no window form).
        """
        events: List[FaultEvent] = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            head, _, tail = part.partition(":")
            action, at, when = head.partition("@")
            action = action.strip()
            if action not in FAULT_ACTIONS or not at:
                raise ValueError(
                    f"bad fault event {part!r}: want "
                    f"action@start[-end][:k=v,...] with action in "
                    f"{FAULT_ACTIONS}")
            start_s, _, end_s = when.partition("-")
            start = int(start_s)
            end = int(end_s) if end_s else None
            kw: Dict[str, object] = {}
            for item in filter(None, (s.strip() for s in tail.split(","))):
                k, _, v = item.partition("=")
                if k in ("hop", "rank"):
                    kw[k] = int(v)
                elif k in ("alpha_scale", "beta_scale", "seconds"):
                    kw[k] = float(v)
                elif k in ("axis", "callsite"):
                    kw[k] = v
                else:
                    raise ValueError(f"unknown fault spec key {k!r} "
                                     f"in {part!r}")
            events.append(FaultEvent(start, action, **kw))
            if end is not None:
                if action in ("degrade", "down"):
                    events.append(FaultEvent(
                        end, "heal", axis=kw.get("axis", "x"),
                        hop=kw.get("hop", 0)))
                elif action == "delay":
                    events.append(FaultEvent(
                        end, "clear_delay", callsite=kw.get("callsite")))
                else:
                    raise ValueError(
                        f"{action!r} does not take a window: {part!r}")
        return cls(injector, events)

    def apply(self, step: int) -> List[FaultEvent]:
        """Fire every event scheduled for ``step``; returns them.

        Soft events are effect-idempotent (re-applying a fired step
        overwrites the same fault, never stacks it), so they may re-fire.
        ``fail_rank`` is strictly one-shot: a loop resumed from a
        checkpoint re-enters the step range and must not re-lose the rank
        it just recovered from.
        """
        fired = []
        for e in self.events:
            if e.step != step:
                continue
            if e.action == "fail_rank" and any(a is e for a in self.applied):
                continue
            if e.action == "degrade":
                self.injector.degrade_link(e.axis, e.hop,
                                           alpha_scale=e.alpha_scale,
                                           beta_scale=e.beta_scale)
            elif e.action == "down":
                self.injector.down_link(e.axis, e.hop)
            elif e.action == "heal":
                self.injector.heal(e.axis, e.hop)
            elif e.action == "delay":
                self.injector.add_host_delay(e.callsite, e.seconds)
            elif e.action == "clear_delay":
                self.injector.clear_host_delay(e.callsite)
            else:  # fail_rank
                self.injector.fail_rank(e.rank)
            fired.append(e)
            self.applied.append(e)
        return fired

    @property
    def span(self) -> Tuple[int, int]:
        """(first, last) scheduled step."""
        return (self.events[0].step, self.events[-1].step) if self.events \
            else (0, 0)
