"""Adaptive in-run retuning: the static tuning table made a runtime.

Port of ``repro/comm/retune.py``. Schedule winners flip when link
conditions change, so a long-running job must detect drift and re-resolve,
not trust a table measured at startup.

:class:`RetuneController` watches per-callsite step timings. Its state
machine::

    BASELINE --(min_baseline samples)--> WATCH
    WATCH    --(recent median drifts past drift_factor x baseline,
                or a straggler flag)--> RETUNE
    RETUNE   --(re-price / re-measure, invalidate, re-arm)--> BASELINE

Drift detection is two-sided: a degraded link slows steps (ratio above
``drift_factor``), a healed one speeds them (ratio below
``1/drift_factor``). Both mean the current resolutions were priced on
stale conditions, and both trigger.

A retune is narrow: only the hot callsites (the streams that drifted) are
re-resolved. Two refresh paths compose:

* ``hw_probe``: a callable returning the current
  :class:`~repro_torch.comm.types.HardwareModel` (link telemetry; in tests
  and benchmarks :meth:`repro_torch.comm.faults.FaultInjector.hardware_view`).
  The engine's analytic ranking is re-priced on it. Deterministic: what the
  benchmark's gate asserts on. ``health_probe`` is its hard-failure
  sibling, a callable returning the current link-health mask (the
  injector's ``down_links``), so a retune also excludes every route that
  crosses a link that is gone.
* ``measure=True``: a narrow :func:`~repro_torch.comm.autotune.autotune_mesh`
  ladder over only the hot callsites' tagged patterns, at sizes bracketing
  their live payloads; the refreshed winners are merged over the engine's
  table (and saved to ``table_path`` when given). While a fault injector
  is active the measured times include its modeled delays.

  ``autotune_mesh`` spawns gloo worlds of fresh processes. A rank of such a
  world (:func:`~repro_torch.launch.mesh.spawn_mesh`) is a daemon process,
  which cannot start children, so a measured retune runs only in a process
  that is not itself a rank: the controller refuses ``measure=True`` inside
  one rather than hang.

Either way the swap lands through
:meth:`~repro_torch.comm.engine.CollectiveEngine.invalidate_resolutions`:
the engine object persists, and its next ``auto`` lookup resolves fresh.
The controller touches the engine only through ``schedule_for(...,
callsite=)``, ``_model()`` and ``invalidate_resolutions``.
"""
from __future__ import annotations

import multiprocessing
import time
from collections import deque
from dataclasses import dataclass, field
from statistics import median
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

RETUNE_TRIGGERS = ("drift", "straggler", "forced")

_STEP_STREAM = "step"  # the untagged whole-step timing stream


@dataclass(frozen=True)
class Watched:
    """One callsite the controller re-resolves on a retune.

    ``op`` / ``nbytes`` / ``axis`` are the engine resolution key the
    callsite runs at: what ``schedule_for`` is queried with before and
    after the swap, and what sizes the narrow measured ladder brackets.
    """
    callsite: str
    op: str
    nbytes: int
    axis: object  # axis name or tuple of names


@dataclass
class RetuneEvent:
    """Provenance for one retune: what fired it and what it changed."""
    step: int
    trigger: str                       # one of RETUNE_TRIGGERS
    hot: Tuple[str, ...]               # callsites re-tuned
    detect_steps: int                  # samples between arming and trigger
    duration_s: float = 0.0
    before: Dict[str, str] = field(default_factory=dict)
    after: Dict[str, str] = field(default_factory=dict)

    @property
    def changed(self) -> Dict[str, Tuple[str, str]]:
        return {cs: (b, self.after[cs]) for cs, b in self.before.items()
                if self.after.get(cs, b) != b}


class _Stream:
    """One callsite's timing samples since the last (re-)arm."""

    def __init__(self, recent: int):
        self.samples: List[float] = []
        self.recent: Deque[float] = deque(maxlen=recent)
        self.baseline: Optional[float] = None

    def add(self, duration: float, min_baseline: int) -> None:
        self.samples.append(duration)
        self.recent.append(duration)
        if self.baseline is None and len(self.samples) >= min_baseline:
            self.baseline = median(self.samples[:min_baseline])

    def drift(self, factor: float) -> Optional[float]:
        """The recent/baseline median ratio when it breaches ``factor``
        either way; None while armed-but-nominal or still collecting."""
        if self.baseline is None or self.baseline <= 0.0 \
                or len(self.recent) < self.recent.maxlen:
            return None
        ratio = median(self.recent) / self.baseline
        if ratio > factor or ratio < 1.0 / factor:
            return ratio
        return None


class RetuneController:
    """Watches step timings and swaps the engine's schedule resolutions.

    ``engine``       the :class:`~repro_torch.comm.engine.CollectiveEngine`
                     whose resolutions to refresh (its cost model is mutated
                     in place: pass an engine built with an explicit
                     ``cost_model`` to keep the process default untouched).
    ``watched``      :class:`Watched` entries: the callsites a retune
                     re-resolves and reports on.
    ``drift_factor`` two-sided trigger threshold on recent/baseline medians.
    ``recent``       samples in the recent-median window.
    ``min_baseline`` samples collected before a stream arms.
    ``cooldown``     observations ignored after each retune (lets the new
                     schedule's timings settle before re-arming decisions).
    ``hw_probe``     optional ``() -> HardwareModel`` link telemetry.
    ``health_probe`` optional ``() -> frozenset`` of hard-down ``(axis,
                     hop)`` links (the injector's ``down_links``); fed to
                     ``invalidate_resolutions(health=...)`` on retune.
    ``measure``      run the narrow measured ladder on retune; refused in
                     a process that cannot start children (a rank of a
                     spawned gloo world).
    ``table_path``   where to save the merged table after a measured
                     retune (None = in memory only).
    ``device``       where the measured ladder's payloads live (the card
                     unless ``"cpu"`` is given).
    """

    def __init__(self, engine, watched: Sequence[Watched], *,
                 drift_factor: float = 1.75, recent: int = 3,
                 min_baseline: int = 5, cooldown: int = 8,
                 hw_probe: Optional[Callable] = None,
                 health_probe: Optional[Callable] = None,
                 measure: bool = False,
                 sizes: Optional[Sequence[int]] = None, reps: int = 2,
                 quick: bool = True, table_path=None, verbose: bool = False,
                 device=None):
        if drift_factor <= 1.0:
            raise ValueError("drift_factor must exceed 1.0")
        if not watched:
            raise ValueError("RetuneController needs at least one Watched "
                             "callsite")
        if measure and multiprocessing.current_process().daemon:
            raise RuntimeError(
                "RetuneController(measure=True) inside a daemon process (a "
                "rank of a spawned gloo world): the measured ladder spawns "
                "gloo worlds of its own, which a daemon cannot start. Retune "
                "measured from the process that launched the ranks, or "
                "re-price with hw_probe/health_probe.")
        self.engine = engine
        self.watched = tuple(watched)
        self.drift_factor = float(drift_factor)
        self.recent = int(recent)
        self.min_baseline = int(min_baseline)
        self.cooldown = int(cooldown)
        self.hw_probe = hw_probe
        self.health_probe = health_probe
        self.measure = measure
        self.sizes = tuple(sizes) if sizes is not None else None
        self.reps = int(reps)
        self.quick = quick
        self.table_path = table_path
        self.verbose = verbose
        self.device = device
        self.events: List[RetuneEvent] = []
        self._streams: Dict[str, _Stream] = {}
        self._cooldown_left = 0

    # -- observation --------------------------------------------------------

    def observe(self, step: int, duration: float,
                callsite: Optional[str] = None) -> Optional[RetuneEvent]:
        """Record one timing sample (whole-step when ``callsite`` is None)
        and retune if it tips a stream past the drift threshold. Returns
        the event when a retune ran."""
        key = callsite or _STEP_STREAM
        stream = self._streams.get(key)
        if stream is None:
            stream = self._streams[key] = _Stream(self.recent)
        stream.add(float(duration), self.min_baseline)
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            return None
        hot = self._hot()
        if not hot:
            return None
        return self.retune(step, trigger="drift", hot=hot)

    def on_straggler(self, step: int) -> Optional[RetuneEvent]:
        """A straggler flag under policy ``"retune"``: force a retune of
        every watched callsite (None during cooldown)."""
        if self._cooldown_left > 0:
            return None
        return self.retune(step, trigger="straggler")

    def _hot(self) -> List[str]:
        """Callsites whose stream drifted; the untagged step stream counts
        for every watched callsite."""
        hot: List[str] = []
        for key, stream in self._streams.items():
            if stream.drift(self.drift_factor) is None:
                continue
            if key == _STEP_STREAM:
                return [w.callsite for w in self.watched]
            if key not in hot:
                hot.append(key)
        return hot

    # -- the retune itself --------------------------------------------------

    def resolutions(self) -> Dict[str, str]:
        """Current per-watched-callsite resolved schedule names."""
        return {w.callsite: self.engine.schedule_for(
                    w.op, nbytes=w.nbytes, axis=w.axis, callsite=w.callsite)
                for w in self.watched}

    def retune(self, step: int, *, trigger: str = "forced",
               hot: Optional[Sequence[str]] = None) -> RetuneEvent:
        """Re-resolve the hot callsites (all watched by default): re-price
        on ``hw_probe``'s current link numbers and/or re-measure the narrow
        ladder, then invalidate the engine's resolution cache. Re-arms
        every stream and starts the cooldown."""
        if trigger not in RETUNE_TRIGGERS:
            raise ValueError(f"unknown retune trigger {trigger!r}; "
                             f"triggers are {RETUNE_TRIGGERS}")
        hot = tuple(hot) if hot else tuple(w.callsite for w in self.watched)
        detect = max((len(s.samples) - self.min_baseline
                      for s in self._streams.values()), default=0)
        t0 = time.perf_counter()
        before = self.resolutions()
        kwargs: Dict[str, object] = {}
        if self.hw_probe is not None:
            kwargs["hw"] = self.hw_probe()
        if self.health_probe is not None:
            kwargs["health"] = frozenset(self.health_probe())
        if self.measure:
            kwargs["table"] = self._measure_hot(hot)
        self.engine.invalidate_resolutions(**kwargs)
        after = self.resolutions()
        event = RetuneEvent(step=step, trigger=trigger, hot=hot,
                            detect_steps=detect,
                            duration_s=time.perf_counter() - t0,
                            before=before, after=after)
        self.events.append(event)
        self._streams.clear()
        self._cooldown_left = self.cooldown
        if self.verbose:
            print(f"  [retune] step {step} ({trigger}): "
                  f"{event.changed or 'no schedule change'} "
                  f"in {event.duration_s * 1e3:.1f}ms")
        return event

    def _measure_hot(self, hot: Sequence[str]):
        """The narrow measured ladder: only the hot callsites' tagged
        patterns (untagged op as the fallback), at sizes bracketing their
        live payloads, merged over the engine's current table."""
        from repro_torch.comm.autotune import TuningTable, autotune_mesh
        from repro_torch.comm.callsites import CALLSITES
        ops: List[str] = []
        sizes = set(self.sizes or ())
        for w in self.watched:
            if w.callsite not in hot:
                continue
            cs = CALLSITES.get(w.callsite)
            key = cs.tuned if cs is not None and cs.tuned else w.op
            if key not in ops:
                ops.append(key)
            if self.sizes is None:
                sizes |= {max(int(w.nbytes) // 4, 256), int(w.nbytes),
                          int(w.nbytes) * 4}
        fresh, _ = autotune_mesh(ops=tuple(ops), sizes=sorted(sizes),
                                 reps=self.reps, quick=self.quick,
                                 verbose=self.verbose, device=self.device)
        base = getattr(self.engine._model(), "table", None)
        merged = base.merge(fresh) if isinstance(base, TuningTable) else fresh
        if self.table_path is not None:
            merged.save(self.table_path)
        return merged
