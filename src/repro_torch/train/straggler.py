"""Straggler detection: the multi-node analogue of the paper's "slowest
execution time among all FPGAs is reported" barrier discipline.

A copy of ``repro/train/straggler.py`` (pure Python). Every worker runs the
same step, so a straggler shows up as a slow global step. The monitor keeps
a running median of step wall times and flags steps slower than
``deadline_factor`` x median; the loop reacts per policy ('warn': log and
continue; 'checkpoint': force an early checkpoint so that a restart loses
nothing; 'retune': hand the flag to a
:class:`repro_torch.comm.retune.RetuneController`, which re-resolves the hot
collective schedules on the degraded link numbers).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Optional

POLICIES = ("warn", "checkpoint", "retune")

_MIN_BASELINE = 8  # samples before the median is trusted


@dataclass
class StragglerMonitor:
    deadline_factor: float = 3.0
    policy: str = "warn"  # one of POLICIES
    window: int = 128
    max_flagged: int = 256  # bounds the flag log over unbounded runs
    _times: Deque[float] = field(default_factory=deque, repr=False)
    flagged: Deque[int] = field(default_factory=deque)

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown straggler policy {self.policy!r}; "
                             f"policies are {POLICIES}")
        self._times = deque(self._times, maxlen=self.window)
        self.flagged = deque(self.flagged, maxlen=self.max_flagged)

    def record(self, step: int, duration: float) -> bool:
        """Returns True if this step is a straggler."""
        self._times.append(duration)
        if len(self._times) < _MIN_BASELINE:  # need a baseline first
            return False
        med = self.median()
        if duration > self.deadline_factor * med:
            self.flagged.append(step)
            return True
        return False

    def median(self) -> float:
        s = sorted(self._times)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def deadline(self) -> Optional[float]:
        if len(self._times) < _MIN_BASELINE:
            return None
        return self.deadline_factor * self.median()

    def summary(self) -> dict:
        if not self._times:
            return {"steps": 0}
        return {
            "steps": len(self._times),
            "median_s": self.median(),
            "max_s": max(self._times),
            "flagged": list(self.flagged),
        }


class StepTimer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.duration = time.perf_counter() - self.t0
        return False
