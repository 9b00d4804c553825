"""Continuous-batching scheduler: request queue + slot lifecycle.

Port of ``repro/serve/scheduler.py``; host-side bookkeeping, no device
work. The scheduler decides *which* requests enter the batch (admission
against the page pool and a per-step prefill-token budget) and *when* a
slot is recycled (EOS / max-new); the device work lives in
:class:`repro_torch.serve.engine.ServeEngine`.

Admission reserves the worst-case page count (prompt + max-new tokens)
through :class:`repro_torch.models.kvcache.PageAllocator`, so an admitted
request can always decode to completion: running out of pages is an
admission-time condition, never a mid-flight failure. The prefill-token
budget bounds how much prefill work one step may put between decode
batches, which caps the latency spike running streams see when a long
prompt arrives.

Degradation, as in the reference:

* **preemption** (``preempt=True``): evict the *youngest* active request
  (highest admission number) to free pages for the FIFO head, re-queueing
  the victim right behind it with its prompt **and** generated tokens. On
  re-admission the victim re-prefills ``tokens_so_far`` and continues where
  it stopped; greedy sampling makes the resumed stream token-identical, so
  preemption loses no token. ``max_preemptions`` bounds evictions per
  request (a guard against livelock).
* **deadlines**: ``expire(now)`` finishes any waiting or active request
  whose ``deadline_s`` elapsed with ``finish_reason="timeout"``.
* **bounded retry**: a head that cannot be admitted has ``wait_steps``
  incremented each attempt; the engine rejects it past its retry budget
  rather than blocking the queue forever.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.models.kvcache import PageAllocator


@dataclass
class Request:
    """One generation request and its accumulated output."""
    rid: int
    prompt: np.ndarray            # (S0,) int32
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    finish_reason: Optional[str] = None  # "eos"|"max_new"|"timeout"|"rejected"
    deadline_s: Optional[float] = None   # wall-clock budget from submission
    submitted_at: float = 0.0
    preemptions: int = 0                 # times evicted mid-flight
    wait_steps: int = 0                  # failed admission attempts in a row
    _admit_seq: int = -1                 # admission order (eviction key)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def total_budget(self) -> int:
        return self.prompt_len + self.max_new_tokens

    @property
    def prefill_len(self) -> int:
        """Tokens to prefill on (re-)admission: prompt + already generated."""
        return self.prompt_len + len(self.generated)

    @property
    def tokens_so_far(self) -> np.ndarray:
        """Prompt + generated — what a preempted request re-prefills."""
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])


class Scheduler:
    """FIFO admission over a :class:`PageAllocator` with a prefill budget.

    ``admit(budget)`` pops waiting requests while (a) the allocator can
    reserve their worst-case pages + a slot and (b) their prompt lengths
    fit the remaining per-step prefill-token budget; each admitted request
    gets its slot assigned. FIFO head-of-line blocking is deliberate — it
    keeps admission order deterministic and starvation-free.

    ``preempt=True`` arms page-pool preemption: a head that has waited
    ``preempt_after`` admission rounds may evict youngest-first actives
    (never past ``max_preemptions`` per victim) to claim their pages.
    Victims keep their tokens and re-queue directly behind the head.
    """

    def __init__(self, alloc: PageAllocator,
                 prefill_token_budget: int = 512, *, preempt: bool = False,
                 preempt_after: int = 1, max_preemptions: int = 1):
        if prefill_token_budget <= 0:
            raise ValueError("prefill_token_budget must be positive")
        self.alloc = alloc
        self.prefill_token_budget = prefill_token_budget
        self.preempt = preempt
        self.preempt_after = preempt_after
        self.max_preemptions = max_preemptions
        self.waiting: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}  # slot -> request
        self.preempted_total = 0
        self._admits = 0

    # -- queue ------------------------------------------------------------

    def submit(self, req: Request) -> None:
        if req.total_budget > self.alloc.cfg.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt+max_new={req.total_budget} "
                f"exceeds max_seq={self.alloc.cfg.max_seq}")
        if req.submitted_at == 0.0:
            req.submitted_at = time.monotonic()
        self.waiting.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or bool(self.active)

    # -- admission --------------------------------------------------------

    def admit(self) -> List[Request]:
        """Admit FIFO-head requests within this step's prefill budget."""
        admitted: List[Request] = []
        budget = self.prefill_token_budget
        while self.waiting:
            req = self.waiting[0]
            if req.prefill_len > budget and admitted:
                break  # budget spent this step; next step continues
            requeue: List[Request] = []
            if not self.alloc.can_allocate(req.total_budget):
                victims = None
                if self.preempt and req.wait_steps >= self.preempt_after:
                    victims = self._evict_for(req)
                if victims is None:
                    req.wait_steps += 1
                    break  # pool full: wait for a release (or reject)
                for v in victims:
                    self.preempt_request(v)
                requeue = victims
            self.waiting.popleft()
            req.slot = self.alloc.allocate(req.total_budget)
            req._admit_seq = self._admits
            self._admits += 1
            req.wait_steps = 0
            self.active[req.slot] = req
            admitted.append(req)
            budget -= req.prefill_len
            if requeue:
                # victims go right behind the head they made room for
                for v in reversed(requeue):
                    self.waiting.appendleft(v)
                break  # one preemption batch per admission round
            if budget <= 0:
                break
        return admitted

    def _evict_for(self, head: Request) -> Optional[List[Request]]:
        """Youngest-first victim set freeing enough pages (and a slot) for
        ``head`` — or None when no allowed set suffices (then nobody is
        evicted: the feasibility check runs before any preemption)."""
        need = self.alloc._pages_for(head.total_budget)
        free = self.alloc.free_page_count
        need_slot = self.alloc.free_slot_count == 0
        candidates = sorted(
            (r for r in self.active.values()
             if r.preemptions < self.max_preemptions),
            key=lambda r: r._admit_seq, reverse=True)
        victims: List[Request] = []
        for r in candidates:
            if free >= need and not need_slot:
                break
            victims.append(r)
            free += self.alloc._pages_for(r.total_budget)
            need_slot = False
        if free < need or need_slot:
            return None
        return victims

    # -- lifecycle --------------------------------------------------------

    def preempt_request(self, victim: Request) -> None:
        """Evict ``victim`` from its slot, keeping its tokens: pages and
        slot recycle now; the request re-prefills on re-admission."""
        victim.preemptions += 1
        self.preempted_total += 1
        slot = victim.slot
        self.alloc.release(slot)
        del self.active[slot]
        victim.slot = None

    def expire(self, now: float) -> List[Request]:
        """Finish every waiting/active request whose deadline elapsed with
        ``finish_reason="timeout"``; returns the expired requests."""
        expired: List[Request] = []
        for req in [r for r in self.waiting
                    if r.deadline_s is not None
                    and now - r.submitted_at > r.deadline_s]:
            self.waiting.remove(req)
            self.finish(req, "timeout")
            expired.append(req)
        for req in list(self.active.values()):
            if req.deadline_s is not None \
                    and now - req.submitted_at > req.deadline_s:
                self.finish(req, "timeout")
                expired.append(req)
        return expired

    def finish(self, req: Request, reason: str) -> None:
        """Mark done and recycle the slot + pages."""
        req.done = True
        req.finish_reason = reason
        if req.slot is not None:
            self.alloc.release(req.slot)
            del self.active[req.slot]
            req.slot = None
