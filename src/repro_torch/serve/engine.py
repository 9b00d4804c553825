"""Continuous-batching serving engine over the paged KV cache.

Port of ``repro/serve/engine.py`` (``:54-310``). One :class:`ServeEngine`
owns the device state (page pools and a serving copy of the weights, cast
once to the compute dtype), the host
:class:`~repro_torch.serve.scheduler.Scheduler`, and the three steps of
the serving loop:

* **prefill**: per admitted request, the dense prefill step on a batch of
  one, the prompt padded to a power-of-two bucket (causal attention makes
  the pad positions inert), then
  :func:`~repro_torch.models.kvcache.commit_prefill` scatters the prefix
  into the request's reserved pages. The prefill has no mesh, so it never
  takes the flash kernel, as in the reference (ROADMAP C7);
* **decode**: ONE batched step over all ``max_slots`` slots per loop
  iteration, inactive slots riding along: their logits are discarded and
  their cache writes drop on the sentinel block-table rows. Either the
  GSPMD program (:func:`repro_torch.train.serve.make_paged_decode_step`)
  or the engine-routed explicit tensor-parallel one
  (:func:`repro_torch.train.serve.make_decode_step_explicit`, ``mode=
  "explicit"``), whose per-token collectives carry the ``decode.*``
  callsite tags;
* **sampling**: on the host (numpy), greedy or temperature, so the
  scheduler can branch on EOS without another device round trip.

``step()`` = admit within the prefill-token budget -> prefill those -> one
decode batch -> sample/advance/recycle. ``run()`` drains the queue and
returns the full token streams. The page pool lives on the weights'
device.

Rank-death drain: when the fault schedule marks a rank lost, every active
request holding a KV page resident on it (pages stripe round-robin: page
``p`` lives on rank ``p % nranks``) is preempted with its tokens intact
and re-queued at the head, so re-admission re-prefills ``tokens_so_far``
on surviving pages: the zero-loss contract of page-pool preemption,
triggered by rank death. A schedule's ``serve.step`` host delay lands
inside the timed decode window.

On a mesh of several ranks the port runs SPMD: every rank runs the same
engine, its scheduler and :class:`PageAllocator` taking the same
decisions. The prefill stays the one-device dense step on a batch of one
with no mesh, so every rank holds the whole weights once (the decode
takes views of them, never a second copy), and each rank commits its part
of the prefill cache into its pool: its share of the KV heads for every
slot in explicit mode (the heads split over ``axis``), the KV heads of its
placement for its own rows in GSPMD mode. Before sampling the decode's
last-token logits, each rank's rows, are gathered over the batch axes
into ``(max_slots, V)`` on every rank through the collective engine's
``all_gather`` (its staged bytes counted under :data:`LOGITS_CALLSITE`),
so host sampling with the same ``seed`` draws the same tokens everywhere
and the streams are the one-rank engine's.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import partition as P
from repro_torch import sharding as sh
from repro_torch.models import transformer as T
from repro_torch.models.kvcache import (OutOfPagesError, PagedCacheConfig,
                                        PageAllocator, commit_prefill,
                                        pool_heads)
from repro_torch.models.model import Model
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.train.serve import (decode_rows, local_params,
                                     make_decode_step_explicit,
                                     make_paged_decode_step,
                                     make_prefill_step)

SERVE_MODES = ("gspmd", "explicit")
# the accounting label of the logits' gather before sampling on a mesh of
# several ranks (staged_bytes_by_callsite)
LOGITS_CALLSITE = "serve.logits"


def _bucket(n: int, lo: int = 8, hi: Optional[int] = None) -> int:
    """Next power-of-two >= n (floor ``lo``): the prefill shape ladder.

    ``hi`` clamps the ladder to the max context: the top bucket is exactly
    ``hi`` (not the next power of two past it), so prefill never pads
    beyond what the cache can hold. ``n > hi`` is the caller's bug."""
    if hi is not None and n > hi:
        raise ValueError(f"sequence of {n} tokens exceeds the {hi}-token "
                         "max context")
    b = lo
    while b < n:
        b *= 2
    return min(b, hi) if hi is not None else b


class ServeEngine:
    """Continuous-batching server for one model + page-pool geometry.
    ``dtype`` is the page pool's and the prefill cache's. ``params`` are
    the whole weights on every rank. ``engine``, ``schedule`` and
    ``nchunks`` configure the explicit decode's exchanges (its engine
    also gathers the logits), as in the reference."""

    def __init__(self, model: Model, params, pcfg: PagedCacheConfig, *,
                 mode: str = "gspmd", mesh=None, axis: str = "x",
                 schedule: Optional[str] = None, nchunks=1,
                 prefill_token_budget: int = 512,
                 eos_id: Optional[int] = None, temperature: float = 0.0,
                 seed: int = 0, dtype=torch.float32, engine=None,
                 preempt: bool = False, admission_retries: int = 256,
                 fault_schedule=None):
        if mode not in SERVE_MODES:
            raise ValueError(f"unknown serve mode {mode!r}; modes: "
                             f"{SERVE_MODES}")
        if mode == "explicit":
            if mesh is None:
                raise ValueError("explicit serve mode requires a mesh")
            n = mesh.shape[axis]
            if pcfg.max_slots % n:
                raise ValueError(
                    f"max_slots={pcfg.max_slots} must be divisible by the "
                    f"{axis!r} axis size {n} for the explicit decode batch")
        self.model = model
        self.params = T.cast_params(params, T.dtype_of(model.cfg.dtype))
        self.device = params.embed.device
        self.pcfg = pcfg
        self.mode = mode
        self.eos_id = eos_id
        self.temperature = temperature
        self._rng = np.random.default_rng(seed)
        self._next_rid = 0
        if admission_retries <= 0:
            raise ValueError("admission_retries must be positive")
        self.admission_retries = admission_retries
        self._fault_schedule = fault_schedule
        self._steps = 0
        self._nranks = 1
        if mesh is not None:
            shape = dict(mesh.shape)
            self._nranks = int(shape[axis]) if axis in shape \
                else int(np.prod(list(shape.values())))
        self._drained_ranks: set = set()

        self.alloc = PageAllocator(pcfg)
        self.scheduler = Scheduler(self.alloc,
                                   prefill_token_budget=prefill_token_budget,
                                   preempt=preempt)
        self._dtype = dtype
        self._last_tok = np.zeros((pcfg.max_slots,), np.int32)

        self._prefill = make_prefill_step(model, None)
        # this rank's rows of the slot batch, the KV heads of its pool, the
        # weights its decode reads, and the axes its rows' logits gather
        # over (None: every rank holds every row)
        B = pcfg.max_slots
        self._rows, self._kv, self._gather_axes = slice(0, B), None, None
        self._decode_params = self.params
        if mode == "explicit":
            self._decode = make_decode_step_explicit(
                model, mesh, axis=axis, engine=engine, schedule=schedule,
                nchunks=nchunks)
            self._rows = decode_rows(mesh, B, axis)
            self._kv = pool_heads(model.cfg, mesh, axis)
            self._gather_axes = axis
            self._comm = self._decode.engine
            self._decode_params = local_params(self.params, mesh, axis)
        else:
            self._decode = make_paged_decode_step(model, mesh)
            if mesh is not None:
                self._rows = decode_rows(mesh, B)
                self._kv = pool_heads(model.cfg, mesh)
                self._decode_params = local_params(self.params, mesh)
                if self._rows.stop - self._rows.start < B:
                    self._gather_axes = sh.rules_for(mesh).dp_spec
                    self._comm = P.engine_for(mesh)
        self.pages = T.init_paged_cache(
            model.cfg, pcfg, dtype, self.device, mesh=mesh,
            axis=axis if mode == "explicit" else None)

    # -- request API ------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 16, *,
               deadline_s: Optional[float] = None) -> int:
        """Queue a request; returns its id (key into ``run()``'s result).

        Rejects impossible requests *here*, not mid-run: a worst-case page
        reservation larger than the whole pool raises
        :class:`OutOfPagesError` (it could never be admitted, even with
        every slot idle), and prompt+max_new past ``max_seq`` raises
        ``ValueError``. ``deadline_s`` is a wall-clock budget from now;
        an expired request finishes with reason ``"timeout"``."""
        rid = self._next_rid
        self._next_rid += 1
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        total = int(prompt.shape[0]) + max_new_tokens
        need = -(-total // self.pcfg.page_size)
        if need > self.pcfg.num_pages:
            raise OutOfPagesError(
                f"request {rid} ({total} tokens) needs {need} pages but the "
                f"pool holds {self.pcfg.num_pages}: it can never be admitted")
        self.scheduler.submit(Request(
            rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
            deadline_s=deadline_s))
        return rid

    # -- sampling (host) --------------------------------------------------

    def _sample(self, logits_row: np.ndarray) -> int:
        if self.temperature <= 0.0:
            return int(np.argmax(logits_row))
        z = logits_row.astype(np.float64) / self.temperature
        z -= z.max()
        p = np.exp(z)
        return int(self._rng.choice(p.shape[0], p=p / p.sum()))

    def _advance(self, req: Request, tok: int) -> None:
        """Record one generated token; finish on EOS / max-new."""
        req.generated.append(tok)
        if self.eos_id is not None and tok == self.eos_id:
            self.scheduler.finish(req, "eos")
        elif len(req.generated) >= req.max_new_tokens:
            self.scheduler.finish(req, "max_new")
        else:
            self._last_tok[req.slot] = tok

    # -- serving loop -----------------------------------------------------

    def _prefill_one(self, req: Request) -> None:
        # prefill_len/tokens_so_far, not the bare prompt: a preempted
        # request re-enters here with its generated tokens intact, and the
        # re-prefill resumes the stream exactly where eviction cut it
        S0 = req.prefill_len
        Sp = _bucket(S0, hi=self.pcfg.max_seq)
        toks = np.zeros((1, Sp), np.int32)
        toks[0, :S0] = req.tokens_so_far
        cache = self.model.init_cache(1, Sp, self._dtype, device=self.device)
        logits, cache = self._prefill(
            self.params, {"tokens": torch.from_numpy(toks).to(self.device)},
            cache)
        if self.mode == "explicit" or \
                self._rows.start <= req.slot < self._rows.stop:
            # every slot's KV share in explicit mode; only its own rows'
            # pages in GSPMD mode
            commit_prefill(self.pages["layers"], cache["layers"],
                           self.alloc.block_table[req.slot], S0,
                           page_size=self.pcfg.page_size, kv_heads=self._kv)
        self.alloc.commit(req.slot, S0)
        self._advance(req, self._sample(_host(logits[0, S0 - 1])))

    def _drain_lost_ranks(self) -> int:
        """Re-queue every active request with a KV page on a newly lost
        rank (page ``p`` stripes onto rank ``p % nranks``): preempt it
        with ``tokens_so_far`` intact and put it at the queue head, so
        re-admission re-prefills onto surviving pages and the greedy
        stream resumes token-identical. Returns the drain count."""
        inj = self._fault_schedule.injector
        new = inj.lost_ranks - self._drained_ranks
        if not new:
            return 0
        self._drained_ranks |= new
        lost = {r % self._nranks for r in new}
        victims = []
        for slot, req in sorted(self.scheduler.active.items()):
            row = self.alloc.block_table[slot]
            pages = row[row < self.pcfg.num_pages]
            if any(int(p) % self._nranks in lost for p in pages):
                victims.append(req)
        for req in victims:
            self.scheduler.preempt_request(req)
        for req in reversed(victims):
            self.scheduler.waiting.appendleft(req)
        return len(victims)

    def step(self) -> Dict:
        """One loop iteration: expire deadlines, drain requests whose KV
        pages died with a lost rank, admit + prefill within budget
        (preempting if armed), then one batched decode over every active
        slot. Returns step stats."""
        drained = 0
        if self._fault_schedule is not None:
            self._fault_schedule.apply(self._steps)
            drained = self._drain_lost_ranks()
        self._steps += 1
        expired = self.scheduler.expire(time.monotonic())
        pre_preempted = self.scheduler.preempted_total
        admitted = self.scheduler.admit()
        preempted = self.scheduler.preempted_total - pre_preempted

        # backpressure: a head past its retry budget is rejected so the
        # queue keeps moving (never-fitting requests were already refused
        # at submit(); this is for pools pinned by long-lived actives)
        rejected = 0
        while (self.scheduler.waiting
               and self.scheduler.waiting[0].wait_steps
               > self.admission_retries):
            head = self.scheduler.waiting.popleft()
            self.scheduler.finish(head, "rejected")
            rejected += 1

        if not admitted and not self.scheduler.active:
            if self.scheduler.waiting:
                head = self.scheduler.waiting[0]
                raise OutOfPagesError(
                    f"request {head.rid} ({head.total_budget} tokens) can "
                    f"never be admitted: pool is idle yet too small")
            return {"prefills": 0, "prefill_tokens": 0, "decode_tokens": 0,
                    "active": 0, "decode_s": 0.0, "preempted": preempted,
                    "timeouts": len(expired), "rejected": rejected,
                    "drained": drained}
        t0 = time.perf_counter()
        for req in admitted:
            self._prefill_one(req)
        prefill_s = time.perf_counter() - t0

        decode_tokens = 0
        decode_s = 0.0
        if self.scheduler.active:
            t0 = time.perf_counter()
            if self._fault_schedule is not None:
                # the injected host delay lands inside the timed decode
                # window: tok/s during the fault degrades accordingly
                self._fault_schedule.injector.sleep("serve.step")
            rows = _host(self._decode_step())  # sync: (max_slots, V)
            decode_s = time.perf_counter() - t0
            for slot, req in list(self.scheduler.active.items()):
                self.alloc.append(slot)
                self._advance(req, self._sample(rows[slot]))
                decode_tokens += 1
        return {"prefills": len(admitted),
                "prefill_tokens": sum(r.prefill_len for r in admitted),
                "decode_tokens": decode_tokens,
                "active": len(self.scheduler.active),
                "prefill_s": prefill_s, "decode_s": decode_s,
                "preempted": preempted, "timeouts": len(expired),
                "rejected": rejected, "drained": drained}

    def _decode_step(self) -> torch.Tensor:
        """One decode over every slot: this rank's rows through the decode
        step, then every rank's last-token logits gathered into
        (max_slots, V)."""
        bt, lengths = self.alloc.device_tables(self.device)
        tokens = torch.from_numpy(self._last_tok[:, None].copy()).to(
            self.device)
        mine = self._rows
        if self.mode == "explicit":
            logits, self.pages = self._decode(
                self._decode_params, tokens[mine], self.pages, bt, lengths)
        else:
            logits, self.pages = self._decode(
                self._decode_params, tokens[mine], self.pages, bt[mine],
                lengths[mine])
        last = logits[:, 0]
        if self._gather_axes is None:
            return last
        return torch.cat(self._comm.all_gather(
            last.contiguous(), self._gather_axes,
            callsite=LOGITS_CALLSITE), dim=0)

    def run(self, requests=None, *, max_new_tokens: int = 16,
            collect_stats: bool = False):
        """Drain the queue (optionally submitting ``requests`` first).

        Returns ``{rid: np.ndarray prompt+generated}``, plus the per-step
        stats list when ``collect_stats``.
        """
        done: List[Request] = []
        for prompt in (requests or []):
            self.submit(prompt, max_new_tokens)
        tracked: Dict[int, Request] = {}
        for req in self.scheduler.waiting:
            tracked[req.rid] = req
        stats = []
        while self.scheduler.has_work:
            stats.append(self.step())
        for req in tracked.values():
            if not req.done:
                raise RuntimeError(
                    f"request {req.rid} never finished: scheduler drained "
                    f"with slot={req.slot}, {len(req.generated)}/"
                    f"{req.max_new_tokens} tokens generated")
            done.append(req)
        out = {req.rid: np.concatenate([req.prompt,
                                        np.asarray(req.generated, np.int32)])
               for req in done}
        return (out, stats) if collect_stats else out


def _host(logits: torch.Tensor) -> np.ndarray:
    """Logits on the host as fp32 (exact for bf16), for numpy sampling."""
    return logits.float().cpu().numpy()
