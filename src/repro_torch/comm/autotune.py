"""Cost-model-driven schedule autotuning for the collective engine.

Port of ``repro/comm/autotune.py``. The paper's core finding is that the
best communication path depends on the workload and the topology: the
winner flips with message size and node count (Figs. 4-7). This module
makes that choice per callsite:

* **Analytic mode** — an alpha-beta model prices every registered schedule
  per ``(op, message bytes, axis topology)``. Each schedule is reduced to
  hop count and per-link wire bytes on the :class:`AxisTopology` it runs
  over, and priced with :func:`repro_torch.roofline.alpha_beta_time` on the
  :class:`HardwareModel`'s link numbers (per-hop latency ``alpha``, link
  bandwidth ``beta``; the staging domain uses MPI latency and PCIe/DCN
  bandwidth, the paper's Eq. 2 path). The port prices on
  :data:`~repro_torch.comm.types.H100_80GB`, whose link numbers are the
  gloo loopback of processes sharing one card.

* **Measured mode** — :func:`autotune_mesh` times the registered schedules
  on gloo worlds of processes (:func:`~repro_torch.launch.mesh.spawn_mesh`)
  across a ladder of message sizes, takes the per-size winners, and
  :class:`TuningTable` persists them to ``results/tuning_torch.json``
  (``python -m repro_torch.benchmarks.run --autotune``). The table is
  loaded by :func:`default_cost_model` and overrides the analytic ranking
  wherever it has an entry. The port never reads or writes the
  reference's ``results/tuning.json``.

``CollectiveEngine`` resolves ``schedule="auto"`` through
:meth:`CostModel.choose` per callsite (cached by op/size/axis signature);
:func:`derive_bucket_bytes` sizes ``allreduce_tree``'s buckets as pipeline
depth x per-hop latency-bandwidth product.

Model (single ring axis of n ranks, message of S bytes; ``sync`` is the
library collective's dispatch/rendezvous overhead in hop units):

====================  =====================================================
op / schedule         hops x alpha                +  wire bytes / beta
====================  =====================================================
bcast/chain           (n-1)                          (n-1) S
bcast/native          sync + n/2                     (n-1) S / 2
bcast/ring2d          2(n-1)                         2 S (n-1)/n
bcast/chain_rooted    2(n-1)                         2(n-1) S
allreduce/chain       (n-1)                          (n-1) S
allreduce/chain_rooted  2(n-1)                       2(n-1) S
allreduce/native      sync + (n-1)                   (n-1)/n S
allreduce/rs_ag       2(n-1)                         2 S (n-1)/n
allreduce/ring2d      sum over torus dims of the per-dim rs_ag ring
allreduce/int8_ef     rs_ag hops                     rs_ag wire x ~0.27
a2a/native            sync + n/2                     (n-1)/n S / 2
a2a/chain             n(n-1)/2                       (n-1) S / 2
ring_exchange/direct  1                              S
transpose/direct      pg                             S
transpose/ring2d      2(pg-1)                        (pg-1)(1+pg) S
* /staged             2 (MPI latency)                (ranks+1) S (PCIe/DCN)
====================  =====================================================

Lossy schedules (``int8_ef``) are priced but never *chosen* by ``auto``:
compression changes numerics and must stay an explicit opt-in.

While a fault injector is active (:mod:`repro_torch.comm.faults`), the
measured mode adds its modeled delay to each job's time, as the
reference's ``_measure_op`` does. The port adds it in the calling process
once the ranks' times are gathered: the spawned ranks never see the
caller's injector. The MoE pattern ``all_to_all_tiles@moe.dispatch`` times
both exchanges of the layer, and :data:`PAIRED_ALIASES` files its winner
under ``all_to_all_tiles@moe.combine`` too; the whole-model attention
patterns ``all_to_all_tiles@tp.qkv`` and ``all_to_all_tiles@sp.qkv`` time
their hooks' exchanges and file their winners under ``@tp.out`` and
``@sp.out``; the serving decode's pattern ``all_to_all_tiles@decode.qkv``
times one decode step's six exchanges on its own ladder of decode-sized
payloads (:data:`DECODE_SIZES`) and files its winner under
``@decode.out`` and ``@decode.moe`` too.
"""
from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.comm.topology import AxisTopology
from repro_torch.comm.types import H100_80GB, HardwareModel
from repro_torch.roofline import alpha_beta_time, pipelined_alpha_beta_time

# Library collectives pay a fixed dispatch/rendezvous cost that the
# hand-written point-to-point pipelines do not; expressed in per-hop
# latency units so it scales with the hardware model.
NATIVE_SYNC_HOPS = 6.0

# int8_ef wire ratio vs its f32 payload: the quantized chunk plus the
# quantized requantization residual carried alongside on every hop
# (repro_torch.comm.compression quantize_ef, BLOCK=256) =>
# 2 x (1 byte/elem + 4/BLOCK scale bytes) = 2 x (0.25 + 1/256) of f32.
INT8_WIRE_RATIO = 2.0 * (0.25 + 1.0 / 256.0)

# schedules auto must never select: they change numerics (explicit opt-in)
LOSSY_SCHEDULES = frozenset({"int8_ef"})

# software pipelining (engine.pipelined / chunked PTRANS / depth-d HPL):
# chunk-count search ceiling and lookahead-depth ceiling for the resolvers
MAX_PIPELINE_CHUNKS = 16
MAX_LOOKAHEAD_DEPTH = 3

# allreduce_tree pipelining: how many buckets should be in flight so bucket
# k+1's backward compute hides bucket k's ring hops (paper Fig. 5/7 depth)
PIPELINE_DEPTH = 4
MIN_BUCKET_BYTES = 1 << 18   # 256 KiB — below this, per-collective overhead
MAX_BUCKET_BYTES = 32 << 20  # the former fixed default, now the ceiling

# the port's own table, at the root of the checkout (never the reference's
# results/tuning.json)
DEFAULT_TABLE_PATH = (Path(__file__).resolve().parents[3] / "results"
                      / "tuning_torch.json")

# processes per measured gloo world: the four that share one card in the
# allreduce and all-to-all paths (and a 2x2 torus for the torus patterns)
RANKS = 4


def axis_signature(axes: Sequence[AxisTopology]) -> str:
    """Canonical topology key, e.g. ``ring[8]`` or
    ``torus_row[2]+torus_col[2]`` — what tuning-table entries are keyed by."""
    return "+".join(f"{a.kind}[{a.size}]" for a in axes)


def _ranks(axes: Sequence[AxisTopology]) -> int:
    n = 1
    for a in axes:
        n *= a.size
    return n


# ---------------------------------------------------------------------------
# per-(op, schedule) analytic shapes
#
# Every schedule is decomposed into *segments* — ``(hops, wire_bytes, kind)``
# triples with kind in {"ici", "staged", "sync"} — priced either monolithic
# (:meth:`CostModel.cost`) or software-pipelined into S chunks
# (:func:`pipelined_cost`). "sync" segments are pure latency (the library
# collective's dispatch/rendezvous); under pipelining every chunk pays them.
# ---------------------------------------------------------------------------

Segment = Tuple[float, float, str]


def _sync_seg(hw: HardwareModel) -> Segment:
    return (NATIVE_SYNC_HOPS, 0.0, "sync")


def _staged_segs(nbytes: float, axes, hw) -> List[Segment]:
    # every byte transits the staging domain: up to the host network once,
    # back fanned out to all ranks (paper Eq. 2's PCIe+MPI route)
    n = _ranks(axes)
    return [(2, (n + 1) * nbytes, "staged")]


def _ring_rs_ag_segs(nbytes: float, n: int) -> List[Segment]:
    if n <= 1:
        return []
    return [(2 * (n - 1), 2 * (n - 1) / n * nbytes, "ici")]


def _segs_bcast_chain(S, axes, hw):
    n = _ranks(axes)
    return [(n - 1, (n - 1) * S, "ici")]


def _segs_chain_rooted(S, axes, hw):
    # bidirectional rooted chain away from a ring break: both arms relay
    # from the source, worst-case n-1 hops each way, every surviving wire
    # carrying S once per direction. Priced above plain chain (2x hops and
    # wire) so it never wins on a healthy ring — it exists to stay finite
    # when one link is down.
    n = _ranks(axes)
    return [(2 * (n - 1), 2 * (n - 1) * S, "ici")]


def _segs_bcast_native(S, axes, hw):
    # bidirectional all-gather + select: half the hops, both link directions
    n = _ranks(axes)
    return [_sync_seg(hw), (math.ceil(n / 2), (n - 1) * S / 2, "ici")]


def _segs_bcast_ring2d(S, axes, hw):
    # scatter + ring all-gather: 2(n-1) hops of S/n chunks
    return _ring_rs_ag_segs(S, _ranks(axes))


def _segs_allreduce_chain(S, axes, hw):
    n = _ranks(axes)
    return [(n - 1, (n - 1) * S, "ici")]


def _segs_allreduce_native(S, axes, hw):
    # ring reduce-scatter/all-gather over both directions
    n = _ranks(axes)
    return [_sync_seg(hw), (n - 1, (n - 1) / n * S, "ici")]


def _segs_allreduce_rs_ag(S, axes, hw):
    return _ring_rs_ag_segs(S, _ranks(axes))


def _segs_allreduce_ring2d(S, axes, hw):
    # one unidirectional ring pass per torus dimension
    out = []
    for a in axes:
        out += _ring_rs_ag_segs(S, a.size)
    return out


def _segs_allreduce_int8_ef(S, axes, hw):
    return _ring_rs_ag_segs(S * INT8_WIRE_RATIO, _ranks(axes))


def _segs_a2a_native(S, axes, hw):
    n = _ranks(axes)
    return [_sync_seg(hw), (math.ceil(n / 2), (n - 1) / n * S / 2, "ici")]


def _segs_a2a_chain(S, axes, hw):
    # tile at ring distance d travels d hops: sum d = n(n-1)/2 hops of S/n
    n = _ranks(axes)
    return [(n * (n - 1) / 2, (n - 1) / 2 * S, "ici")]


def _segs_exchange_direct(S, axes, hw):
    return [(1, S, "ici")]


def _pg(axes) -> int:
    # grid_transpose runs on a pg x pg torus; a single flattened axis entry
    # (or explicit pair) both reduce to sqrt(total ranks)
    return max(int(round(math.sqrt(_ranks(axes)))), 1)


def _segs_transpose_direct(S, axes, hw):
    # dimension-ordered route to the (r,c)<->(c,r) partner: <= pg links
    pg = _pg(axes)
    if pg <= 1:
        return []  # no exchange on a 1x1 grid
    return [(pg, S, "ici")]


def _segs_transpose_ring2d(S, axes, hw):
    # row-phase ring all-gather (pg-1 unit-block hops) + column-phase chain
    # of the pg-block relay stack (paper Fig. 8 two-phase route)
    pg = _pg(axes)
    if pg <= 1:
        return []
    return [(pg - 1, (pg - 1) * S, "ici"),
            (pg - 1, (pg - 1) * pg * S, "ici")]


_SEGS: Dict[Tuple[str, str], Callable] = {
    ("bcast", "chain"): _segs_bcast_chain,
    ("bcast", "chain_rooted"): _segs_chain_rooted,
    ("bcast", "native"): _segs_bcast_native,
    ("bcast", "ring2d"): _segs_bcast_ring2d,
    ("bcast", "staged"): _staged_segs,
    ("allreduce", "chain"): _segs_allreduce_chain,
    ("allreduce", "chain_rooted"): _segs_chain_rooted,
    ("allreduce", "native"): _segs_allreduce_native,
    ("allreduce", "rs_ag"): _segs_allreduce_rs_ag,
    ("allreduce", "ring2d"): _segs_allreduce_ring2d,
    ("allreduce", "int8_ef"): _segs_allreduce_int8_ef,
    ("allreduce", "staged"): _staged_segs,
    ("all_to_all_tiles", "native"): _segs_a2a_native,
    ("all_to_all_tiles", "chain"): _segs_a2a_chain,
    ("all_to_all_tiles", "staged"): _staged_segs,
    ("ring_exchange", "direct"): _segs_exchange_direct,
    ("ring_exchange", "chain"): _segs_exchange_direct,
    ("ring_exchange", "staged"): _staged_segs,
    ("grid_transpose", "direct"): _segs_transpose_direct,
    ("grid_transpose", "chain"): _segs_transpose_direct,
    ("grid_transpose", "ring2d"): _segs_transpose_ring2d,
    ("grid_transpose", "staged"): _staged_segs,
}


def segments(op: str, schedule: str, nbytes: float,
             axes: Sequence[AxisTopology],
             hw: HardwareModel = H100_80GB) -> Optional[List[Segment]]:
    """The (hops, wire bytes, kind) decomposition of one schedule run, or
    None for schedules the model has no formula for."""
    fn = _SEGS.get((op, schedule))
    if fn is None:
        return None
    if any(a.kind == "staging" for a in axes):
        return _staged_segs(nbytes, axes, hw)
    return fn(float(nbytes), tuple(axes), hw)


def canonical_health(health: frozenset,
                     axes: Sequence[AxisTopology]) -> frozenset:
    """``health`` with every hop id mapped to its axis's canonical link id
    (:meth:`AxisTopology.canonical_hop`): on a size-2 ring hops 0 and 1
    name the same physical wire. Entries naming axes outside ``axes`` pass
    through unchanged."""
    by_name = {a.name: a for a in axes}
    return frozenset(
        (nm, by_name[nm].canonical_hop(h)) if nm in by_name else (nm, h)
        for (nm, h) in health)


def route_links(op: str, schedule: str, axes: Sequence[AxisTopology], *,
                health: frozenset = frozenset()) -> Optional[frozenset]:
    """The set of ``(axis, hop)`` physical links one schedule run may
    traverse, or ``None`` for schedules the model has no formula for.

    Links are canonical ids (:meth:`AxisTopology.links`); ``health`` is
    canonicalized the same way before use. ``staged`` — and any run over a
    staging axis — touches no direct link. ``chain_rooted`` cuts the ring
    at the down hop named in ``health`` (the wraparound hop ``size-1``
    when clean) and never crosses it; further down hops on the same axis
    stay in its route. On a size-2 axis the rooted chain has nothing to cut
    away. Every other priced schedule may ride any link of its axes.
    """
    if (op, schedule) not in _SEGS:
        return None
    if schedule == "staged" or any(a.kind == "staging" for a in axes):
        return frozenset()
    health = canonical_health(health, axes)
    links = set()
    for a in axes:
        axis_links = set(a.links())
        if schedule == "chain_rooted" and a.n_links > 1:
            down = sorted(h for (nm, h) in health if nm == a.name)
            cut = down[0] if down else a.size - 1
            axis_links.discard((a.name, cut))
        links |= axis_links
    return frozenset(links)


def _seg_time(seg: Segment, hw: HardwareModel) -> float:
    hops, wire, kind = seg
    if kind == "sync":
        return hops * hw.ici_latency
    return alpha_beta_time(hops, wire, hw, staged=kind == "staged")


def _seg_time_pipelined(seg: Segment, nchunks: int, hw: HardwareModel) -> float:
    hops, wire, kind = seg
    if kind == "sync":
        # every chunk's collective pays the dispatch/rendezvous in full
        return nchunks * hops * hw.ici_latency
    return pipelined_alpha_beta_time(hops, wire, nchunks, hw,
                                     staged=kind == "staged")


def pipelined_cost(op: str, schedule: str, nbytes: float,
                   axes: Sequence[AxisTopology], nchunks: int,
                   hw: HardwareModel = H100_80GB) -> float:
    """Predicted seconds for the schedule split into ``nchunks`` software-
    pipelined chunks (``nchunks=1`` equals :meth:`CostModel.cost`); ``inf``
    for schedules with no formula."""
    segs = segments(op, schedule, nbytes, axes, hw)
    if segs is None:
        return float("inf")
    return sum(_seg_time_pipelined(s, max(int(nchunks), 1), hw) for s in segs)


def best_nchunks(op: str, schedule: str, nbytes: float,
                 axes: Sequence[AxisTopology], hw: HardwareModel = H100_80GB,
                 *, max_chunks: int = MAX_PIPELINE_CHUNKS
                 ) -> Tuple[int, float]:
    """The power-of-two chunk count minimizing :func:`pipelined_cost` —
    pipeline fill cost (S-1 extra stages of per-hop latency) against
    per-chunk wire time. Ties break toward fewer chunks. Returns
    ``(nchunks, predicted_seconds)``; (1, cost) when unpriceable."""
    best_s, best_c = 1, pipelined_cost(op, schedule, nbytes, axes, 1, hw)
    if not math.isfinite(best_c):
        return 1, best_c
    s = 2
    while s <= max_chunks:
        c = pipelined_cost(op, schedule, nbytes, axes, s, hw)
        if c < best_c:
            best_s, best_c = s, c
        s *= 2
    return best_s, best_c


def choose_hpl_depth(*, b: int, m: int, axes: Sequence[AxisTopology],
                     hw: HardwareModel = H100_80GB, model=None, resolve=None,
                     max_depth: int = MAX_LOOKAHEAD_DEPTH) -> int:
    """Lookahead depth for HPL: how many panel pipelines to keep in flight.

    Per iteration the factorization broadcasts one b x b diagonal block along
    each torus dimension and one b x m panel along each; the bulk trailing
    update offers ``2 m^2 b`` FLOPs of cover at ``hw.peak_flops``. Depth d
    hides d iterations' broadcast latency behind one bulk update, so::

        depth = clamp(ceil(T_bcast_iter / T_gemm_iter), 1, max_depth)

    ``resolve(op, nbytes, ax, callsite)`` optionally names the schedule the
    *caller* will run per broadcast (an engine's ``schedule_for``, honoring
    engine-wide overrides and HOST_STAGED); without it the broadcasts are
    priced on the model's own preferred schedule.
    """
    if model is None:
        model = default_cost_model()
    # keep both sides of the ratio on ONE hardware model: the model's, when
    # it carries one
    hw = getattr(model, "hw", None) or hw
    t_comm = 0.0
    for ax in tuple(axes):
        for nbytes, callsite in ((b * b * 4, "hpl.block"),
                                 (b * m * 4, "hpl.panel")):
            if resolve is not None:
                sched = resolve("bcast", nbytes, ax, callsite)
            else:
                sched = model.choose("bcast", nbytes, (ax,),
                                     callsite=callsite) or "chain"
            t_comm += model.cost("bcast", sched, nbytes, (ax,))
    t_gemm = 2.0 * float(m) * m * b / hw.peak_flops
    if t_gemm <= 0.0:
        return 1
    if not math.isfinite(t_comm):
        # an unpriceable schedule: infinite comm is comm-bound — clamp to
        # the ceiling instead of overflowing on ceil(inf)
        return max_depth
    return max(1, min(int(math.ceil(t_comm / t_gemm)), max_depth))


# ---------------------------------------------------------------------------
# tuning table (measured mode)
# ---------------------------------------------------------------------------


@dataclass
class TuningTable:
    """Measured per-(op, topology) winners, bucketed by message size.

    ``entries[op][axis_sig]`` is an ascending list of ``[max_bytes, name]``
    pairs; a ``None`` max_bytes entry is the open-ended tail. Lookup returns
    the first entry whose bound covers ``nbytes``.

    The op key may carry a **callsite tag** — ``"bcast@hpl.panel"`` — for
    winners measured in a callsite-specific pattern. Lookup with a callsite
    consults the tagged entry first and falls back to the untagged op.
    """
    hw: str = H100_80GB.name
    entries: Dict[str, Dict[str, List[Tuple[Optional[int], str]]]] = \
        field(default_factory=dict)
    meta: Dict[str, object] = field(default_factory=dict)

    def lookup(self, op: str, sig: str, nbytes: int,
               callsite: Optional[str] = None) -> Optional[str]:
        keys = ([f"{op}@{callsite}", op] if callsite else [op])
        for key in keys:
            for bound, name in self.entries.get(key, {}).get(sig, ()):
                if bound is None or nbytes <= bound:
                    return name
        return None

    def set(self, op: str, sig: str,
            bounds: List[Tuple[Optional[int], str]]) -> None:
        self.entries.setdefault(op, {})[sig] = list(bounds)

    def to_json(self) -> Dict:
        return {"hw": self.hw, "meta": self.meta,
                "entries": {op: {sig: [[b, n] for b, n in rows]
                                 for sig, rows in sigs.items()}
                            for op, sigs in self.entries.items()}}

    @classmethod
    def from_json(cls, data: Dict) -> "TuningTable":
        entries = {
            op: {sig: [(None if b is None else int(b), str(n))
                       for b, n in rows]
                 for sig, rows in sigs.items()}
            for op, sigs in data.get("entries", {}).items()}
        return cls(hw=data.get("hw", H100_80GB.name), entries=entries,
                   meta=data.get("meta", {}))

    def merge(self, other: "TuningTable") -> "TuningTable":
        """A new table with ``other``'s bands overlaid on this one's:
        ``other`` wins wherever both cover an ``(op, signature)`` pair. The
        in-run retune (:mod:`repro_torch.comm.retune`) merges its narrow
        re-measurement over the engine's table this way, so cold callsites
        keep their winners."""
        out = TuningTable(
            hw=other.hw or self.hw,
            entries={op: {sig: list(rows) for sig, rows in sigs.items()}
                     for op, sigs in self.entries.items()},
            meta={**self.meta, **other.meta})
        for op, sigs in other.entries.items():
            for sig, rows in sigs.items():
                out.set(op, sig, rows)
        return out

    def save(self, path=None) -> Path:
        path = Path(path or DEFAULT_TABLE_PATH)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)
        return path

    @classmethod
    def load(cls, path=None) -> Optional["TuningTable"]:
        path = Path(path or DEFAULT_TABLE_PATH)
        try:
            with open(path) as f:
                return cls.from_json(json.load(f))
        except (OSError, ValueError, KeyError, TypeError):
            return None


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------


@dataclass(eq=False)
class CostModel:
    """Prices registered schedules and picks one per (op, bytes, topology).

    A measured :class:`TuningTable` (when present) overrides the analytic
    alpha-beta ranking for the (op, axis signature) pairs it covers; the
    analytic model covers everything else, so ``auto`` always resolves.
    Choices are memoized by ``(op, nbytes, axis signature, callsite)`` —
    resolution is a pure function of static data, hence identical on every
    rank.

    ``health`` is the link-health mask — ``(axis, hop)`` pairs that are
    hard-down. Any schedule whose provable route (:func:`route_links`)
    crosses a down link prices as infinite, so resolution excludes it; a
    down ring falls through to ``chain_rooted`` and, failing that, the
    host-``staged`` path, which touches no direct link at all.
    """
    hw: HardwareModel = H100_80GB
    table: Optional[TuningTable] = None
    health: frozenset = frozenset()
    _cache: Dict[Tuple[str, int, str, Optional[str]], str] = \
        field(default_factory=dict, repr=False)

    def cost(self, op: str, schedule: str, nbytes: float,
             axes: Sequence[AxisTopology]) -> float:
        """Predicted seconds; ``inf`` for schedules the model cannot price
        and for any schedule whose route crosses a link in ``health``."""
        if self.health:
            health = canonical_health(self.health, axes)
            links = route_links(op, schedule, axes, health=health)
            if links is None or links & health:
                return float("inf")
        segs = segments(op, schedule, nbytes, axes, self.hw)
        if segs is None:
            return float("inf")
        return sum(_seg_time(s, self.hw) for s in segs)

    def pipelined_cost(self, op: str, schedule: str, nbytes: float,
                       axes: Sequence[AxisTopology], nchunks: int) -> float:
        """Predicted seconds with the payload split into ``nchunks``
        software-pipelined chunks (:func:`pipelined_cost`)."""
        return pipelined_cost(op, schedule, nbytes, axes, nchunks, self.hw)

    def best_nchunks(self, op: str, schedule: str, nbytes: float,
                     axes: Sequence[AxisTopology], *,
                     max_chunks: int = MAX_PIPELINE_CHUNKS
                     ) -> Tuple[int, float]:
        return best_nchunks(op, schedule, nbytes, axes, self.hw,
                            max_chunks=max_chunks)

    def rank(self, op: str, nbytes: float, axes: Sequence[AxisTopology], *,
             include_lossy: bool = False) -> List[Tuple[str, float]]:
        """Registered schedules for ``op`` sorted by predicted cost. Ties
        break toward the op's static default, then by name, so the ranking
        is deterministic. Lossy schedules are excluded unless requested —
        auto must never change numerics."""
        from repro_torch.comm.engine import _AUTO, schedules_for
        default = _AUTO.get(op)
        rows = []
        for name in schedules_for(op):
            if name in LOSSY_SCHEDULES and not include_lossy:
                continue
            c = self.cost(op, name, nbytes, axes)
            if math.isfinite(c):
                rows.append((name, c))
        return sorted(rows, key=lambda r: (r[1], r[0] != default, r[0]))

    def choose(self, op: str, nbytes: int, axes: Sequence[AxisTopology],
               callsite: Optional[str] = None) -> Optional[str]:
        """The schedule ``auto`` resolves to, or None if nothing is priced.

        ``callsite`` is an optional tag (``"hpl.panel"``) naming the call
        pattern; measured tuning-table entries keyed ``op@callsite``
        override the untagged op entry for it. The analytic ranking is
        callsite-independent."""
        sig = axis_signature(axes)
        key = (op, int(nbytes), sig, callsite)
        if key in self._cache:
            return self._cache[key]
        name = None
        if self.table is not None:
            name = self.table.lookup(op, sig, int(nbytes), callsite)
            if name is not None:
                from repro_torch.comm.engine import schedules_for
                if name not in schedules_for(op) or name in LOSSY_SCHEDULES:
                    name = None  # stale table entry: fall back to analytic
            if name is not None and self.health and not math.isfinite(
                    self.cost(op, name, nbytes, axes)):
                name = None  # measured winner routes through a down link
        if name is None:
            ranked = self.rank(op, nbytes, axes)
            name = ranked[0][0] if ranked else None
        self._cache[key] = name
        return name


_DEFAULT_MODEL: Optional[CostModel] = None


def runtime_backend() -> Dict[str, Optional[str]]:
    """What a measured table must have been taken on to apply here: the
    process group's backend (None without one) and the device type the
    entry points run on by default."""
    import torch
    import torch.distributed as dist
    group = dist.is_available() and dist.is_initialized()
    return {"backend": dist.get_backend() if group else None,
            "device": "cuda" if torch.cuda.is_available() else "cpu"}


def _table_matches_runtime(table: Optional[TuningTable]) -> bool:
    """A measured table only applies to the backend and device it was
    measured on — a table taken on the CPU's gloo worlds must not override
    the analytic model on the card. The backend is compared only inside a
    process group: a single process uses no transport."""
    if table is None:
        return False
    recorded = table.meta.get("backend")
    if recorded is None:
        return True  # hand-written table: caller's responsibility
    now = runtime_backend()
    if table.meta.get("device") != now["device"]:
        return False
    return now["backend"] is None or recorded == now["backend"]


def default_cost_model(refresh: bool = False) -> CostModel:
    """Process-wide model the engine uses for ``schedule="auto"``: analytic
    alpha-beta on :data:`H100_80GB`, overlaid with
    ``results/tuning_torch.json`` when a measured table exists *for this
    backend*. ``refresh=True`` re-reads the table (after
    ``python -m repro_torch.benchmarks.run --autotune``)."""
    global _DEFAULT_MODEL
    if _DEFAULT_MODEL is None or refresh:
        table = TuningTable.load()
        if not _table_matches_runtime(table):
            table = None
        _DEFAULT_MODEL = CostModel(hw=H100_80GB, table=table)
    return _DEFAULT_MODEL


# ---------------------------------------------------------------------------
# derived bucket size for allreduce_tree
# ---------------------------------------------------------------------------


def derive_bucket_bytes(axes: Sequence[AxisTopology],
                        hw: HardwareModel = H100_80GB, *,
                        depth: int = PIPELINE_DEPTH) -> int:
    """Bucket size for the bucketed tree reduction, from topology + link
    numbers instead of a fixed constant.

    A bucket's ring reduction occupies ``2(n-1)`` hops; with ``depth``
    buckets in flight the per-bucket payload should cover that hop latency
    at link bandwidth — ``depth x 2(n-1) x (alpha x beta)``. Rounded up to
    a power of two and clamped to [:data:`MIN_BUCKET_BYTES`,
    :data:`MAX_BUCKET_BYTES`]."""
    n = _ranks(axes)
    if n <= 1:
        return MIN_BUCKET_BYTES
    raw = depth * 2 * (n - 1) * hw.ici_latency * hw.ici_link_bw
    raw = max(raw, MIN_BUCKET_BYTES)
    return int(min(1 << math.ceil(math.log2(raw)), MAX_BUCKET_BYTES))


# ---------------------------------------------------------------------------
# measured mode: time the registered schedules on gloo worlds
# ---------------------------------------------------------------------------


def _winner_bounds(sizes: Sequence[int],
                   winners: Sequence[str]) -> List[Tuple[Optional[int], str]]:
    """Collapse per-size winners into [max_bytes, name] bands; boundaries
    sit at the geometric mean of adjacent measured sizes."""
    bounds: List[Tuple[Optional[int], str]] = []
    for i, name in enumerate(winners):
        last = i == len(winners) - 1
        if bounds and bounds[-1][1] == name:
            bounds.pop()  # extend the previous band
        edge = None if last else int(math.sqrt(sizes[i] * sizes[i + 1]))
        bounds.append((edge, name))
    if bounds and bounds[-1][0] is not None:
        bounds[-1] = (None, bounds[-1][1])
    return bounds


def _op_body(engine, mesh, op: str, nbytes: int, device) -> Callable:
    """The call one measurement times on this rank: ``op`` alone, or the
    callsite pattern ``op@callsite`` names, on a payload of ``nbytes``."""
    import torch

    names = tuple(mesh.shape)
    nranks = 1
    for a in names:
        nranks *= mesh.shape[a]
    elems = max(nbytes // 4, 1)
    f32 = dict(dtype=torch.float32, device=device)

    if op == "bcast@hpl.panel":
        # HPL's paired broadcasts on the torus row axis: a b x b diagonal
        # block bcast immediately followed by the dependent panel bcast —
        # the callsite pattern an isolated bcast misses
        blk, x = torch.ones(64 * 64, **f32), torch.ones(elems, **f32)

        def body():
            b0 = engine.bcast(blk, names[0], 0)
            return engine.bcast(x * b0[0], names[0], 0)
        return body

    if op == "all_to_all_tiles@ra.updates":
        # GUPS update routing on the ring: the bucketed (n, L, 2) int32
        # (local_index, value) exchange followed by the receiving
        # scatter-add — small irregular int payloads, a serialized scatter
        # on landing
        L = max(elems // (2 * nranks), 1)  # nranks*L*2 int32 = nbytes
        tbl = torch.zeros(4096, dtype=torch.int32, device=device)
        buf = torch.ones(nranks, L, 2, dtype=torch.int32, device=device)

        def body():
            recv = engine.all_to_all_tiles(buf, names[0], split_axis=0,
                                           concat_axis=0)
            return tbl.index_add(0, recv[..., 0].reshape(-1),
                                 recv[..., 1].reshape(-1))
        return body

    if op == "all_to_all_tiles@moe.dispatch":
        # MoE's paired exchanges on the ring: the dispatch all-to-all
        # (experts split across ranks, batch shards gathered), a stand-in
        # expert compute touching every landed tile, and the inverse
        # combine exchange, back-to-back; the local buffer is
        # (B_loc = 1, E = nranks, L)
        L = max(elems // nranks, 1)
        x = torch.ones(1, nranks, L, **f32)

        def body():
            buf = engine.all_to_all_tiles(x, names[0], split_axis=1,
                                          concat_axis=0)
            buf = torch.nn.functional.silu(buf) * buf
            return engine.all_to_all_tiles(buf, names[0], split_axis=0,
                                           concat_axis=1)
        return body

    if op == "all_to_all_tiles@tp.qkv":
        # whole-model head-parallel attention: three back-to-back
        # head-gathering exchanges (q, k, v), a stand-in attention touching
        # every landed tile, then the inverse batch-restoring exchange; the
        # local activation is (B_loc = 1, H = nranks, L)
        L = max(elems // nranks, 1)
        x = torch.ones(1, nranks, L, **f32)

        def gather(a):  # heads split out, batch gathered
            return engine.all_to_all_tiles(a, names[0], split_axis=1,
                                           concat_axis=0)

        def body():
            q, k, v = gather(x), gather(x * 0.5), gather(x * 0.25)
            o = torch.softmax(q * k, dim=-1) * v
            return engine.all_to_all_tiles(o, names[0], split_axis=0,
                                           concat_axis=1)
        return body

    if op == "all_to_all_tiles@sp.qkv":
        # whole-model ring attention: the sequence-gathering exchanges, the
        # kv block circulating the ring (n // 2 bidirectional hops) with a
        # stand-in fold between hops, then the inverse exchange
        L = max(elems // nranks, 1)
        x = torch.ones(1, nranks, L, **f32)

        def gather(a):  # sequence split out, batch gathered
            return engine.all_to_all_tiles(a, names[0], split_axis=1,
                                           concat_axis=0)

        def body():
            q, k, kv = gather(x), gather(x * 0.5), gather(x * 0.25)
            acc = torch.softmax(q * k, dim=-1) * kv
            fwd = bwd = kv
            for _ in range(max(nranks // 2, 1)):
                fwd, bwd = engine.ring_exchange(fwd, bwd, names[0])
                acc = acc + torch.softmax(q * fwd, dim=-1) * bwd
            return engine.all_to_all_tiles(acc, names[0], split_axis=0,
                                           concat_axis=1)
        return body

    if op == "all_to_all_tiles@decode.qkv":
        # one serving decode step: q and the token's k/v ride three tiny
        # head-gathering exchanges, a stand-in paged attention reads the
        # pool between them, the inverse exchange restores the batch
        # layout, and the MoE dispatch / expert / combine pair follows: six
        # back-to-back latency-bound exchanges, sized by DECODE_SIZES
        L = max(elems // nranks, 1)
        x = torch.ones(1, nranks, L, **f32)
        pool = torch.ones(1, 8, L, **f32)

        def gather(a):  # heads split out, batch gathered
            return engine.all_to_all_tiles(a, names[0], split_axis=1,
                                           concat_axis=0)

        def body():
            q, k, v = gather(x), gather(x * 0.5), gather(x * 0.25)
            att = torch.softmax(q * pool[:, :1] + k, dim=-1)
            o = engine.all_to_all_tiles(att * v, names[0], split_axis=0,
                                        concat_axis=1)
            buf = engine.all_to_all_tiles(o, names[0], split_axis=1,
                                          concat_axis=0)  # moe dispatch
            buf = torch.nn.functional.silu(buf) * buf
            return engine.all_to_all_tiles(buf, names[0], split_axis=0,
                                           concat_axis=1)  # moe combine
        return body

    if op == "all_to_all_tiles@fft.transpose":
        # pencil-FFT global transpose on the ring: the signal-gathering
        # exchange, the local full-signal FFT, and the inverse scatter
        # back-to-back (direction-symmetric, so one tag covers both)
        ns = max(elems // (2 * nranks), 1)  # complex64: 8 B per element
        x = torch.ones(nranks, 1, ns, dtype=torch.complex64, device=device)

        def body():
            g = engine.all_to_all_tiles(x, names[0], split_axis=0,
                                        concat_axis=1)
            s = torch.fft.fft(g.reshape(g.shape[0], -1), dim=-1)
            return engine.all_to_all_tiles(s.reshape(g.shape), names[0],
                                           split_axis=1, concat_axis=0)
        return body

    if op == "grid_transpose":
        pg = mesh.shape[names[0]]
        side = max(int(math.sqrt(elems)), 1)
        x = torch.ones(side, side, **f32)
        return lambda: engine.grid_transpose(x, names, pg)
    if op == "ring_exchange":
        x = torch.ones(elems, **f32)
        return lambda: engine.ring_exchange(x, x, names[0])
    if op == "bcast":
        x = torch.ones(elems, **f32)
        return lambda: engine.bcast(x, names[0], 0)
    if op == "allreduce":
        ax = names if len(names) > 1 else names[0]
        x = torch.ones(elems, **f32)
        return lambda: engine.allreduce(x, ax)
    if op == "all_to_all_tiles":
        x = torch.ones(nranks * max(elems // nranks, 1), **f32)
        return lambda: engine.all_to_all_tiles(x, names[0], split_axis=0,
                                               concat_axis=0)
    raise ValueError(f"no measurement pattern for {op!r}")


def _measure_op_clean(mesh, op: str, nbytes: int, schedule: str, reps: int,
                      device) -> List[float]:
    """This rank's seconds for each of ``reps`` timed runs of one (op,
    schedule, size) on the live mesh, after one warm run. Each run starts
    at a barrier of the world and ends with the card drained."""
    import torch
    import torch.distributed as dist

    from repro_torch.comm.engine import CollectiveEngine

    body = _op_body(CollectiveEngine.for_mesh(mesh, schedule=schedule),
                    mesh, op, nbytes, device)
    body()
    times = []
    for _ in range(reps):
        dist.barrier()
        t0 = time.perf_counter()
        body()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    return times


def measure_world(mesh, jobs, reps: int, device) -> Dict:
    """Runs on every rank of a gloo world: each ``(op, size, schedule)`` of
    ``jobs`` timed by :func:`_measure_op_clean`, or the error it raised
    (every rank runs the same jobs in the same order, so a combination
    that fails, fails on every rank before it communicates)."""
    out = {}
    for op, size, schedule in jobs:
        try:
            out[op, size, schedule] = _measure_op_clean(
                mesh, op, size, schedule, reps, device)
        except Exception as e:  # noqa: BLE001 — skip broken combos
            out[op, size, schedule] = f"{type(e).__name__}: {e}"
    return out


# callsite patterns measured on the square torus (HPL's row/column
# broadcasts); everything else runs on the all-rank ring
_TORUS_OPS = ("grid_transpose", "bcast@hpl.panel")

# the ops and callsite patterns the port measures
MEASURED_OPS = ("bcast", "allreduce", "all_to_all_tiles", "ring_exchange",
                "grid_transpose", "bcast@hpl.panel",
                "all_to_all_tiles@ra.updates",
                "all_to_all_tiles@fft.transpose",
                "all_to_all_tiles@moe.dispatch",
                "all_to_all_tiles@tp.qkv",
                "all_to_all_tiles@sp.qkv",
                "all_to_all_tiles@decode.qkv")

# callsite patterns that time both directions of a paired exchange: the
# measured winner is filed under every tag of the pair
PAIRED_ALIASES: Dict[str, Tuple[str, ...]] = {
    "all_to_all_tiles@moe.dispatch": ("all_to_all_tiles@moe.combine",),
    "all_to_all_tiles@tp.qkv": ("all_to_all_tiles@tp.out",),
    "all_to_all_tiles@sp.qkv": ("all_to_all_tiles@sp.out",),
    "all_to_all_tiles@decode.qkv": ("all_to_all_tiles@decode.out",
                                    "all_to_all_tiles@decode.moe"),
}

# the measured mode's default ladders of message sizes
DEFAULT_SIZES = (1 << 10, 1 << 14, 1 << 18, 1 << 22)
DEFAULT_SIZES_QUICK = (1 << 10, 1 << 16)

# the per-token decode pattern is measured at decode-sized payloads (one
# token's q/k/v across the whole batch is a few KiB) instead of the
# training-sized default ladder: serving lives in the latency band
DECODE_SIZES = (1 << 8, 1 << 11, 1 << 14)
DECODE_SIZES_QUICK = (1 << 8, 1 << 12)


def op_sizes(op: str, sizes: Sequence[int]) -> Tuple[int, ...]:
    """The ladder ``op`` is measured at in a run on ``sizes``: the decode
    pattern's own (:data:`DECODE_SIZES`, :data:`DECODE_SIZES_QUICK`) where
    ``sizes`` is the default ladder (or the quick one), as the reference
    switches ladders only for its default sizes; ``sizes`` otherwise."""
    sizes = tuple(int(S) for S in sizes)
    if op.endswith("@decode.qkv"):
        if sizes == DEFAULT_SIZES:
            return DECODE_SIZES
        if sizes == DEFAULT_SIZES_QUICK:
            return DECODE_SIZES_QUICK
    return sizes


def table_keys(ops: Sequence[str] = MEASURED_OPS) -> List[str]:
    """The tuning-table keys a measured run of ``ops`` fills: each op and
    its :data:`PAIRED_ALIASES`."""
    return [k for op in ops for k in (op,) + PAIRED_ALIASES.get(op, ())]


def exact_schedules(op: str) -> List[str]:
    """The registered schedules of ``op`` (or of the op an ``op@callsite``
    pattern issues) that the measured mode times: all but the lossy ones."""
    from repro_torch.comm.engine import schedules_for

    return [s for s in schedules_for(op.split("@", 1)[0])
            if s not in LOSSY_SCHEDULES]


def untimed(record: Dict, sizes: Sequence[int],
            ops: Sequence[str] = MEASURED_OPS) -> List[str]:
    """Each ``op/schedule@size`` of ``ops`` x their :func:`op_sizes` of
    ``sizes`` x :func:`exact_schedules` that :func:`autotune_mesh`'s
    ``record`` holds no time for, with the error it raised where it
    raised one."""
    by_job = {}
    for key, rec in record.items():
        op, _, size = key.split("/")
        by_job[op, int(size)] = rec
    out = []
    for op in ops:
        for size in op_sizes(op, sizes):
            rec = by_job.get((op, int(size)), {})
            for name in exact_schedules(op):
                if name not in rec.get("times_s", {}):
                    why = rec.get("failed", {}).get(name, "not measured")
                    out.append(f"{op}/{name}@{size}B: {why}")
    return out


def _add_fault_delays(times: Dict, ops: Sequence[str],
                      sizes: Sequence[int], worlds: Dict) -> None:
    """Add the active fault injector's modeled delay
    (:func:`repro_torch.comm.faults.measured_extra_time`) to each timed job
    in place: over the first axis of its world for an ``op@callsite``
    pattern, over every axis otherwise. Runs in the process that called
    :func:`autotune_mesh`, since the spawned ranks never see its injector.
    The jobs are visited in the reference's order (op, then size, then
    schedule), so a jittered injector draws for the same jobs as the
    reference's ``_measure_op`` does."""
    from repro_torch.comm import faults

    if faults.active_injector() is None:
        return
    for op in ops:
        topo_axes = worlds["torus" if op in _TORUS_OPS else "ring"][2]
        axes = topo_axes[:1] if "@" in op else topo_axes
        for S in op_sizes(op, sizes):
            for name in exact_schedules(op):
                if (op, S, name) in times:
                    times[op, S, name] += faults.measured_extra_time(
                        op.split("@", 1)[0], name, S, axes)


def autotune_mesh(*, ops: Sequence[str] = MEASURED_OPS,
                  sizes: Optional[Sequence[int]] = None, reps: int = 3,
                  quick: bool = False, verbose: bool = True, device=None,
                  timeout: float = 600.0
                  ) -> Tuple[TuningTable, Dict]:
    """Time every registered exact schedule per op on gloo worlds of
    :data:`RANKS` processes and build a :class:`TuningTable` of per-size
    winners.

    Ring ops run over a ring of all the ranks; ``grid_transpose`` and
    ``bcast@hpl.panel`` over the square torus they form. An
    ``op@callsite`` entry times the op inside that callsite's pattern and
    lands under the tagged key, consulted first when the engine resolves
    with the matching callsite: ``"bcast@hpl.panel"`` times HPL's panel
    bcast back-to-back with the diagonal-block bcast on the torus row axis,
    ``"all_to_all_tiles@ra.updates"`` the GUPS bucketed int32 update
    exchange plus the receiving scatter-add, and
    ``"all_to_all_tiles@fft.transpose"`` the pencil-FFT gather / local
    transform / inverse-scatter sandwich, and
    ``"all_to_all_tiles@moe.dispatch"`` MoE's dispatch / expert compute /
    combine, ``"all_to_all_tiles@tp.qkv"`` the head-parallel hook's q/k/v
    gathers and inverse exchange, and ``"all_to_all_tiles@sp.qkv"`` the
    ring-attention hook's gathers interleaved with its kv hops (the hops
    themselves take the untagged ``ring_exchange`` entry), and
    ``"all_to_all_tiles@decode.qkv"`` one serving decode step's six
    exchanges (q/k/v head gathers, paged attention, inverse, MoE dispatch
    and combine) on its own ladder of decode-sized payloads
    (:func:`op_sizes`); each of the four files its winner also under its
    :data:`PAIRED_ALIASES`.
    Payloads live on ``device`` (the
    card unless ``"cpu"`` is given); gloo stages a card's payloads through
    host memory. A time is the slowest rank's, best of ``reps``, plus the
    active fault injector's modeled delay (:func:`_add_fault_delays`). Returns
    ``(table, record)``: ``record`` holds, per (op, size), the winner, each
    schedule's time and the error of each schedule that raised, which
    :func:`untimed` lists."""
    import torch

    from repro_torch.comm.topology import AxisTopology as Ax
    from repro_torch.core.hpcc import resolve_device
    from repro_torch.launch.mesh import spawn_mesh

    device = resolve_device(device)
    if sizes is None:
        sizes = DEFAULT_SIZES_QUICK if quick else DEFAULT_SIZES
    reps = 2 if quick else reps
    pg = math.isqrt(RANKS)
    worlds = {"ring": (RANKS, ("x",), (Ax("x", RANKS, "ring"),)),
              "torus": (pg * pg, ("rows", "cols"),
                        (Ax("rows", pg, "torus_row"),
                         Ax("cols", pg, "torus_col")))}

    times: Dict = {}
    failed: Dict = {}
    for world, (nprocs, axes, _) in worlds.items():
        jobs = [(op, S, name) for op in ops
                if (op in _TORUS_OPS) == (world == "torus")
                for S in op_sizes(op, sizes) for name in exact_schedules(op)]
        if not jobs:
            continue
        per_rank = spawn_mesh(nprocs, measure_world, jobs, reps, device,
                              axes=axes, timeout=timeout)
        for job in jobs:
            got = [r[job] for r in per_rank]
            if isinstance(got[0], str):
                if verbose:
                    print(f"  [autotune] {job[0]}/{job[2]}@{job[1]}B "
                          f"failed: {got[0]}")
                failed[job] = got[0]
                continue
            times[job] = min(max(rep) for rep in zip(*got))
    _add_fault_delays(times, ops, sizes, worlds)

    table = TuningTable(meta={"ranks": RANKS, "sizes": list(sizes),
                              "backend": "gloo", "device": device.type,
                              "torch": torch.__version__})
    record: Dict[str, Dict] = {}
    for op in ops:
        topo_axes = worlds["torus" if op in _TORUS_OPS else "ring"][2]
        if "@" in op:
            # callsite patterns are measured along one axis; the HPL pattern
            # is row/column-symmetric, so the winner is stored under every
            # single-axis signature. On the ring there is one axis.
            sigs = [axis_signature([a]) for a in topo_axes]
        else:
            sigs = [axis_signature(topo_axes)]
        winners, measured_sizes = [], []
        for S in op_sizes(op, sizes):
            names = exact_schedules(op)
            got = {n: times[op, S, n] for n in names if (op, S, n) in times}
            best = min(sorted(got), key=got.get) if got else None
            record[f"{op}/{sigs[0]}/{S}"] = {
                "winner": best, "times_s": got,
                "failed": {n: failed[op, S, n] for n in names
                           if (op, S, n) in failed}}
            if best is None:
                continue  # winners stay aligned with measured_sizes
            winners.append(best)
            measured_sizes.append(S)
            if verbose:
                ladder = " ".join(f"{n}={got[n] * 1e3:.2f}ms"
                                  for n in sorted(got))
                print(f"  [autotune] {op:16s} {S:>9d}B -> {best:8s} "
                      f"({ladder})")
        if winners:
            bounds = _winner_bounds(measured_sizes, winners)
            for key in table_keys((op,)):
                for s in sigs:
                    table.set(key, s, bounds)
    return table, record
