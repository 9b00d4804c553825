"""The benchmark's machinery, shared by every cell.

Everything that belongs to one configuration, cell, entry point or
per-layer metric sits in a file of its own beside this one and is found by
the name that ``BENCHMARK.json`` gives it:

  configs/<config>.json    one configuration: its source, sizes and limits
  workloads/<cell>.json    one cell: its traffic parameters and limits
  drivers/<driver>.py      the timed loop of one entry point of the port
  metrics/<metric>.py      the reader of one per-layer metric
  reference/<name>.py      the plain reference (torch only, none of the port)
  peaks.json               published peaks, by device name

This module holds no list of cells, configurations or metrics.
"""
from __future__ import annotations

import bisect
import importlib.util
import json
import re
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

BENCH = Path(__file__).resolve().parent
# top-level module names the measured process may not hold: the JAX package
# and JAX itself (compared whole: ``repro_torch`` is not ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class BenchError(Exception):
    """A manifest, cell or configuration that the harness cannot run."""


def load_json(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except OSError as e:
        raise BenchError(f"cannot read {path}: {e}") from e


def load_module(path: Path, kind: str):
    """Import the Python file ``path`` as a module of its own (the files are
    named after metrics and may hold dots)."""
    if not path.is_file():
        raise BenchError(f"no {kind} file {path}")
    name = f"_hpcc_{kind}_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reference(name: str, bench: Path = BENCH):
    return load_module(bench / "reference" / f"{name}.py", "reference")


# ---------------------------------------------------------------------------
# the manifest and one cell
# ---------------------------------------------------------------------------


@dataclass
class Cell:
    """One entry of ``workloads`` with its configuration and traffic files
    merged: ``params`` holds the configuration's keys overlaid by the
    traffic's, ``limits`` the configuration's limits overlaid by the
    cell's."""
    name: str
    entry: dict
    config: dict
    workload: dict
    params: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    bench: Path

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    @property
    def driver(self) -> str:
        return self.config["driver"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its configuration from
    ``configs/<config>.json`` and its traffic from ``workloads/<name>.json``,
    under the folder this module lies in."""
    manifest = load_json(root / "BENCHMARK.json")
    entries = [w for w in manifest.get("workloads", []) if w["name"] == name]
    if len(entries) != 1:
        raise BenchError(f"BENCHMARK.json has no single cell {name!r}")
    entry = entries[0]
    bench = root / "hpcc_bench"
    config = load_json(bench / "configs" / f"{entry['config']}.json")
    workload = load_json(bench / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if workload.get(key) != entry[key]:
            raise BenchError(f"workloads/{name}.json names {key} "
                             f"{workload.get(key)!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    if config.get("name") != entry["config"]:
        raise BenchError(f"configs/{entry['config']}.json names itself "
                         f"{config.get('name')!r}")
    params = {**config.get("sizes", {}), **workload.get("params", {})}
    limits = {**config.get("limits", {}), **workload.get("limits", {})}
    return Cell(name=name, entry=entry, config=config, workload=workload,
                params=params, limits=limits,
                end_to_end=[m for m in manifest["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in manifest["per_layer"]
                           if _applies(m, name)],
                bench=bench)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def larger(a: float, b: float) -> float:
    """The larger of two readings, NaN where either is NaN (Python's
    ``max`` drops a NaN that comes second)."""
    return a if a != a or a >= b else b


def quantile(values: List[float], q: float) -> float:
    """The ``q``-quantile (0 < q < 1) of ``values``, interpolated between
    order statistics (``statistics.quantiles``' inclusive method)."""
    if len(values) == 1:
        return float(values[0])
    cuts = statistics.quantiles(values, n=100, method="inclusive")
    return float(cuts[round(q * 100) - 1])


class Sync:
    """Wait for what the card has queued (on the CPU every operation has
    finished when it returns)."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.card = torch.device(device).type == "cuda"

    def __call__(self) -> None:
        if self.card:
            self.torch.cuda.synchronize()


class Marks:
    """Completion marks of a stream of enqueued steps: CUDA events on the
    card (the device's own clock), the host clock elsewhere (where every
    operation has finished when it returns)."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.card = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self):
        if self.card:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        self.marks.append(ev)
        return ev

    def wait(self, i: int) -> None:
        """Block the host until mark ``i`` has completed."""
        if self.card:
            self.marks[i].synchronize()

    def intervals_ms(self) -> List[float]:
        """The time between consecutive marks, in ms."""
        m = self.marks
        if self.card:
            return [m[i - 1].elapsed_time(m[i]) for i in range(1, len(m))]
        return [(m[i] - m[i - 1]) * 1e3 for i in range(1, len(m))]


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------


class Trace:
    """``torch.profiler`` over a few consecutive units of a window. The
    driver calls :meth:`start` before the first traced unit and :meth:`stop`
    once the last has completed on the device. On the card only device
    activity is recorded (kernels, copies, the CUDA runtime's calls), which
    adds little to the host's time per launch; the traced window is the
    host's time from the device drained before the first unit to the device
    drained after the last."""

    def __init__(self, units: int, sync: Sync):
        self.units = units
        self.sync = sync
        self.prof = None
        self.done = 0
        self.window_s = 0.0
        self._t0 = None

    @property
    def active(self) -> bool:
        return self._t0 is not None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        activity = (ProfilerActivity.CUDA if self.sync.card
                    else ProfilerActivity.CPU)
        self.sync()
        self.prof = profile(activities=[activity])
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self.sync()
        self.window_s = time.perf_counter() - self._t0
        self._t0 = None
        self.prof.stop()


@dataclass
class TraceSummary:
    """What the readers of per-layer metrics read from one trace: device
    seconds and operation counts by name, the traced window and the device's
    busy seconds in it, and idle gaps by what the host was doing."""
    window_s: float
    busy_s: float
    device_s: Dict[str, float] = field(default_factory=dict)
    device_n: Dict[str, int] = field(default_factory=dict)
    idle_by_host: Dict[str, float] = field(default_factory=dict)

    def seconds(self, *parts: str) -> float:
        """Device seconds of the operations whose name holds any of
        ``parts``."""
        return sum(s for k, s in self.device_s.items()
                   if any(p in k for p in parts))

    def count(self, *parts: str) -> int:
        """Device operations whose name holds any of ``parts`` (all, with
        none given)."""
        return sum(c for k, c in self.device_n.items()
                   if not parts or any(p in k for p in parts))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, s] for k, s in ops],
                "idle_gaps": [[k, s] for k, s in gaps]}


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = re.sub(r"^void ", "", name)
    depth = 0
    for i, ch in enumerate(name):
        if ch in "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return name[:i][:120]
    return name[:120]


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(device: List[Tuple[str, float, float]],
              host: List[Tuple[str, float, float]],
              window_s: float) -> TraceSummary:
    """Reduce a trace to a :class:`TraceSummary`. ``device`` and ``host``
    are ``(name, start_us, end_us)`` of the device's operations and of the
    host's operators and runtime calls, on one clock; ``window_s`` is the
    traced window's length, which holds every device operation. The idle
    time between the device's operations is named by the innermost host
    event that holds its midpoint; the rest of the window, before the first
    operation and after the last, is the window's edges."""
    dev_s: Dict[str, float] = {}
    dev_n: Dict[str, int] = {}
    spans = []
    for name, s, e in device:
        key = short_name(name)
        dev_s[key] = dev_s.get(key, 0.0) + (e - s) * 1e-6
        dev_n[key] = dev_n.get(key, 0) + 1
        spans.append((s, e))
    busy = _merge(spans)
    busy_s = sum(e - s for s, e in busy) * 1e-6

    # host events nest on a thread: the innermost holding a point is the
    # latest-starting one that has not ended by then
    hosts = sorted((s, e, n) for n, s, e in host)
    starts = [h[0] for h in hosts]
    idle: Dict[str, float] = {}
    for (_, g0), (g1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (g0 + g1)
        what = "host outside any operator"
        last = bisect.bisect_right(starts, mid) - 1
        for j in range(last, max(-1, last - 4000), -1):
            if hosts[j][1] >= mid:
                what = hosts[j][2]
                break
        idle[what] = idle.get(what, 0.0) + (g1 - g0) * 1e-6
    if busy:
        edges = window_s - (busy[-1][1] - busy[0][0]) * 1e-6
        if edges > 0:
            idle["window edges (drain, profiler start and stop)"] = edges
    return TraceSummary(window_s=window_s, busy_s=busy_s, device_s=dev_s,
                        device_n=dev_n, idle_by_host=idle)


def summarize_profile(trace: Trace) -> TraceSummary:
    """The :class:`TraceSummary` of a finished :class:`Trace`: the device's
    operations (profiler annotations left out) and the host's events."""
    from torch.autograd import DeviceType
    device, host = [], []
    for e in trace.prof.events():
        rng = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(("ProfilerStep", "## ")) \
                    and "annotation" not in e.name:
                device.append(rng)
        elif e.device_type == DeviceType.CPU:
            host.append(rng)
    return summarize(device, host, trace.window_s)


# ---------------------------------------------------------------------------
# per-layer metrics
# ---------------------------------------------------------------------------


@dataclass
class Context:
    """What a reader of a per-layer metric gets: the cell, the traced units
    (solves or steps) and their trace, the launches the port's kernel
    wrappers counted over them, the median host time of the window's
    untraced units (``unit_s``), and the device's published peaks."""
    cell: Cell
    units: int
    trace: TraceSummary
    launches: Dict[str, int]
    unit_s: Optional[float]
    peaks: Optional[dict]


def read_metrics(ctx: Context, strict: bool = False) -> Dict[str, dict]:
    """Every per-layer metric of the cell, ``{name: {"value", "unit",
    ...}}``. A reader that finds nothing to read returns None: the metric is
    left out, or with ``strict`` (a run on the card, where every metric
    that lists the cell has something to read) the run fails, naming it."""
    out = {}
    for m in ctx.cell.per_layer:
        mod = load_module(ctx.cell.bench / "metrics" / f"{m['name']}.py",
                          "metric")
        got = mod.read(ctx)
        if got is None:
            if strict:
                raise BenchError(f"the reader of {m['name']} found nothing "
                                 f"to read in cell {ctx.cell.name}")
            continue
        extra = dict(got) if isinstance(got, dict) else {"value": got}
        value = extra.pop("value")
        out[m["name"]] = {"value": value, "unit": m["unit"], **extra}
    return out


def peaks_for(kind: str, bench: Path = BENCH) -> Optional[dict]:
    return load_json(bench / "peaks.json").get(kind)


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the measured process may not
    hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
