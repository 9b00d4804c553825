"""Shared helpers of the port's benchmark scripts: tables, units, results.

The port's own copy of ``benchmarks/common.py``'s ``table``, ``fmt_bw``,
``fmt_bytes`` and ``save_result``. Results go to ``results/bench/torch_<name>.json`` at the
root of the checkout.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

RESULTS = Path(__file__).resolve().parents[3] / "results" / "bench"


def save_result(name: str, record: Dict) -> Path:
    RESULTS.mkdir(parents=True, exist_ok=True)
    path = RESULTS / f"torch_{name}.json"
    path.write_text(json.dumps(record, indent=1, default=str))
    return path


def table(rows: List[List], headers: List[str]) -> str:
    cols = [headers] + [[str(c) for c in r] for r in rows]
    widths = [max(len(r[i]) for r in cols) for i in range(len(headers))]

    def fmt(r):
        return "  ".join(str(c).ljust(w) for c, w in zip(r, widths))
    out = [fmt(headers), fmt(["-" * w for w in widths])]
    out += [fmt(r) for r in rows]
    return "\n".join(out)


def fmt_bw(b: float) -> str:
    for unit in ("B/s", "KB/s", "MB/s", "GB/s", "TB/s"):
        if abs(b) < 1000:
            return f"{b:.2f}{unit}"
        b /= 1000
    return f"{b:.2f}PB/s"


def fmt_bytes(b: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(b) < 1024:
            return f"{b:.2f}{unit}"
        b /= 1024
    return f"{b:.2f}PiB"
