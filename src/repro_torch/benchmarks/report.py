"""The roofline table of the dry-run records, as markdown.

Port of ``benchmarks/report.py``, over ``results/dryrun_torch/`` (the
port's meta-device dry run, :mod:`repro_torch.launch.dryrun`). Its ``rf``
column is the ideal step (the model's FLOPs per device at the card's bf16
tensor-core peak, :data:`repro_torch.roofline.H100_BF16_PEAK_FLOPS`) over
the roofline step; the reference divides by TPU v5e's 197 TFLOP/s. The
fits summary checks each cell's peak bytes per device against the card's
80 GB (``H100_80GB.hbm_bytes``), not the reference's 16 GiB. The figures
are dry-run counts, not measurements.

    python -m repro_torch.benchmarks.report [DIR]
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

from repro_torch.comm.types import H100_80GB
from repro_torch.launch.dryrun import RESULTS_DIR
from repro_torch.roofline import H100_BF16_PEAK_FLOPS


def fmt(v, pat="{:.3g}"):
    return pat.format(v)


def main(d=RESULTS_DIR) -> list:
    recs, skips = [], []
    for p in sorted(Path(d).glob("*.json")):
        r = json.loads(p.read_text())
        (skips if r.get("status") == "skipped" else recs).append(r)
    failed = [r for r in recs if r.get("status") != "ok"]
    recs = [r for r in recs if r.get("status") == "ok"]

    lines = ["| arch | shape | mesh | FLOPs/dev | HBM B/dev | wire B/dev | "
             "compute_s | memory_s | coll_s | dominant | useful | rf |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        step = max(r["compute_s"], r["memory_s"], r["collective_s"])
        ideal = r["model_flops"] / r["chips"] / H100_BF16_PEAK_FLOPS
        rf = ideal / step if step else 0.0
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {fmt(r['flops_per_device'])} "
            f"| {fmt(r['hbm_bytes_per_device'])} "
            f"| {fmt(r['collective_wire_bytes'])} "
            f"| {fmt(r['compute_s'])} | {fmt(r['memory_s'])} "
            f"| {fmt(r['collective_s'])} | {r['dominant']} "
            f"| {r['useful_ratio']:.1%} | {rf:.3f} |")
    lines.append(f"\n{len(recs)} cells ok; {len(skips)} skipped (long_500k "
                 "on pure full-attention archs; layers that wait for ROADMAP "
                 f"A15); {len(failed)} failed. Dry-run counts, not "
                 "measurements; the collective term prices the host's "
                 "loopback.")
    over = [r for r in recs
            if r["peak_bytes_per_device"] > H100_80GB.hbm_bytes]
    if over:
        lines.append(f"cells above the card's {H100_80GB.hbm_bytes / 1e9:.0f}"
                     " GB per device (peak live bytes): "
                     f"{[(r['arch'], r['shape'], r['mesh']) for r in over]}")
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main(*(sys.argv[1:] or []))
