"""Dry-run profiler: attribute the roofline terms to aten ops and engine
sources.

    python -m repro_torch.launch.analyze --arch qwen1.5-32b \\
        --shape decode_32k [--mesh single|multi] [--top 25]

Port of ``repro/launch/analyze.py``. The reference attributes FLOPs, HBM
bytes and collective bytes to the instructions of the compiled HLO
(``:22-135``). The port has no compiled program: it runs the cell once
through the meta-device dry run (:mod:`repro_torch.launch.dryrun`) and
attributes what the same counting modes saw: FLOPs and bytes to aten ops
(with their call counts), each hand kernel's own counts to the kernel,
and wire bytes to the engine's sources (callsite tags) and collective
ops. The figures are one rank's counts, not measurements.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Tuple

from repro_torch.comm import dry


def attribute(prof, top: int = 25) -> Dict[str, List[Tuple]]:
    """The top ``top`` contributors of a :class:`dryrun.Profile`: rows of
    (name, calls, amount) for FLOPs and HBM bytes (aten ops and hand
    kernels) and (source, op, count, wire bytes) for the collectives."""
    flops = [(f"aten.{k}", prof.calls.get(k, 0), v)
             for k, v in prof.flops.items()]
    flops += [(f"kernel.{k}", int(v["calls"]), v["flops"])
              for k, v in prof.kernels.items()]
    mem = [(f"aten.{k}", prof.calls.get(k, 0), v)
           for k, v in prof.bytes.items()]
    mem += [(f"kernel.{k}", int(v["calls"]), v["bytes"])
            for k, v in prof.kernels.items()]
    comm: Dict[Tuple[str, str], List[float]] = {}
    for o in prof.comm:
        row = comm.setdefault((o.source or "untagged", o.op), [0, 0.0])
        row[0] += 1
        row[1] += o.wire_bytes
    coll = [(src, op, n, w) for (src, op), (n, w) in comm.items()]

    def head(rows, key):
        return sorted(rows, key=key, reverse=True)[:top]
    return {"flops": head(flops, lambda r: r[2]),
            "memory": head(mem, lambda r: r[2]),
            "collective": head(coll, lambda r: r[3])}


def report(tops: Dict[str, List[Tuple]]) -> str:
    lines = ["-- FLOPs (one rank; counts, not measurements) --"]
    lines += [f"  {f:14.4g}  x{n:<6d} {name}" for name, n, f in tops["flops"]]
    lines.append("-- HBM bytes (unfused upper bound) --")
    lines += [f"  {b:14.4g}  x{n:<6d} {name}"
              for name, n, b in tops["memory"]]
    lines.append("-- collective wire bytes, by engine source --")
    lines += [f"  {w:14.4g}  x{n:<6d} {src} {op}"
              for src, op, n, w in tops["collective"]]
    return "\n".join(lines)


def main(argv=None) -> Dict[str, List[Tuple]]:
    from repro_torch.launch.dryrun import run_cell

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--fsdp", default=None, choices=[None, "on", "off"])
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    fsdp = None if args.fsdp is None else args.fsdp == "on"
    prof: list = []
    run_cell(args.arch, args.shape, args.mesh, fsdp=fsdp, prof=prof)
    tops = attribute(prof[0], top=args.top)
    print(report(tops))
    print(f"wire bytes by source: {dry.wire_by_source(prof[0].comm)}")
    return tops


if __name__ == "__main__":
    main()
