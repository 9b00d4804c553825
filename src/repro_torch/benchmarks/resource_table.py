"""Paper Table 7 analogue: per-benchmark "resource usage" on the
production mesh, from the meta-device dry run.

Port of ``benchmarks/resource_table.py`` (``:26-158``). The paper reports
logic, BRAM, DSPs and frequency per bitstream; the reference reports what
the compiled XLA program consumes per device. The port runs the paper's
three communication benchmarks once as one rank of the production mesh on
tensors that hold no data (:mod:`repro_torch.launch.dryrun`): b_eff on a
ring of 256 with 1 MiB messages, PTRANS on 16x16 at n = 32768, b = 512,
and HPL on 16x16 at n = 24576, b = 256 per schedule, both communication
types. Each row gives FLOPs, HBM bytes and wire bytes per device and the
three roofline terms on the H100 model. Every collective takes the
engine's dry transport, and every hand kernel its meta path
(``kernels/ops.py``: the kernel's own operations and bytes). The LM rows
are read from ``results/dryrun_torch/``. The figures are counts and byte
sizes, not measurements; the collective term prices the host's loopback
(``"links": "loopback"``).

    python -m repro_torch.benchmarks.resource_table

Writes ``results/bench/torch_resource_table.json``.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import torch

from repro_torch import roofline as rl
from repro_torch.benchmarks.common import fmt_bytes, save_result, table
from repro_torch.comm.types import H100_80GB

META = torch.device("meta")


def _terms(prof, chips: int, model_flops: float) -> dict:
    r = rl.from_stats(prof.stats(), chips=chips, hw=H100_80GB,
                      model_flops=model_flops)
    return {"flops_per_device": r.flops,
            "hbm_bytes_per_device": r.hbm_bytes,
            "collective_wire_bytes": r.coll_wire_bytes,
            "compute_s": r.compute_s, "memory_s": r.memory_s,
            "collective_s": r.collective_s, "dominant": r.dominant,
            "useful_ratio": r.useful_ratio,
            "per_op": r.details["per_op_bytes"],
            "kernels": prof.kernels, "links": "loopback"}


def dry_hpcc() -> dict:
    """The three communication benchmarks at production scale, dry-run as
    one rank of the production mesh (the reference's ``_lower_hpcc``):
    rank 0, and rank 1 for PTRANS."""
    from repro_torch.comm.engine import CollectiveEngine
    from repro_torch.comm.types import CommunicationType as CT
    from repro_torch.core import beff as beff_mod
    from repro_torch.core import hpl as hpl_mod
    from repro_torch.core import ptrans as ptrans_mod
    from repro_torch.launch.dryrun import profile
    from repro_torch.launch.mesh import dry_mesh

    out = {}
    # --- b_eff: ring over one pod (256 ranks), 1 MiB messages -------------
    mesh = dry_mesh((256,), ("x",))
    L = 1 << 20
    for ct in (CT.ICI_DIRECT, CT.HOST_STAGED):
        step = beff_mod.make_step(CollectiveEngine.for_mesh(mesh, ct),
                                  rounds=4)
        fwd = torch.empty((L,), dtype=torch.uint8, device=META)
        bwd = torch.empty((L,), dtype=torch.uint8, device=META)
        out[f"b_eff/{ct.value}"] = _terms(
            profile(lambda: step(fwd, bwd), (fwd, bwd)), 256, 0.0)

    # --- PTRANS: 16x16 grid, n = 32768 (the paper's matrix), block 512 ----
    # as rank 1, at (0, 1): a rank on the diagonal, as rank 0 is, is its own
    # transpose partner and sends nothing; 240 of the 256 ranks send
    torus = dry_mesh((16, 16), ("rows", "cols"))
    off_diagonal = dry_mesh((16, 16), ("rows", "cols"), rank=1)
    n, b = 32768, 512
    m = (n // b // 16) * b
    for ct in (CT.ICI_DIRECT, CT.HOST_STAGED):
        step = ptrans_mod.make_step(
            off_diagonal, 16, CollectiveEngine.for_mesh(off_diagonal, ct))
        a = torch.empty((m, m), device=META)
        c = torch.empty((m, m), device=META)
        out[f"ptrans/{ct.value}"] = _terms(
            profile(lambda: step(a, c), (a, c)), 256, float(n) * n)

    # --- HPL: 16x16 torus, n = 24576 (the paper's multi-FPGA size), b 256 -
    n, b = 24576, 256
    m = (n // b // 16) * b
    for ct, sched in ((CT.ICI_DIRECT, "chain"), (CT.ICI_DIRECT, "native"),
                      (CT.HOST_STAGED, "staged")):
        fact = hpl_mod.make_factorize(torus, pg=16, nb=n // b, b=b, comm=ct,
                                      schedule=sched)
        a = torch.empty((m, m), device=META)
        out[f"hpl/{ct.value}/{sched}"] = _terms(
            profile(lambda: fact(a), (a,)), 256, 2.0 * n ** 3 / 3.0)
    return out


def lm_rows(d=None) -> list:
    """The ``ok`` LM cells of ``results/dryrun_torch`` (or ``d``)."""
    from repro_torch.launch.dryrun import RESULTS_DIR

    d = Path(d) if d is not None else RESULTS_DIR
    if not d.is_dir():
        return []
    recs = [json.loads(p.read_text()) for p in sorted(d.glob("*.json"))]
    return [r for r in recs if r.get("status") == "ok"]


def main(quick: bool = False, schedule=None, device=None) -> dict:
    # a dry run: nothing is measured, so ``quick``, ``schedule`` and
    # ``device`` are accepted for the driver's one signature only
    print("== resource table (paper Table 7 analogue): production-mesh "
          "dry-run counts per device (counts, not measurements) ==")
    hpcc = dry_hpcc()
    rows = [[name, f"{t['flops_per_device']:.3g}",
             fmt_bytes(t["hbm_bytes_per_device"]),
             fmt_bytes(t["collective_wire_bytes"]),
             f"{t['compute_s']:.3g}", f"{t['memory_s']:.3g}",
             f"{t['collective_s']:.3g}", t["dominant"],
             ", ".join(f"{k} x{v['calls']}"
                       for k, v in sorted(t["kernels"].items()))]
            for name, t in hpcc.items()]
    print(table(rows, ["benchmark", "FLOPs/dev", "HBM/dev", "wire/dev",
                       "compute_s", "memory_s", "coll_s", "dominant",
                       "kernels"]))

    lm = lm_rows()
    if lm:
        print("\n-- LM cells (from results/dryrun_torch) --")
        print(table([[r["arch"], r["shape"], r["mesh"],
                      f"{r['flops_per_device']:.3g}",
                      fmt_bytes(r["hbm_bytes_per_device"]),
                      fmt_bytes(r["collective_wire_bytes"]),
                      fmt_bytes(r["peak_bytes_per_device"]),
                      r["dominant"], f"{r['useful_ratio']:.1%}"]
                     for r in lm],
                    ["arch", "shape", "mesh", "FLOPs/dev", "HBM/dev",
                     "wire/dev", "peak/dev", "dominant", "useful"]))
    record = {"hpcc": hpcc, "lm": [{k: r[k] for k in (
        "arch", "shape", "mesh", "flops_per_device", "hbm_bytes_per_device",
        "collective_wire_bytes", "peak_bytes_per_device", "dominant",
        "useful_ratio")} for r in lm],
        "chips": math.prod((16, 16)), "hw": H100_80GB.name,
        "figures": "dry-run counts, not measurements"}
    save_result("resource_table", record)
    return record


if __name__ == "__main__":
    main()
