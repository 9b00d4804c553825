"""Run the full HPCC suite on the port — every benchmark, both
communication backends — and print a paper-style summary table (§3 of the
paper).

    python -m repro_torch.examples.hpcc_suite [--quick] [--device cuda|cpu]
        [--ranks 1|4]

Port of ``examples/hpcc_suite.py`` (``:25-56``): b_eff, PTRANS and HPL on
both communication types, then ``run_hpl_single``, STREAM, RandomAccess,
FFT and GEMM, at the reference's sizes. Each row's error is held to its
benchmark's gate (``_ranks.GATES``: residual < 1, errors 0, FFT < 1e-5);
a failed gate exits non-zero. Each row also records the kernel launches
it made (``ops.launch_counts``) beside the count its sizes imply; on the
card they must agree (the CPU runs the plain versions and launches
nothing). The last line is one JSON object with the rows.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.examples import _ranks

REPS = 1          # the reference's reps for b_eff, PTRANS and HPL
TIMED_REPS = 3    # the others' default reps (timeit: + 1 warm-up run)


def _row(rows, name, backend, metric, res, launched, expected):
    rows.append({"benchmark": name, "backend": backend, "metric": metric,
                 "error": res.error, "gate": _ranks.GATES[name][1],
                 "ok": _ranks.gate_ok(name, res.error),
                 "launches": launched, "expected_launches": expected})


def suite(device, quick: bool):
    """Every benchmark on this process's meshes: the rows."""
    from repro_torch.comm.types import CommunicationType as CT
    from repro_torch.core.beff import run_beff
    from repro_torch.core.fft import run_fft
    from repro_torch.core.gemm import run_gemm
    from repro_torch.core.hpl import run_hpl
    from repro_torch.core.hpl_blocked import run_hpl_single
    from repro_torch.core.ptrans import run_ptrans
    from repro_torch.core.randomaccess import run_randomaccess
    from repro_torch.core.stream import run_stream
    from repro_torch.kernels import ops

    ring, torus = _ranks.meshes()
    n, b = (256 if quick else 512), 64
    pg = torus.shape["rows"]
    nb = n // b
    rows = []

    def launched(fn):
        before = ops.launch_counts()
        res = fn()
        after = ops.launch_counts()
        return res, {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}

    for ct in (CT.ICI_DIRECT, CT.HOST_STAGED):
        r, got = launched(lambda: run_beff(
            ring, ct, max_log=8 if quick else 12, reps=REPS, rounds=2,
            device=device))
        _row(rows, "b_eff", ct.value, f"{r.metric/1e6:.2f} MB/s", r, got, {})
        r, got = launched(lambda: run_ptrans(torus, ct, n=n, b=b, reps=REPS,
                                             device=device))
        # (reps + 1 warm-up) steps of the step's launches
        per_step = r.details["launches"]["transpose_add"]
        _row(rows, "ptrans", ct.value, f"{r.metric:.3f} GFLOP/s", r, got,
             {"transpose_add": (REPS + 1) * max(per_step, 1)})
        r, got = launched(lambda: run_hpl(
            torus, ct, n=n, b=b,
            schedule="native" if ct is CT.ICI_DIRECT else "staged",
            reps=REPS, device=device))
        # nb launches of each HPL kernel per factorization on the 1x1 grid
        # (phase hpl), over (reps + 1 warm-up) factorizations
        _row(rows, "hpl", ct.value, f"{r.metric:.3f} GFLOP/s", r, got,
             {k: (REPS + 1) * (nb if pg == 1 else v)
              for k, v in r.details["launches"].items()
              if k in ops.HPL_KERNELS})

    r, got = launched(lambda: run_hpl_single(n=n, b=b, reps=REPS,
                                             device=device))
    _row(rows, "hpl_single", "-", f"{r.metric:.3f} GFLOP/s", r, got,
         {k: (REPS + 1) * nb for k in ops.HPL_KERNELS})
    r, got = launched(lambda: run_stream(
        ring, elems_per_device=1 << (16 if quick else 20), device=device))
    _row(rows, "stream", "-", f"{r.metric/1e9:.2f} GB/s", r, got,
         {k: TIMED_REPS + 1 for k in ops.STREAM_KERNELS})
    r, got = launched(lambda: run_randomaccess(
        ring, table_log=14 if quick else 20, device=device))
    _row(rows, "randomaccess", "-", f"{r.metric*1e3:.3f} MUPS", r, got, {})
    r, got = launched(lambda: run_fft(ring, log_size=8 if quick else 12,
                                      device=device))
    _row(rows, "fft", "-", f"{r.metric:.2f} GFLOP/s", r, got, {})
    r, got = launched(lambda: run_gemm(ring, m=128 if quick else 256,
                                       device=device))
    _row(rows, "gemm", "-", f"{r.metric:.2f} GFLOP/s", r, got,
         {"matmul": TIMED_REPS + 1})
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    _ranks.add_args(ap)
    args = ap.parse_args(argv)
    device = _ranks.check_device(args.device)
    rows = _ranks.run(suite, args.ranks, device, args.quick)

    print(f"\n{'benchmark':14s} {'backend':12s} {'metric':>18s} "
          f"{'error':>10s}  gate")
    print("-" * 72)
    for r in rows:
        print(f"{r['benchmark']:14s} {r['backend']:12s} {r['metric']:>18s} "
              f"{r['error']:10.2e}  {r['gate']}"
              + ("" if r["ok"] else "  FAILED"))
    print(json.dumps({"hpcc_suite": rows, "ranks": args.ranks,
                      "device": str(device)}))
    bad = [f"{r['benchmark']}/{r['backend']}" for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"gate failed: {bad}")
    return rows


if __name__ == "__main__":
    main()
