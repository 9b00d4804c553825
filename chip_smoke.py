#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one card.

    python3 chip_smoke.py

Phases, one JSON line each:

1. build     — compile every CUDA source of the port with nvcc (sm_90a);
2. kernels   — hold each HPL kernel against its plain PyTorch version on the
               card, at HPL's shapes (m = 16384, b = 64) and at ragged and
               strided shapes, and time kernel, plain version and the
               nearest PyTorch library call (fp32 library calls run with
               TF32 off); the bf16 gemm_update is checked too;
3. hpl       — ``run_hpl`` on the 1x1 grid at n = 16384, b = 64: residual
               < 1, GFLOP/s, and every kernel launched nb = 256 times per
               factorization (the counts are zeroed just before);
4. lookahead — depths 1 and 2 at n = 4096 equal eager bit for bit, with the
               launch counts the pipeline implies;
5. cpu       — the card's LU at n = 2048 against the port's plain CPU LU.

Then the card's ``nvidia-smi`` name and power limit, the per-kernel summary
line ``{"kernels": [...]}``, and last ``{"ok": true, "device": ...}``. Any
failed check raises and the script exits non-zero. Without a CUDA device,
or without the repository's ``src/repro_torch`` beside it, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_MAIN, B_MAIN = 16384, 64
N_LOOKAHEAD = 4096
N_CPU = 2048
# H100 SXM data sheet (dense, no sparsity): HBM3 rate and peak rates
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12           # fp32 outside the tensor cores
BF16_TENSOR_FLOPS = 989e12
# tolerances of tests/test_kernels.py
GEMM_ATOL = {"float32": 2e-4, "bfloat16": 8e-2}   # times sqrt(K); rtol 1e-2
LU_TOL = (1e-5, 1e-5)                             # rtol, atol
TRSM_TOL = (1e-4, 1e-4)
SOURCES = {"gemm_update": "src/repro_torch/kernels/csrc/gemm_update.cu",
           "lu_factor_block": "src/repro_torch/kernels/csrc/lu.cu",
           "trsm_lower_left": "src/repro_torch/kernels/csrc/lu.cu",
           "trsm_upper_right": "src/repro_torch/kernels/csrc/lu.cu"}
REPLACES = {"gemm_update": "src/repro/kernels/gemm.py:82",
            "lu_factor_block": "src/repro/kernels/lu.py:49",
            "trsm_lower_left": "src/repro/kernels/lu.py:86",
            "trsm_upper_right": "src/repro/kernels/lu.py:125"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, peak_flops: float = FP32_FLOPS):
    """Least time the card could take: bytes at the HBM rate against
    operations at the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def allclose(torch, got, want, rtol, atol):
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    return ok, float(diff.max())


def phase_build(card: str):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build()
    seconds = time.perf_counter() - t0
    ptxas = []
    for stem in libs:
        log = _build.build_dir() / f"{stem}.log"
        if log.exists():
            ptxas += [ln.strip() for ln in log.read_text().splitlines()
                      if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "card": card, "seconds": seconds,
          "libs": sorted(libs),
          "dir": str(_build.build_dir().relative_to(ROOT)), "ptxas": ptxas})


def phase_kernels(torch):
    """Each kernel against its plain version at HPL's shapes; times."""
    from repro_torch.kernels import gemm as kgemm
    from repro_torch.kernels import lu as klu
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def dominant(n):
        return randn(n, n) + n * torch.eye(n, device=dev)

    m, b = N_MAIN, B_MAIN
    rows = {}

    # gemm_update: HPL's trailing update, C (m, m) -= L (m, b) @ U (b, m)
    c0, a, bb = randn(m, m), randn(m, b), randn(b, m)
    want = ref.gemm_update(c0, a, bb, alpha=-1.0)
    got = kgemm.gemm_update(c0.clone(), a, bb, alpha=-1.0)
    atol = GEMM_ATOL["float32"] * math.sqrt(b)
    ok, err = allclose(torch, got, want, 1e-2, atol)
    check(ok, f"gemm_update fp32 disagrees with its plain version: {err}")
    del want, got
    c_run = c0.clone()
    ms = cuda_ms(torch, lambda: kgemm.gemm_update(c_run, a, bb), iters=10)
    plain_ms = cuda_ms(torch, lambda: ref.gemm_update(c0, a, bb), iters=2,
                       warmup=1)
    lib_ms = cuda_ms(torch, lambda: torch.addmm(c0, a, bb, alpha=-1.0),
                     iters=10)
    bms, by = bound(4 * (m * b + b * m + 2 * m * m), 2 * m * m * b)
    rows["gemm_update"] = dict(
        shape=f"C({m},{m}) A({m},{b}) B({b},{m}) fp32", max_abs_err=err,
        tol={"atol": atol, "rtol": 1e-2}, ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=lib_ms,
        library="torch.addmm(c, a, b, alpha=-1), allow_tf32=False")
    del c_run

    # the same update in bf16 (fp32 sums, rounded once)
    c16, a16, b16 = c0.bfloat16(), a.bfloat16(), bb.bfloat16()
    del c0
    want = ref.gemm_update(c16, a16, b16, alpha=-1.0)
    got = kgemm.gemm_update(c16.clone(), a16, b16, alpha=-1.0)
    atol16 = GEMM_ATOL["bfloat16"] * math.sqrt(b)
    ok, err16 = allclose(torch, got, want, 1e-2, atol16)
    check(ok, f"gemm_update bf16 disagrees with its plain version: {err16}")
    del want, got
    ms16 = cuda_ms(torch, lambda: kgemm.gemm_update(c16, a16, b16), iters=10)
    lib16 = cuda_ms(torch, lambda: torch.addmm(c16, a16, b16, alpha=-1.0),
                    iters=10)
    bms16, by16 = bound(2 * (m * b + b * m + 2 * m * m), 2 * m * m * b,
                        BF16_TENSOR_FLOPS)
    emit({"phase": "kernels.bf16", "kernel": "gemm_update",
          "shape": f"C({m},{m}) A({m},{b}) B({b},{m}) bf16",
          "max_abs_err": err16, "tol": {"atol": atol16, "rtol": 1e-2},
          "ms": ms16, "library_ms": lib16, "bound_ms": bms16,
          "bound_by": by16})
    del c16, a16, b16, a, bb
    torch.cuda.empty_cache()

    # lu_factor_block: HPL's (b, b) diagonal block
    blk = dominant(b)
    want, got = ref.lu_factor_block(blk), klu.lu_factor_block(blk)
    ok, err = allclose(torch, got, want, *LU_TOL)
    check(ok, f"lu_factor_block disagrees with its plain version: {err}")
    flops = sum((b - k - 1) + 2 * (b - k - 1) ** 2 for k in range(b))
    bms, by = bound(4 * 2 * b * b, flops)
    rows["lu_factor_block"] = dict(
        shape=f"({b},{b}) fp32", max_abs_err=err,
        tol={"rtol": LU_TOL[0], "atol": LU_TOL[1]},
        ms=cuda_ms(torch, lambda: klu.lu_factor_block(blk), iters=200),
        plain_ms=cuda_ms(torch, lambda: ref.lu_factor_block(blk), iters=5),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.linalg.lu_factor_ex(
            blk, pivot=False), iters=200),
        library="torch.linalg.lu_factor_ex(a, pivot=False)")

    # trsm_lower_left: the Top panel, X (b, m) = L^{-1} A_kj
    lu_blk = want
    panel = randn(b, m)
    want = ref.trsm_lower_left(lu_blk, panel)
    got = klu.trsm_lower_left(lu_blk, panel)
    ok, err = allclose(torch, got, want, *TRSM_TOL)
    check(ok, f"trsm_lower_left disagrees with its plain version: {err}")
    bms, by = bound(4 * (b * b + 2 * b * m), m * b * (b - 1))
    rows["trsm_lower_left"] = dict(
        shape=f"lu({b},{b}) B({b},{m}) fp32", max_abs_err=err,
        tol={"rtol": TRSM_TOL[0], "atol": TRSM_TOL[1]},
        ms=cuda_ms(torch, lambda: klu.trsm_lower_left(lu_blk, panel),
                   iters=100),
        plain_ms=cuda_ms(torch, lambda: ref.trsm_lower_left(lu_blk, panel),
                         iters=5),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.linalg.solve_triangular(
            lu_blk, panel, upper=False, unitriangular=True), iters=100),
        library="torch.linalg.solve_triangular(lu, b, upper=False, "
                "unitriangular=True)")

    # trsm_upper_right: the Left panel, X (m, b) = A_ik U^{-1}
    panel = randn(m, b)
    want = ref.trsm_upper_right(lu_blk, panel)
    got = klu.trsm_upper_right(lu_blk, panel)
    ok, err = allclose(torch, got, want, *TRSM_TOL)
    check(ok, f"trsm_upper_right disagrees with its plain version: {err}")
    bms, by = bound(4 * (b * b + 2 * b * m), m * b * b)
    rows["trsm_upper_right"] = dict(
        shape=f"lu({b},{b}) B({m},{b}) fp32", max_abs_err=err,
        tol={"rtol": TRSM_TOL[0], "atol": TRSM_TOL[1]},
        ms=cuda_ms(torch, lambda: klu.trsm_upper_right(lu_blk, panel),
                   iters=100),
        plain_ms=cuda_ms(torch, lambda: ref.trsm_upper_right(lu_blk, panel),
                         iters=5),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.linalg.solve_triangular(
            lu_blk, panel, upper=True, left=False), iters=100),
        library="torch.linalg.solve_triangular(lu, b, upper=True, "
                "left=False)")

    # ragged and strided shapes: edges of tiles, slabs that are not 256
    # wide, a block of 48, views with row strides wider than their rows
    big = randn(300, 512)
    c_view, a_view, b_small = big[:, 64:397], randn(300, 80)[:, 3:40], \
        randn(37, 333)
    want = ref.gemm_update(c_view, a_view, b_small, alpha=0.5)
    got = kgemm.gemm_update(c_view.clone(), a_view, b_small, alpha=0.5)
    ragged = {"gemm_update": allclose(torch, got, want, 1e-2,
                                      GEMM_ATOL["float32"] * math.sqrt(37))}
    kgemm.gemm_update(c_view, a_view, b_small, alpha=0.5)  # into ``big``
    check(torch.equal(big[:, 64:397], got),
          "gemm_update on a strided view differs from the same update "
          "on a contiguous copy")
    blk48 = dominant(96)[:48, :48]
    lu48 = ref.lu_factor_block(blk48)
    ragged["lu_factor_block"] = allclose(
        torch, klu.lu_factor_block(blk48), lu48, *LU_TOL)
    p = randn(48, 1200)[:, :1000]
    ragged["trsm_lower_left"] = allclose(
        torch, klu.trsm_lower_left(lu48, p), ref.trsm_lower_left(lu48, p),
        *TRSM_TOL)
    p = randn(1000, 64)[:, 5:53]
    ragged["trsm_upper_right"] = allclose(
        torch, klu.trsm_upper_right(lu48, p), ref.trsm_upper_right(lu48, p),
        *TRSM_TOL)
    for name, (ok, err) in ragged.items():
        check(ok, f"{name} disagrees with its plain version on a ragged "
                  f"shape: {err}")
    torch.cuda.synchronize()
    emit({"phase": "kernels", "main_path_shapes": rows,
          "ragged_max_abs_err": {k: v[1] for k, v in ragged.items()}})
    return rows


def phase_hpl(torch):
    from repro_torch.core.hpl import run_hpl
    from repro_torch.kernels import ops

    nb = N_MAIN // B_MAIN
    reps = 2
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_hpl(n=N_MAIN, b=B_MAIN, reps=reps, device="cuda")
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    per_fact = res.details["launches"]
    check(res.error < 1.0, f"HPL residual {res.error} >= 1")
    for name in ops.KERNELS:
        check(per_fact[name] == nb and counts[name] == nb * (reps + 1),
              f"{name} launched {counts[name]} times in {reps + 1} "
              f"factorizations, expected {nb} each")
    emit({"phase": "hpl", "n": N_MAIN, "b": B_MAIN, "gflops": res.metric,
          "seconds": res.times["best"], "residual": res.error,
          "factorizations": reps + 1, "launches": counts,
          "launches_per_factorization": per_fact, "wall_s": wall,
          "device": res.details["device"],
          "schedule": res.details["schedule"]})
    return counts, per_fact, res


def phase_lookahead(torch):
    from repro_torch.core.hpl import generate_system, make_factorize
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import single_rank_mesh

    n, b = N_LOOKAHEAD, B_MAIN
    nb = n // b
    a = torch.from_numpy(generate_system(n)[0]).cuda()
    mesh = single_rank_mesh()
    eager = make_factorize(mesh, pg=1, nb=nb, b=b)(a)
    out = {}
    for d in (1, 2):
        ops.reset_launch_counts()
        lu = make_factorize(mesh, pg=1, nb=nb, b=b, lookahead=d)(a)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        bits = int((lu.view(torch.int32) != eager.view(torch.int32)).sum())
        check(torch.equal(lu, eager) and bits == 0,
              f"lookahead d={d} differs from eager in {bits} entries")
        want = {"gemm_update": d * (d - 1) + nb * (2 * d + 1),
                "lu_factor_block": nb + d, "trsm_lower_left": nb + d,
                "trsm_upper_right": nb + d}
        check(counts == want, f"lookahead d={d} launches {counts}, "
                              f"expected {want}")
        out[f"d{d}"] = {"bitwise_equal": True, "launches": counts}
    emit({"phase": "lookahead", "n": n, "b": b, **out})


def phase_cpu(torch):
    from repro_torch.core.hpl import generate_system
    from repro_torch.core.hpl_blocked import lu_blocked

    n, b = N_CPU, B_MAIN
    a = torch.from_numpy(generate_system(n)[0])
    card = lu_blocked(a.cuda(), b).cpu()
    host = lu_blocked(a, b)
    ok, err = allclose(torch, card, host, 1e-4, 1e-3)
    check(ok, f"card LU differs from the plain CPU LU at n={n}: {err}")
    emit({"phase": "cpu", "n": n, "b": b, "max_abs_err": err,
          "tol": {"rtol": 1e-4, "atol": 1e-3}})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is missing beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    phase_build(smi)
    rows = phase_kernels(torch)
    counts, per_fact, _ = phase_hpl(torch)
    phase_lookahead(torch)
    phase_cpu(torch)

    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=counts[name],
                    launches_per_factorization=per_fact[name],
                    max_abs_err=r["max_abs_err"], tol=r["tol"], ms=r["ms"],
                    kernel_ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"], shape=r["shape"])
               for name, r in rows.items()]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
