#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one card.

    python3 chip_smoke.py

Phases, one JSON line each:

1. build     — compile every CUDA source of the port with nvcc (sm_90a);
2. kernels   — hold each kernel against its plain PyTorch version on the
               card, at its main path's shapes (HPL: m = 16384, b = 64;
               transpose_add 16384^2; STREAM 2^28 elements; matmul 8192^3)
               and at ragged and strided shapes and in bf16, and time
               kernel, plain version and the nearest PyTorch library call
               (fp32 library calls run with TF32 off). matmul's limit is
               fp32 rounding, which a TF32 product and a dropped K step
               both exceed; the run shows that they do;
3. hpl       — ``run_hpl`` on the 1x1 grid at n = 16384, b = 64: residual
               < 1, GFLOP/s, and each HPL kernel launched nb = 256 times per
               factorization;
4. lookahead — depths 1 and 2 at n = 4096 equal eager bit for bit, with the
               launch counts the pipeline implies;
5. ptrans    — ``run_ptrans`` on the 1x1 grid at n = 16384, b = 128: error
               0.0 against B + A^T on the host, one transpose_add per step;
               ``nchunks=4`` (four launches per step) equals ``nchunks=1``
               bit for bit;
6. beff      — ``run_beff`` on the single-rank ring (max_log = 20,
               rounds = 4): byte check passes, buffers on the card. There is
               no wire: its bandwidth is the host's loop overhead;
7. stream    — ``run_stream`` at 2^28 fp32 elements per array (1 GiB, 21x
               the 50 MB L2): the four bandwidths, their share of the HBM
               rate, and every op equal to its plain version;
8. gemm      — ``run_gemm`` at m = 8192: GFLOP/s, error against
               ``torch.matmul`` with TF32 off, within fp32 rounding;
9. cpu       — the card's LU at n = 2048 against the port's plain CPU LU.

Each main-path phase zeroes the launch counts just before it runs and reads
them just after. Then the card's ``nvidia-smi`` name and power limit, the
per-kernel summary line ``{"kernels": [...]}`` (each kernel's launches from
the phase that drives it), and last ``{"ok": true, "device": ...}``. Any
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
N_PTRANS, B_PTRANS = 16384, 128
STREAM_ELEMS = 1 << 28
M_GEMM = 8192
# H100 SXM data sheet (dense, no sparsity): HBM3 rate and peak rates
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12           # fp32 outside the tensor cores
BF16_TENSOR_FLOPS = 989e12
# tolerances of tests/test_kernels.py
GEMM_ATOL = {"float32": 2e-4, "bfloat16": 8e-2}   # times sqrt(K); rtol 1e-2
LU_TOL = (1e-5, 1e-5)                             # rtol, atol
FP32_EPS = 2.0 ** -23
BF16_RTOL = 2.0 ** -7                             # one rounding to bf16
TRSM_TOL = (1e-4, 1e-4)
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"gemm_update": CSRC + "gemm_update.cu",
           "lu_factor_block": CSRC + "lu.cu",
           "trsm_lower_left": CSRC + "lu.cu",
           "trsm_upper_right": CSRC + "lu.cu",
           "transpose_add": CSRC + "transpose_add.cu",
           "stream_copy": CSRC + "stream.cu",
           "stream_scale": CSRC + "stream.cu",
           "stream_add": CSRC + "stream.cu",
           "stream_triad": CSRC + "stream.cu",
           "matmul": CSRC + "gemm_update.cu"}
REPLACES = {"gemm_update": "src/repro/kernels/gemm.py:82",
            "lu_factor_block": "src/repro/kernels/lu.py:49",
            "trsm_lower_left": "src/repro/kernels/lu.py:86",
            "trsm_upper_right": "src/repro/kernels/lu.py:125",
            "transpose_add": "src/repro/kernels/transpose.py:25",
            "stream_copy": "src/repro/kernels/stream.py:43",
            "stream_scale": "src/repro/kernels/stream.py:43",
            "stream_add": "src/repro/kernels/stream.py:43",
            "stream_triad": "src/repro/kernels/stream.py:43",
            "matmul": "src/repro/kernels/gemm.py:45"}


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


def max_abs(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def rms(x) -> float:
    return float(x.float().square().mean().sqrt())


def sum_atol(k: int, rms_a: float, rms_b: float) -> float:
    """Limit for two fp32 sums of the same K products that differ only in
    rounding (fused multiply-add or not): 16 eps sqrt(K) times the output's
    scale sqrt(K) rms(a) rms(b)."""
    return 16 * FP32_EPS * k * rms_a * rms_b


def cuda_once(torch, fn):
    """``fn()`` once: its result and its device time in ms."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bitwise(torch, got, want) -> bool:
    """Same shape, dtype and bits (integer views compared)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    view = {2: torch.int16, 4: torch.int32}[got.element_size()]
    return bool(torch.equal(got.contiguous().view(view),
                            want.contiguous().view(view)))


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
    del big, c_view, a_view, b_small, want, got, panel, p
    torch.cuda.empty_cache()
    checked = kernels_transpose_add(torch, randn, rows)
    checked += kernels_stream(torch, randn, rows)
    checked += kernels_matmul(torch, randn, rows)
    torch.cuda.synchronize()
    emit({"phase": "kernels", "main_path_shapes": rows,
          "ragged_max_abs_err": {k: v[1] for k, v in ragged.items()},
          "also_checked": checked})
    return rows


def kernels_transpose_add(torch, randn, rows):
    """transpose_add at PTRANS's 16384^2 fp32, bit for bit; then ragged,
    strided and bf16 shapes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import transpose as ktr

    n = N_PTRANS
    a, b = randn(n, n), randn(n, n)
    got, want = ktr.transpose_add(a, b), ref.transpose_add(a, b)
    check(bitwise(torch, got, want),
          "transpose_add differs from its plain version at 16384^2 fp32")
    err = max_abs(got, want)
    del got, want
    bms, by = bound(3 * 4 * n * n, n * n)
    rows["transpose_add"] = dict(
        shape=f"A({n},{n}) B({n},{n}) fp32", max_abs_err=err,
        tol="bitwise", ms=cuda_ms(torch, lambda: ktr.transpose_add(a, b),
                                  iters=20),
        plain_ms=cuda_ms(torch, lambda: ref.transpose_add(a, b), iters=5),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.add(b, a.t()), iters=20),
        library="torch.add(b, a.t())")
    del a, b
    torch.cuda.empty_cache()
    checked = []
    # ragged (edge tiles both ways), strided (column strip of B, row view of
    # A), bf16 at a main-path-like and a ragged shape
    cases = {"ragged 1000x333": (randn(1000, 333), randn(333, 1000)),
             "strided": (randn(300, 700)[:, 50:650], randn(600, 900)[:, 7:307]),
             "bf16 4096^2": (randn(4096, 4096, dtype=torch.bfloat16),
                             randn(4096, 4096, dtype=torch.bfloat16)),
             "bf16 ragged 77x1030": (randn(77, 1030, dtype=torch.bfloat16),
                                     randn(1030, 77, dtype=torch.bfloat16))}
    for label, (x, y) in cases.items():
        check(bitwise(torch, ktr.transpose_add(x, y),
                      ref.transpose_add(x, y)),
              f"transpose_add differs from its plain version: {label}")
        checked.append(f"transpose_add {label}: bitwise")
    return checked


def kernels_stream(torch, randn, rows):
    """The four STREAM ops at 2^28 fp32 elements, bit for bit; then a size
    of 128 x odd on misaligned views (the scalar path) and bf16."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import stream as kst

    n, alpha = STREAM_ELEMS, 3.0
    a, b = randn(n), randn(n)
    calls = {  # kernel, plain version, library call, bytes, operations
        "stream_copy": (lambda: kst.stream_copy(a), lambda: ref.stream_copy(a),
                        lambda: a.clone(), 2, 0, "a.clone()"),
        "stream_scale": (lambda: kst.stream_scale(a, alpha),
                         lambda: ref.stream_scale(a, alpha),
                         lambda: torch.mul(a, alpha), 2, 1,
                         "torch.mul(a, alpha)"),
        "stream_add": (lambda: kst.stream_add(a, b),
                       lambda: ref.stream_add(a, b),
                       lambda: torch.add(a, b), 3, 1, "torch.add(a, b)"),
        "stream_triad": (lambda: kst.stream_triad(a, b, alpha),
                         lambda: ref.stream_triad(a, b, alpha),
                         lambda: torch.add(a, b, alpha=alpha), 3, 2,
                         "torch.add(b, c, alpha=alpha)")}
    for name, (kern, plain, lib, nbytes, nops, libname) in calls.items():
        got, want = kern(), plain()
        check(bitwise(torch, got, want),
              f"{name} differs from its plain version at 2^28 fp32")
        err = max_abs(got, want)
        del got, want
        bms, by = bound(nbytes * 4 * n, nops * n)
        rows[name] = dict(
            shape=f"{n} fp32", max_abs_err=err, tol="bitwise",
            ms=cuda_ms(torch, kern, iters=20),
            plain_ms=cuda_ms(torch, plain, iters=5), bound_ms=bms,
            bound_by=by, library_ms=cuda_ms(torch, lib, iters=20),
            library=libname)
        torch.cuda.empty_cache()
    del a, b
    torch.cuda.empty_cache()
    checked = []
    m = 128 * 4099
    big = randn(2 * m + 3)
    x, y = big[1:1 + m], big[m + 2:2 + 2 * m]  # not 16-byte aligned
    x16, y16 = randn(1 << 20, dtype=torch.bfloat16), \
        randn(1 << 20, dtype=torch.bfloat16)
    for label, (u, v) in {"misaligned 128x4099": (x, y),
                          "bf16 2^20": (x16, y16)}.items():
        for name, kern, plain in (
                ("stream_copy", lambda: kst.stream_copy(u),
                 lambda: ref.stream_copy(u)),
                ("stream_scale", lambda: kst.stream_scale(u, alpha),
                 lambda: ref.stream_scale(u, alpha)),
                ("stream_add", lambda: kst.stream_add(u, v),
                 lambda: ref.stream_add(u, v)),
                ("stream_triad", lambda: kst.stream_triad(u, v, alpha),
                 lambda: ref.stream_triad(u, v, alpha))):
            check(bitwise(torch, kern(), plain()),
                  f"{name} differs from its plain version: {label}")
        checked.append(f"stream ops {label}: bitwise")
    return checked


def kernels_matmul(torch, randn, rows):
    """matmul at the GEMM phase's 8192^3 fp32 against its plain loop (one
    call, about 3 s) and torch.matmul (TF32 off), within fp32 rounding;
    the limit must reject a TF32 product and a product that drops one K
    step. Then ragged, strided and bf16 shapes against the plain loop."""
    from repro_torch.kernels import gemm as kgemm
    from repro_torch.kernels import ref

    m = M_GEMM
    a, b = randn(m, m) / math.sqrt(m), randn(m, m) / math.sqrt(m)
    atol = sum_atol(m, rms(a), rms(b))
    got = kgemm.matmul(a, b)
    want, plain_ms = cuda_once(torch, lambda: ref.matmul(a, b))
    ok, err = allclose(torch, got, want, 0.0, atol)
    check(ok, f"matmul disagrees with its plain version at {m}^3: "
              f"{err} > {atol}")
    ok, err_lib = allclose(torch, got, torch.matmul(a, b), 0.0, atol)
    check(ok, f"matmul disagrees with torch.matmul at {m}^3: "
              f"{err_lib} > {atol}")
    torch.backends.cuda.matmul.allow_tf32 = True
    tf32 = torch.matmul(a, b)
    torch.backends.cuda.matmul.allow_tf32 = False
    ok_tf32, err_tf32 = allclose(torch, tf32, want, 0.0, atol)
    k = m // 2
    ok_drop, err_drop = allclose(torch, got - torch.outer(a[:, k], b[k]),
                                 want, 0.0, atol)
    check(not ok_tf32 and not ok_drop,
          f"matmul's limit {atol} passes a TF32 product ({err_tf32}) or a "
          f"dropped K step ({err_drop})")
    del got, want, tf32
    torch.cuda.empty_cache()
    bms, by = bound(3 * 4 * m * m, 2 * m ** 3)
    rows["matmul"] = dict(
        shape=f"A({m},{m}) B({m},{m}) fp32", max_abs_err=err,
        max_abs_err_vs_library=err_lib,
        tol={"atol": atol, "rtol": 0.0, "rule": "16 eps K rms(a) rms(b)"},
        limit_rejects={"tf32_max_abs_err": err_tf32,
                       "dropped_k_step_max_abs_err": err_drop},
        ms=cuda_ms(torch, lambda: kgemm.matmul(a, b), iters=5, warmup=1),
        plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.matmul(a, b), iters=5,
                           warmup=1),
        library="torch.matmul(a, b), allow_tf32=False")
    del a, b
    torch.cuda.empty_cache()
    checked = []
    cases = {"ragged 1000x777x555": (randn(1000, 777), randn(777, 555), None),
             "strided": (randn(300, 600)[:, 11:300], randn(400, 700)[:289, 5:600],
                         None),
             "bf16 1024^3": (randn(1024, 1024, dtype=torch.bfloat16),
                             randn(1024, 1024, dtype=torch.bfloat16), None),
             "bf16 in, fp32 out, ragged": (
                 randn(130, 257, dtype=torch.bfloat16),
                 randn(257, 99, dtype=torch.bfloat16), torch.float32),
             "fp32 in, bf16 out": (randn(200, 64), randn(64, 300),
                                   torch.bfloat16)}
    for label, (x, y, out_dtype) in cases.items():
        dt = out_dtype or x.dtype
        tol = sum_atol(x.shape[1], rms(x), rms(y))
        rtol = BF16_RTOL if dt == torch.bfloat16 else 0.0
        got = kgemm.matmul(x, y, out_dtype=out_dtype)
        check(got.dtype == dt, f"matmul {label}: dtype {got.dtype}")
        ok, err = allclose(torch, got, ref.matmul(x, y, out_dtype), rtol,
                           tol)
        check(ok, f"matmul disagrees with its plain version: {label}: {err}")
        checked.append(f"matmul {label}: max_abs_err {err:.3g} <= {tol:.3g}"
                       f" + {rtol:.3g}|want|")
    return checked


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
        want = nb if name in ops.HPL_KERNELS else 0
        check(per_fact[name] == want and counts[name] == want * (reps + 1),
              f"{name} launched {counts[name]} times in {reps + 1} "
              f"factorizations, expected {want} each")
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
        want = dict.fromkeys(ops.KERNELS, 0)
        want.update({"gemm_update": d * (d - 1) + nb * (2 * d + 1),
                     "lu_factor_block": nb + d, "trsm_lower_left": nb + d,
                     "trsm_upper_right": nb + d})
        check(counts == want, f"lookahead d={d} launches {counts}, "
                              f"expected {want}")
        out[f"d{d}"] = {"bitwise_equal": True, "launches": counts}
    emit({"phase": "lookahead", "n": n, "b": b, **out})


def phase_ptrans(torch):
    """PTRANS at n = 16384 on the 1x1 grid through ``run_ptrans``; then the
    4-strip pipeline against the monolithic step, bit for bit."""
    from repro_torch.comm.engine import CollectiveEngine
    from repro_torch.core.ptrans import make_inputs, make_step, run_ptrans
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import single_rank_mesh

    n, b, reps = N_PTRANS, B_PTRANS, 3
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_ptrans(n=n, b=b, reps=reps, nchunks=1, device="cuda")
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(res.error == 0.0, f"PTRANS error {res.error} != 0 against B + A^T")
    for name in ops.KERNELS:
        want = 1 if name == "transpose_add" else 0
        check(res.details["launches"][name] == want
              and counts[name] == want * (reps + 1),
              f"PTRANS launched {name} {counts[name]} times in {reps + 1} "
              f"steps, expected {want} each")
    t = res.times["best"]

    a, bm, a_loc, b_loc = make_inputs(n, b, 1, "cuda")
    mesh = single_rank_mesh()
    eng = CollectiveEngine.for_mesh(mesh)
    outs, per_step = {}, {}
    for k in (1, 4):
        before = ops.launch_counts()["transpose_add"]
        outs[k] = make_step(mesh, 1, eng, nchunks=k)(a_loc, b_loc)
        per_step[k] = ops.launch_counts()["transpose_add"] - before
    check(per_step == {1: 1, 4: 4},
          f"transpose_add launches per step {per_step}, expected 1 and 4")
    check(bitwise(torch, outs[4], outs[1]),
          "PTRANS nchunks=4 differs from nchunks=1")
    host = torch.from_numpy(bm + a.T)
    check(bitwise(torch, outs[1].cpu(), host),
          "PTRANS step differs from B + A^T on the host")
    del outs, a_loc, b_loc, host
    torch.cuda.empty_cache()
    emit({"phase": "ptrans", "n": n, "b": b, "error": res.error,
          "seconds": t, "gflops": res.metric,
          "gbytes_per_s": 3 * n * n * 4 / t / 1e9,
          "hbm_share": 3 * n * n * 4 / t / HBM_BYTES_PER_S,
          "steps": reps + 1, "launches": counts,
          "launches_per_step": {"nchunks=1": per_step[1],
                                "nchunks=4": per_step[4]},
          "nchunks4_bitwise_equal_nchunks1": True, "wall_s": wall,
          "schedule": res.details["schedule"],
          "device": res.details["device"]})
    return counts


def phase_beff(torch):
    """b_eff on the single-rank ring: no wire, so every exchange is the
    identity; the byte check must pass and the buffers stay on the card."""
    from repro_torch.core.beff import run_beff
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    res = run_beff(max_log=20, rounds=4, device="cuda")
    counts = ops.launch_counts()
    check(res.error == 0.0, f"b_eff byte check failed ({res.error} sizes)")
    check(res.details["ranks"] == 1, f"b_eff ranks {res.details['ranks']}")
    check(res.details["buffer_device"].startswith("cuda"),
          f"b_eff buffers on {res.details['buffer_device']}")
    check(all(v == 0 for v in counts.values()),
          f"b_eff launched kernels: {counts}")
    emit({"phase": "beff", "max_log": 20, "rounds": 4, "error": res.error,
          "ranks": res.details["ranks"], "b_eff_B_per_s": res.metric,
          "what_it_measures": "host loop overhead: one rank, no wire",
          "schedule": res.details["schedule"],
          "buffer_device": res.details["buffer_device"]})


def phase_stream(torch):
    from repro_torch.core.stream import run_stream
    from repro_torch.kernels import ops

    reps = 3
    ops.reset_launch_counts()
    res = run_stream(elems_per_device=STREAM_ELEMS, reps=reps,
                     device="cuda")
    counts = ops.launch_counts()
    check(res.error == 0.0, f"STREAM error {res.error} != 0")
    for name in ops.KERNELS:
        want = reps + 1 if name in ops.STREAM_KERNELS else 0
        check(counts[name] == want,
              f"STREAM launched {name} {counts[name]} times, expected {want}")
    bw = res.details["bandwidth"]
    torch.cuda.empty_cache()
    emit({"phase": "stream", "elems": STREAM_ELEMS, "error": res.error,
          "bandwidth_B_per_s": bw,
          "hbm_share": {k: v / HBM_BYTES_PER_S for k, v in bw.items()},
          "seconds": res.times, "launches": counts,
          "device": res.details["device"]})
    return counts


def phase_gemm(torch):
    from repro_torch.core.gemm import run_gemm
    from repro_torch.kernels import ops

    m, reps = M_GEMM, 3
    ops.reset_launch_counts()
    res = run_gemm(m=m, reps=reps, device="cuda")
    counts = ops.launch_counts()
    atol = sum_atol(m, m ** -0.5, m ** -0.5)  # inputs: N(0, 1) / sqrt(m)
    check(res.error <= atol, f"GEMM error {res.error} > {atol} against "
                             "torch.matmul (TF32 off)")
    for name in ops.KERNELS:
        want = reps + 1 if name == "matmul" else 0
        check(counts[name] == want,
              f"GEMM launched {name} {counts[name]} times, expected {want}")
    torch.cuda.empty_cache()
    emit({"phase": "gemm", "m": m, "gflops": res.metric,
          "seconds": res.times["best"], "error": res.error, "tol": atol,
          "fp32_peak_share": res.metric * 1e9 / FP32_FLOPS,
          "launches": counts, "device": res.details["device"]})
    return counts


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
    from repro_torch.kernels import ops

    rows = phase_kernels(torch)
    counts, per_fact, _ = phase_hpl(torch)
    phase_lookahead(torch)
    launches = {k: counts[k] for k in ops.HPL_KERNELS}
    launches["transpose_add"] = phase_ptrans(torch)["transpose_add"]
    phase_beff(torch)
    stream_counts = phase_stream(torch)
    launches.update({k: stream_counts[k] for k in ops.STREAM_KERNELS})
    launches["matmul"] = phase_gemm(torch)["matmul"]
    phase_cpu(torch)

    check(set(launches) == set(rows) == set(SOURCES),
          f"kernels {sorted(rows)} vs launches {sorted(launches)}")
    kernels = []
    for name, r in rows.items():
        entry = dict(name=name, route="cuda", source=SOURCES[name],
                     replaces=REPLACES[name], launches=launches[name])
        if name in ops.HPL_KERNELS:
            entry["launches_per_factorization"] = per_fact[name]
        entry.update(r)
        entry["kernel_ms"] = r["ms"]
        kernels.append(entry)
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
