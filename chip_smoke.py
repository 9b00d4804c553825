#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one card.

    python3 chip_smoke.py

Phases, one JSON line each:

1. build     — compile every CUDA source of the port with nvcc (sm_90a);
2. kernels   — hold each of the twelve kernels against its plain PyTorch
               version on the card, at its main path's shapes (HPL:
               m = 16384, b = 64; transpose_add 16384^2; STREAM 2^28
               elements; matmul 8192^3; flash_attention at the serving
               prefill, q 8x1024x24x128, k/v 8x1024x8x128, bf16, causal,
               on its tensor-core route, and the same shape in fp32 on its
               SIMT route; HPL's LU, Top- and Left-panel kernels also
               on their routes at the ragged 48 (strided), at 128 and on
               strided panels of prime width (Top) or height (Left) 1009,
               the Left panel at HPL's layout (a column strip, row stride
               16384), and their output bits against LU_BITS (the first
               port's kernels'); gemm_update timed against torch.addmm
               in STREAM_ROUNDS alternated rounds, also at HPL's trailing
               views (GEMM_TRAILING, row stride 16384) and the lookahead's
               64 x 16384 and 16384 x 64 strips (the row's ``shapes``),
               and its output bits against GEMM_BITS (the first port's
               kernel's) at those shapes, a ragged view and in bf16;
               the LU family timed queued behind a sleep kernel
               (device time; back-to-back events time the host's wrapper
               at a few microseconds a call); ring_add_step at the largest
               per-hop chunk of
               the allreduce phase, 6,291,456 fp32, and at 2^21 (a 32 MiB
               bucket's chunk), 2^28 fp32 and bf16, aliased, misaligned, and
               ragged in fp32 and fp16; its device time alone, queued
               behind a sleep kernel, at every hop chunk of the allreduce
               phase and at 2^21) and at ragged and strided shapes and in
               bf16, and time kernel, plain version and the nearest PyTorch
               library call (fp32 library calls run with TF32 off; the
               STREAM ops and their library calls in STREAM_ROUNDS
               alternated rounds, medians, with their share of the HBM
               rate).
               matmul's limit is fp32 rounding, which a TF32 product and a
               dropped K step both exceed, and its sums must equal
               gemm_update's order (C = 0 + 1 * A @ B) exactly;
               flash_attention's limit (tests/test_kernels.py: atol 8e-2
               bf16, 2e-4 fp32, rtol 2e-2) refuses the kernel with its
               causal mask off and with the wrong kv head, and in bf16 it is
               also held within one bf16 ulp of |want| plus 1e-3, which
               refuses a kernel that drops the last q tile's diagonal kv
               tile, or only the last query's own key (a fault small enough
               to pass the reference limit), or shifts the mask by one key
               in the late rows; the run shows that they do. Every bf16
               flash call must launch on the ``wgmma_bf16`` route, every
               fp32 one on ``simt_f32``; flash's TFLOP/s and its share of
               the bf16 tensor-core bound are printed;
3. hpl       — ``run_hpl`` on the 1x1 grid at n = 16384, b = 64: residual
               < 1 (and whether it equals HPL_RESIDUAL), GFLOP/s, and each
               HPL kernel launched nb = 256 times per factorization, the LU
               and both panels every time on HPL_ROUTES' routes;
4. lookahead — depths 1 and 2 at n = 4096 equal eager bit for bit, with the
               launch counts (and routes) the pipeline implies;
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
9. cpu       — the card's LU at n = 2048 against the port's plain CPU LU;
10. serve    — llama3.2-3b at full width and depth (28 layers, random
               weights from seed 0): ``generate`` on the one-rank mesh, 8
               requests x 1024 prompt tokens, 32 new tokens, greedy: 28
               flash launches in the prefill, all on ``wgmma_bf16``, and
               none in decode, output
               (8, 1056) keeping the prompts, two runs bit-identical; the
               prefill and decode steps timed apart (prompt tokens/s, decode
               ms per step p50, generated tokens/s, peak memory); and an
               fp32 prefill (B = 1, S = 1024) through flash (28 launches
               on ``simt_f32``) against the same prefill through the plain
               ``attention`` (``mesh=None``), within FP32_PREFILL_ATOL,
               which the bf16 prefill's logits exceed;
11. allreduce — four processes on the one card, a gloo ring that stages
               every payload through host memory, each holding the gradient
               of one llama3.2-3b decoder layer at full width (9 fp32
               leaves, 100.7 M elements, 403 MB) on the card: every
               allreduce schedule's ``allreduce_tree`` (the cost model's
               buckets, ``bucket_bytes_for``: 16 MiB on a ring of four from
               the H100 model's loopback constants, checked against
               ``derive_bucket_bytes``) bit for bit against the sum of the four
               ranks' integer-valued trees on every rank (int8_ef on
               block-representable ones), rs_ag also in one bucket, a
               quarter-tree bucket and one leaf per bucket; then normal
               leaves through rs_ag, bit for bit across the ranks and
               against a replay of the ring's order of additions with the
               plain ``ring_add_step``, launching the kernel 3 times per
               bucket with a nonempty chunk, as counted from
               ``pack_buckets``. Its times are the host's loopback,
               not a link rate.

12. gups    — RandomAccess at table_log = 28 (a 1 GiB int32 table, 20x
               the L2) with 2^18 generators x 4096 updates (2^30 updates,
               HPCC's 4 per table word) on one rank: ``run_randomaccess``
               and ``run_randomaccess_dist`` restore exactly (error 0), the
               two forward tables are bit-identical, and the card's streams
               of the first 64 generators equal the CPU's; GUPS, a step's
               seconds by phase (generate / bucket / exchange / scatter)
               and peak memory. No hand kernel runs: the scatter is
               ``index_add_``, as the reference leaves it to XLA;
13. fft      — ``run_fft`` and ``run_fft_dist`` on 2^15 signals of 4096
               complex64 (1 GiB) on one rank: error < 1e-5 against the
               complex128 transform, the pencil step bit-identical to the
               local one, GFLOP/s (5 n log2 n per signal) and cuFFT's
               device time against its byte bound;
14. a2a      — four processes sharing the card over gloo, as allreduce:
               routed GUPS (table_log = 22, 2^10 generators x 4096 a rank)
               and the pencil FFT (1024 signals of 4096 a rank) for every
               ``all_to_all_tiles`` schedule with nchunks 1 and 4: restore
               exact, received buckets and tables identical across
               schedules, FFT bit-identical to ``torch.fft.fft`` at the
               per-rank block shape (B/4, n), bytes staged per rank.
15. autotune — the cost model and autotuner (``comm/autotune.py``):
               ``run_hpl`` at n = 16384, b = 64 with ``lookahead="auto"``
               (the depth ``choose_hpl_depth`` gives on the H100 model),
               residual < 1, the launches its depth implies, and the LU
               bit for bit that of its integer depth and of eager; the
               one-card section of ``hpl_scaling`` (quick); the loopback's
               link constants on four gloo processes
               (``hw_model.link_constants``) beside the model's; and the
               quick measured ``autotune_mesh`` on a ring (and a 2x2 torus)
               of four processes with the ``--autotune`` gate, which fails
               unless every registered exact schedule was timed at both
               sizes; its table goes to a temporary directory, so the
               checkout's ``results/tuning_torch.json`` and the default
               model stay as they were. Prints the H100 model, the
               table's bands, the depth, the bucket and its seconds.
16. faults  — the fault layer (``comm/faults.py``, ``comm/retune.py``)
               on four processes sharing the card over gloo, payloads on
               the card, 1 MiB per rank: the link-down section of
               ``failover_bench`` (hop 3 of the ring hard-down; bcast and
               allreduce resolve ring2d -> staged -> ring2d on the H100
               model, routes that avoid the cut, outputs bit-identical
               across the phases and equal to x[0] and x.sum(0), every
               rank alike; the float allreduce launches ``ring_add_step``
               3 times per rank on ring2d and never on staged) and the
               train-retune section of ``resilience_bench`` (hpl.panel
               flips ring2d -> staged at step 8 and back at step 20, detect
               delays in [0, 6], identical traces on every rank, the bcast
               bit-identical), both gates asserted; then the measured
               retune's quick ladder (``bcast@hpl.panel`` at 1 MiB, clean
               and under an injector) from this process, which launches no
               kernel in the phase. Prints the resolutions, routes, reroute
               latency, retune events and the phase's seconds, all the
               host's loopback, not a link rate.

Each main-path phase zeroes the launch counts just before it runs and reads
them just after (the allreduce phase in each rank's process, around each
``allreduce_tree``). Then the card's ``nvidia-smi`` name and power limit, the
per-kernel summary line ``{"kernels": [...]}`` (each kernel's launches from
the phase that drives it), and last ``{"ok": true, "device": ...}``. Any
failed check raises and the script exits non-zero. Without a CUDA device,
or without the repository's ``src/repro_torch`` beside it, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import hashlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_MAIN, B_MAIN = 16384, 64
# the route each redesigned HPL kernel takes at b = 64, on every launch
HPL_ROUTES = {"lu_factor_block": "warp_regs", "trsm_lower_left": "regs64",
              "trsm_upper_right": "regs64"}
# HPL's residual at N_MAIN, B_MAIN with the first port's kernels, whose
# bits every route keeps (reported, not required: it also rests on the
# host's arithmetic)
HPL_RESIDUAL = 0.0013926777755841613
N_LOOKAHEAD = 4096
N_CPU = 2048
N_PTRANS, B_PTRANS = 16384, 128
STREAM_ELEMS = 1 << 28
STREAM_ROUNDS = 7  # alternated rounds of kernel and library call
M_GEMM = 8192
# the serving path: llama3.2-3b, 8 requests x 1024 prompt tokens, 32 new
SERVE_ARCH, SERVE_B, SERVE_S, SERVE_NEW = "llama3.2-3b", 8, 1024, 32
# the allreduce path: one layer of SERVE_ARCH's gradient on a ring of four
# processes sharing the card
ALLREDUCE_RANKS, ALLREDUCE_TIMEOUT = 4, 600.0
# RandomAccess and FFT on one rank at full size (the reference's
# rngs_per_device x updates_per_rng default scaled to 2^30 updates)
GUPS_TABLE_LOG, GUPS_RNGS, GUPS_UPDATES = 28, 1 << 18, 4096
FFT_LOG, FFT_BATCH = 12, 1 << 15
# the exchange path on four processes sharing the card, cut in depth
A2A_RANKS, A2A_TIMEOUT, A2A_CHUNKS = 4, 600.0, (1, 4)
A2A_TABLE_LOG, A2A_RNGS, A2A_FFT_BATCH = 22, 1 << 10, 1024
# the cost model's path: the link probe and the quick autotune on gloo
# worlds of four processes sharing the card, each world bounded
AUTOTUNE_TIMEOUT = 300.0
# the fault layer's path: one gloo world of four processes sharing the card
# for the link-down and train-retune sections (the measured retune's two
# torus worlds are bounded by resilience_bench.TIMEOUT)
FAULTS_TIMEOUT = 300.0
# fp32 prefill, flash vs plain attention: both are fp32 throughout and
# differ only in the order of the attention's sums (a few ulps per layer),
# on logits of rms about 1; one bf16 rounding anywhere moves them by ~1e-2
FP32_PREFILL_ATOL = 1e-3
FLASH_ATOL = {"float32": 2e-4, "bfloat16": 8e-2}  # tests/test_kernels.py
FLASH_RTOL = 2e-2
# kernel and plain version sum the same fp32 terms in other orders (relative
# error ~1e-6) and round once to bf16; one rounding may land a whole ulp
# apart, at most 2^-7 |want|, and 1e-3 covers the fp32 slack
FLASH_TIGHT = {"atol": 1e-3, "rtol": 2.0 ** -7}
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
# sha256 (first 16 hex digits) of the outputs of ``lu_golden_calls``, as
# the first port's kernels (one-CTA LU, left-looking lower solve, the same
# upper solve) computed them on the card; every route keeps each element's
# operations, so the bits must not move
LU_BITS = {"lu64": "ec7b50fd4f142e9c", "lu48": "cec5aa2781f3ae5e",
           "lu128": "c8dffd4abe86797a", "trsm64": "7a82ad5a1edce600",
           "trsm48_1009": "2a91fd5c3d00b0a9", "trsm128": "029d3092a28149f0",
           "upper64": "9e1412487aaeaafa", "lu64_odd": "9006050a846e6526"}
# sha256 (first 16 hex digits) of the outputs of ``gemm_golden_calls``, as
# the first port's gemm_update kernel computed them on the card; every
# design keeps each output's sums (ascending k, one fused multiply-add per
# product from +0, then fmaf(alpha, sum, c)), so the bits must not move
GEMM_BITS = {"hpl16384": "4baa42302537cd4f", "row_strip": "3a2fd3a9586b7761",
             "col_strip": "31b023ce8e054b65",
             "trailing8192": "ef17d0bba6e34e7a",
             "ragged37": "d4ef6ee3bdb9fd99", "bf16_16384": "56bcb59b282cd5f0"}
# trailing updates timed in phase ``kernels``: views of HPL's C, row stride
# N_MAIN, as an update restricted to the trailing matrix would pass them
GEMM_TRAILING = (12288, 8192, 4096, 1024)
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
           "matmul": CSRC + "matmul.cu",
           "flash_attention": CSRC + "flash_attention.cu",
           "ring_add_step": CSRC + "ring_add.cu"}
REPLACES = {"gemm_update": "src/repro/kernels/gemm.py:82",
            "lu_factor_block": "src/repro/kernels/lu.py:49",
            "trsm_lower_left": "src/repro/kernels/lu.py:86",
            "trsm_upper_right": "src/repro/kernels/lu.py:125",
            "transpose_add": "src/repro/kernels/transpose.py:25",
            "stream_copy": "src/repro/kernels/stream.py:43",
            "stream_scale": "src/repro/kernels/stream.py:43",
            "stream_add": "src/repro/kernels/stream.py:43",
            "stream_triad": "src/repro/kernels/stream.py:43",
            "matmul": "src/repro/kernels/gemm.py:45",
            "flash_attention": "src/repro/kernels/attention.py:69",
            "ring_add_step": "src/repro/kernels/ring.py:27"}


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


def alternated_ms(torch, fns, rounds: int, iters: int, timer=None) -> dict:
    """Median time of each of ``fns`` (``cuda_ms`` with one warm-up call,
    or ``timer``) over ``rounds`` rounds, the order rotated and reversed
    from round to round, so that clock and thermal drift fall on every
    function alike."""
    names, times = list(fns), {k: [] for k in fns}
    for r in range(rounds):
        order = names[r % len(names):] + names[:r % len(names)]
        for k in (order[::-1] if r % 2 else order):
            times[k].append(timer(torch, fns[k], iters) if timer else
                            cuda_ms(torch, fns[k], iters, warmup=1))
    return {k: statistics.median(v) for k, v in times.items()}


def queued_ms(torch, fn, iters: int) -> float:
    """Device time per call of ``fn`` run back to back, the host's excluded:
    the calls are queued behind a sleep kernel that outlasts their enqueue
    four times over, then run between two CUDA events. For calls of a few
    microseconds, where back-to-back events (``cuda_ms``) time the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4 * host_s * 2e9))  # cycles, at <= 2 GHz
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
    view = {2: torch.int16, 4: torch.int32,
            8: torch.int64}[got.element_size()]
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

    checked_gemm = kernels_gemm(torch, randn, rows)
    checked_lu = kernels_lu(torch, randn, dominant, rows)

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
    del big, c_view, a_view, b_small, want, got, p
    torch.cuda.empty_cache()
    checked = checked_gemm + checked_lu
    checked += kernels_transpose_add(torch, randn, rows)
    checked += kernels_stream(torch, randn, rows)
    checked += kernels_matmul(torch, randn, rows)
    checked += kernels_flash(torch, randn, rows)
    checked += kernels_ring(torch, randn, rows)
    torch.cuda.synchronize()
    emit({"phase": "kernels", "main_path_shapes": rows,
          "ragged_max_abs_err": {k: v[1] for k, v in ragged.items()},
          "also_checked": checked})
    return rows


def kernels_gemm(torch, randn, rows):
    """gemm_update at HPL's update, C (m, m) -= L (m, b) @ U (b, m), fp32,
    against its plain version, timed against ``torch.addmm`` (TF32 off) in
    STREAM_ROUNDS alternated rounds; the shape table: trailing views of
    that C (GEMM_TRAILING, row stride m) and the lookahead's two strips,
    each against its plain version and timed with ``torch.addmm``
    (``queued_ms``, alternated); the same update in bf16; and the output
    bits of ``gemm_golden_calls`` against :data:`GEMM_BITS` (the first
    port's kernel's)."""
    from repro_torch.kernels import gemm as kgemm
    from repro_torch.kernels import ref

    m, b = N_MAIN, B_MAIN
    c0, a, bb = randn(m, m), randn(m, b), randn(b, m)
    want = ref.gemm_update(c0, a, bb, alpha=-1.0)
    got = kgemm.gemm_update(c0.clone(), a, bb, alpha=-1.0)
    atol = GEMM_ATOL["float32"] * math.sqrt(b)
    ok, err = allclose(torch, got, want, 1e-2, atol)
    check(ok, f"gemm_update fp32 disagrees with its plain version: {err}")
    del want, got
    c_run = c0.clone()
    med = alternated_ms(torch, {
        "kernel": lambda: kgemm.gemm_update(c_run, a, bb),
        "library": lambda: torch.addmm(c0, a, bb, alpha=-1.0)},
        STREAM_ROUNDS, iters=10)
    plain_ms = cuda_ms(torch, lambda: ref.gemm_update(c0, a, bb), iters=2,
                       warmup=1)
    del c_run

    def update_bound(M, N, esize=4, peak=FP32_FLOPS):
        return bound(esize * (M * b + b * N + 2 * M * N), 2 * M * N * b,
                     peak)

    # the shape table: trailing views of C (row stride m) and the strips
    # HPL's lookahead updates, 64 x m and m x 64 (core/hpl.py)
    s, work = slice(b, 2 * b), c0.clone()
    shapes = {f"trailing {t}^2, row stride {m}": (
        c0[m - t:, m - t:], a[m - t:], bb[:, m - t:], work[m - t:, m - t:])
        for t in GEMM_TRAILING}
    shapes[f"row strip ({b},{m})"] = (c0[s, :].clone(), a[s, :], bb,
                                      c0[s, :].clone())
    shapes[f"column strip ({m},{b})"] = (c0[:, s].clone(), a, bb[:, s],
                                         c0[:, s].clone())
    table = {}
    for label, (c, x, y, c_run) in shapes.items():
        want = ref.gemm_update(c, x, y, alpha=-1.0)
        c_run.copy_(c)  # a larger view's runs updated it
        ok, err_s = allclose(torch, kgemm.gemm_update(c_run, x, y), want,
                             1e-2, atol)
        check(ok, f"gemm_update disagrees with its plain version: {label}: "
                  f"{err_s}")
        del want
        times = alternated_ms(torch, {
            "kernel": lambda: kgemm.gemm_update(c_run, x, y),
            "library": lambda: torch.addmm(c, x, y, alpha=-1.0)},
            3, iters=20, timer=queued_ms)
        bms_s, by_s = update_bound(*c.shape)
        table[label] = dict(ms=times["kernel"], bound_ms=bms_s, bound_by=by_s,
                            library_ms=times["library"], max_abs_err=err_s)
    del shapes, work
    bms, by = update_bound(m, m)
    rows["gemm_update"] = dict(
        shape=f"C({m},{m}) A({m},{b}) B({b},{m}) fp32", max_abs_err=err,
        tol={"atol": atol, "rtol": 1e-2}, ms=med["kernel"], plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=med["library"],
        library="torch.addmm(c, a, b, alpha=-1), allow_tf32=False",
        ms_over_library=med["kernel"] / med["library"],
        bound_share=bms / med["kernel"],
        timing=f"ms, library_ms: medians of {STREAM_ROUNDS} alternated "
               "rounds of cuda_ms over 10 calls; shapes: 3 alternated "
               "rounds of queued_ms over 20 calls",
        shapes=table)

    # the same update in bf16 (fp32 sums, rounded once)
    c16, a16, b16 = c0.bfloat16(), a.bfloat16(), bb.bfloat16()
    del c0
    want = ref.gemm_update(c16, a16, b16, alpha=-1.0)
    got = kgemm.gemm_update(c16.clone(), a16, b16, alpha=-1.0)
    atol16 = GEMM_ATOL["bfloat16"] * math.sqrt(b)
    ok, err16 = allclose(torch, got, want, 1e-2, atol16)
    check(ok, f"gemm_update bf16 disagrees with its plain version: {err16}")
    del want, got
    med16 = alternated_ms(torch, {
        "kernel": lambda: kgemm.gemm_update(c16, a16, b16),
        "library": lambda: torch.addmm(c16, a16, b16, alpha=-1.0)},
        STREAM_ROUNDS, iters=10)
    bms16, by16 = update_bound(m, m, 2, BF16_TENSOR_FLOPS)
    emit({"phase": "kernels.bf16", "kernel": "gemm_update",
          "shape": f"C({m},{m}) A({m},{b}) B({b},{m}) bf16",
          "max_abs_err": err16, "tol": {"atol": atol16, "rtol": 1e-2},
          "ms": med16["kernel"], "library_ms": med16["library"],
          "bound_ms": bms16, "bound_by": by16})
    del c16, a16, b16, a, bb
    torch.cuda.empty_cache()

    # every output bit as the first port's kernel gave it
    checked = []
    for label, fn in gemm_golden_calls(torch, kgemm).items():
        got = bits_sha(fn())
        check(got == GEMM_BITS[label], f"gemm_update {label}: output bits "
                                       f"{got}, not {GEMM_BITS[label]}")
        checked.append(f"gemm_update {label}: bits {got}, as recorded")
    torch.cuda.empty_cache()
    return checked


def lu_golden_calls(torch, klu):
    """The HPL kernels' calls whose output bits :data:`LU_BITS` records:
    inputs from numpy's generator (seed 16), the same on every machine, at
    HPL's shapes, a strided 48 x 48 block, a strided prime-width panel, the
    second routes' 128 and a 64 x 64 view off 16-byte alignment."""
    import numpy as np

    rng = np.random.default_rng(16)

    def cuda(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).cuda()

    def dominant(n):
        a = rng.standard_normal((n, n)).astype(np.float32)
        a[np.arange(n), np.arange(n)] += n
        return a

    blk64, blk48 = cuda(dominant(64)), cuda(dominant(96))[:48, :48]
    blk128 = cuda(dominant(128))
    pk64, pk48 = cuda(dominant(64) / 64), cuda(dominant(48) / 48)
    pk128 = cuda(dominant(128) / 128)  # packed L\U-like: unit-ish diagonal
    top = cuda(rng.standard_normal((64, N_MAIN)))
    top48 = cuda(rng.standard_normal((48, 1200)))[:, 100:1109]  # N = 1009
    top128 = cuda(rng.standard_normal((128, 1000)))
    left = cuda(rng.standard_normal((N_MAIN, 64)))
    odd = cuda(dominant(70))[3:67, 3:67]  # unaligned: the general load
    return {"lu64": lambda: klu.lu_factor_block(blk64),
            "lu64_odd": lambda: klu.lu_factor_block(odd),
            "lu48": lambda: klu.lu_factor_block(blk48),
            "lu128": lambda: klu.lu_factor_block(blk128),
            "trsm64": lambda: klu.trsm_lower_left(pk64, top),
            "trsm48_1009": lambda: klu.trsm_lower_left(pk48, top48),
            "trsm128": lambda: klu.trsm_lower_left(pk128, top128),
            "upper64": lambda: klu.trsm_upper_right(pk64, left)}


def gemm_golden_calls(torch, kgemm):
    """``gemm_update``'s calls whose output bits :data:`GEMM_BITS` records:
    inputs from numpy's generator (seed 19), the same on every machine.
    HPL's update (C 16384^2, K 64), the lookahead's row strip (64 x 16384)
    and column strip (16384 x 64, B a 64 x 64 view with row stride 16384),
    a trailing 8192^2 view with row stride 16384, the ragged strided view
    of ``phase_kernels`` with K = 37, and HPL's update in bf16. Each call
    updates a fresh copy of C and returns the updated view."""
    import numpy as np

    rng = np.random.default_rng(19)

    def cuda(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).cuda()

    m, b = N_MAIN, B_MAIN
    c, l, u = cuda(m, m), cuda(m, b), cuda(b, m)
    big, a_view, b_small = cuda(300, 512), cuda(300, 80)[:, 3:40], \
        cuda(37, 333)
    c16, l16, u16 = c.bfloat16(), l.bfloat16(), u.bfloat16()
    s, h = slice(b, 2 * b), m // 2
    return {
        "hpl16384": lambda: kgemm.gemm_update(c.clone(), l, u),
        "row_strip": lambda: kgemm.gemm_update(c[s, :].clone(), l[s, :], u),
        "col_strip": lambda: kgemm.gemm_update(c[:, s].clone(), l, u[:, s]),
        "trailing8192": lambda: kgemm.gemm_update(c.clone()[h:, h:], l[h:],
                                                  u[:, h:]),
        "ragged37": lambda: kgemm.gemm_update(big.clone()[:, 64:397], a_view,
                                              b_small, alpha=0.5),
        "bf16_16384": lambda: kgemm.gemm_update(c16.clone(), l16, u16)}


def bits_sha(t) -> str:
    import torch

    t = t.cpu().contiguous()
    if t.dtype == torch.bfloat16:  # no numpy type: hash its bits
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]


def kernels_lu(torch, randn, dominant, rows):
    """HPL's three panel kernels at HPL's shapes (b = 64, m = 16384; the
    Left panel a column strip of an m x m matrix, as HPL passes it): each
    on the route the shape must take, against its plain version, timed with
    the nearest library call; also at the ragged 48, at 128 (their second
    routes), on strided panels of prime width or height and on an
    unaligned 64 x 64 view; and all three kernels' output bits against
    :data:`LU_BITS`. Times: ``queued_ms``, since back-to-back launches of a
    kernel of a few microseconds time the host's wrapper (``cuda_ms``,
    reported beside)."""
    from repro_torch.kernels import lu as klu
    from repro_torch.kernels import ref

    m, b = N_MAIN, B_MAIN
    checked = []
    lu_w, lo_w = klu.lu_factor_block, klu.trsm_lower_left
    up_w = klu.trsm_upper_right

    def timed(fn, lib):
        return dict(ms=queued_ms(torch, fn, 200),
                    ms_events=cuda_ms(torch, fn, iters=200),
                    library_ms=queued_ms(torch, lib, 200),
                    library_ms_events=cuda_ms(torch, lib, iters=200),
                    timing="ms, library_ms: queued_ms (device, back to "
                           "back); *_events: cuda_ms (host-bound here)")

    # lu_factor_block: HPL's (b, b) diagonal block
    blk = dominant(b)
    want = ref.lu_factor_block(blk)
    got = on_route(lu_w, "warp_regs", lambda: klu.lu_factor_block(blk))
    ok, err = allclose(torch, got, want, *LU_TOL)
    check(ok, f"lu_factor_block disagrees with its plain version: {err}")
    flops = sum((b - k - 1) + 2 * (b - k - 1) ** 2 for k in range(b))
    bms, by = bound(4 * 2 * b * b, flops)
    rows["lu_factor_block"] = dict(
        shape=f"({b},{b}) fp32", kernel_route="warp_regs", max_abs_err=err,
        tol={"rtol": LU_TOL[0], "atol": LU_TOL[1]},
        plain_ms=cuda_ms(torch, lambda: ref.lu_factor_block(blk), iters=5),
        bound_ms=bms, bound_by=by,
        **timed(lambda: klu.lu_factor_block(blk),
                lambda: torch.linalg.lu_factor_ex(blk, pivot=False)),
        library="torch.linalg.lu_factor_ex(a, pivot=False)")

    # trsm_lower_left: the Top panel, X (b, m) = L^{-1} A_kj
    lu_blk = want
    panel = randn(b, m)
    want = ref.trsm_lower_left(lu_blk, panel)
    got = on_route(lo_w, "regs64", lambda: klu.trsm_lower_left(lu_blk, panel))
    ok, err = allclose(torch, got, want, *TRSM_TOL)
    check(ok, f"trsm_lower_left disagrees with its plain version: {err}")
    bms, by = bound(4 * (b * b + 2 * b * m), m * b * (b - 1))
    rows["trsm_lower_left"] = dict(
        shape=f"lu({b},{b}) B({b},{m}) fp32", kernel_route="regs64",
        max_abs_err=err, tol={"rtol": TRSM_TOL[0], "atol": TRSM_TOL[1]},
        plain_ms=cuda_ms(torch, lambda: ref.trsm_lower_left(lu_blk, panel),
                         iters=5),
        bound_ms=bms, bound_by=by,
        **timed(lambda: klu.trsm_lower_left(lu_blk, panel),
                lambda: torch.linalg.solve_triangular(
                    lu_blk, panel, upper=False, unitriangular=True)),
        library="torch.linalg.solve_triangular(lu, b, upper=False, "
                "unitriangular=True)")

    # trsm_upper_right: the Left panel, X (m, b) = A_ik U^{-1}, on HPL's
    # layout: a column strip of an (m, m) matrix, row stride m
    matrix = randn(m, m)
    left = matrix[:, b:2 * b]
    want = ref.trsm_upper_right(lu_blk, left)
    got = on_route(up_w, "regs64", lambda: klu.trsm_upper_right(lu_blk, left))
    ok, err = allclose(torch, got, want, *TRSM_TOL)
    check(ok, f"trsm_upper_right disagrees with its plain version: {err}")
    bms, by = bound(4 * (b * b + 2 * b * m), m * b * b)
    rows["trsm_upper_right"] = dict(
        shape=f"lu({b},{b}) B({m},{b}) row stride {m} fp32",
        kernel_route="regs64", max_abs_err=err,
        tol={"rtol": TRSM_TOL[0], "atol": TRSM_TOL[1]},
        plain_ms=cuda_ms(torch, lambda: ref.trsm_upper_right(lu_blk, left),
                         iters=5),
        bound_ms=bms, bound_by=by,
        **timed(lambda: klu.trsm_upper_right(lu_blk, left),
                lambda: torch.linalg.solve_triangular(
                    lu_blk, left, upper=True, left=False)),
        library="torch.linalg.solve_triangular(lu, b, upper=True, "
                "left=False)")
    del want, got, left, matrix

    # the ragged 48 (a strided view), the largest block 128, strided panels
    # of prime width (height): each on its route, against the plain version
    blk48, blk128 = dominant(96)[:48, :48], dominant(128)
    lu48, lu128 = ref.lu_factor_block(blk48), ref.lu_factor_block(blk128)
    cases = {
        "lu_factor_block n=48 (strided)": (
            lu_w, "warp_regs", lambda: klu.lu_factor_block(blk48), lu48,
            LU_TOL),
        "lu_factor_block n=128": (
            lu_w, "cta_smem", lambda: klu.lu_factor_block(blk128), lu128,
            LU_TOL)}
    for n, N, lu_n in ((48, 1000, lu48), (128, 1000, lu128),
                       (b, 1009, lu_blk), (48, 1009, lu48)):
        p = randn(n, N + 91)[:, 45:45 + N]
        route = klu.trsm_lower_route(n)
        cases[f"trsm_lower_left n={n} N={N} (strided)"] = (
            lo_w, route,
            lambda lu_n=lu_n, p=p: klu.trsm_lower_left(lu_n, p),
            ref.trsm_lower_left(lu_n, p), TRSM_TOL)
    for n, M, lu_n in ((48, 1009, lu48), (128, 1000, lu128),
                       (b, m, lu_blk)):
        p = randn(M, n + 91)[:, 45:45 + n]
        route = klu.trsm_upper_route(n)
        cases[f"trsm_upper_right n={n} M={M} (strided)"] = (
            up_w, route,
            lambda lu_n=lu_n, p=p: klu.trsm_upper_right(lu_n, p),
            ref.trsm_upper_right(lu_n, p), TRSM_TOL)
    for label, (wrapper, route, fn, want, tol) in cases.items():
        ok, err = allclose(torch, on_route(wrapper, route, fn), want, *tol)
        check(ok, f"{label} on {route} disagrees with its plain version: "
                  f"{err}")
        checked.append(f"{label}: {route}, max_abs_err {err:.3g}")

    # a 64 x 64 view off 16-byte alignment (row stride 70, offset 213
    # floats), diagonally dominant as HPL's blocks are: the warp route's
    # general load, not the float4 one
    blk_odd = dominant(70)[3:67, 3:67]
    ok, err = allclose(torch, klu.lu_factor_block(blk_odd),
                       ref.lu_factor_block(blk_odd), *LU_TOL)
    check(ok, f"lu_factor_block on an unaligned 64 x 64 view disagrees with "
              f"its plain version: {err}")
    del panel, blk_odd

    # every output bit as the first port's kernels gave it
    for label, fn in lu_golden_calls(torch, klu).items():
        got = bits_sha(fn())
        check(got == LU_BITS[label], f"{label}: output bits {got}, not "
                                     f"{LU_BITS[label]}")
        checked.append(f"{label}: bits {got}, as recorded")
    torch.cuda.empty_cache()
    return checked


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
    """The four STREAM ops at 2^28 fp32 elements, bit for bit, each timed
    against its library call in STREAM_ROUNDS alternated rounds; then a
    size of 128 x odd on misaligned views (the scalar path) and aligned
    (the vector path's partial last tile), and bf16."""
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
        med = alternated_ms(torch, {"kernel": kern, "library": lib},
                            STREAM_ROUNDS, iters=10)
        rows[name] = dict(
            shape=f"{n} fp32", max_abs_err=err, tol="bitwise",
            ms=med["kernel"], plain_ms=cuda_ms(torch, plain, iters=5),
            bound_ms=bms, bound_by=by, library_ms=med["library"],
            library=libname, ms_over_library=med["kernel"] / med["library"],
            hbm_share=bms / med["kernel"],
            library_hbm_share=bms / med["library"],
            timing=f"ms, library_ms: medians of {STREAM_ROUNDS} alternated "
                   "rounds of cuda_ms over 10 calls")
        torch.cuda.empty_cache()
    del a, b
    torch.cuda.empty_cache()
    checked = []
    m = 128 * 4099
    big = randn(2 * m + 3)
    x, y = big[1:1 + m], big[m + 2:2 + 2 * m]  # not 16-byte aligned
    x16, y16 = randn(1 << 20, dtype=torch.bfloat16), \
        randn(1 << 20, dtype=torch.bfloat16)
    # 128 x 4099 aligned: the vector path's last tile, partial and masked
    for label, (u, v) in {"misaligned 128x4099": (x, y),
                          "aligned 128x4099": (randn(m), randn(m)),
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
    # the order of sums is gemm_update's (ascending k, one FMA each from 0):
    # C = 0 + 1 * sum equals the sum, up to the sign of a zero
    order = kgemm.gemm_update(torch.zeros_like(got), a, b, alpha=1.0)
    check(torch.equal(got, order), "matmul's sums differ from gemm_update's "
                                   f"order: {max_abs(got, order)}")
    del got, want, tf32, order
    torch.cuda.empty_cache()
    bms, by = bound(3 * 4 * m * m, 2 * m ** 3)
    rows["matmul"] = dict(
        shape=f"A({m},{m}) B({m},{m}) fp32", max_abs_err=err,
        max_abs_err_vs_library=err_lib,
        tol={"atol": atol, "rtol": 0.0, "rule": "16 eps K rms(a) rms(b)"},
        equals_gemm_update_order=True,
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


def flash_flops(B, H, Sq, Skv, hd, causal, q_offset=0):
    """2 * hd multiply-adds for QK^T and as many for PV, per (query, key)
    pair the mask keeps: 4 * B * H * hd * pairs."""
    if causal:
        pairs = sum(min(Skv, q_offset + i + 1) for i in range(Sq))
    else:
        pairs = Sq * Skv
    return 4 * B * H * hd * pairs


def flash_faults(kfa, got, q, k, v):
    """Outputs of the kernel under three faults that move only late rows,
    made by launching it on slices of the inputs: the last q tile (64 rows)
    without its diagonal kv tile, as a kv loop that stops one tile short
    there would give; the same tile's kv loop one key short, so that only
    the last query loses a key, its own; and rows from S/2 on seeing one
    key past the diagonal, as a mask off by one there would give."""
    S = q.shape[1]
    tail = S - 64
    dropped = got.clone()
    dropped[:, tail:] = kfa.flash_attention(q[:, tail:], k[:, :tail],
                                            v[:, :tail], causal=True,
                                            q_offset=tail)
    short = got.clone()
    short[:, tail:] = kfa.flash_attention(q[:, tail:], k[:, :S - 1],
                                          v[:, :S - 1], causal=True,
                                          q_offset=tail)
    shifted = got.clone()
    shifted[:, S // 2:] = kfa.flash_attention(q[:, S // 2:], k, v,
                                              causal=True,
                                              q_offset=S // 2 + 1)
    return {"last_diagonal_tile_dropped": dropped,
            "last_key_dropped": short,
            "mask_off_by_one_late_rows": shifted}


def on_route(wrapper, route, fn):
    """``fn()``, which must launch ``wrapper``'s kernel once, on
    ``route``."""
    before = dict(wrapper.launches_by_route)
    out = fn()
    delta = {r: n - before[r] for r, n in wrapper.launches_by_route.items()}
    check(delta == {r: int(r == route) for r in delta},
          f"{wrapper.__name__} launched {delta}, expected one launch on "
          f"{route}")
    return out


def kernels_flash(torch, randn, rows):
    """flash_attention at the serving prefill's shape (bf16, causal)
    against its plain version, within tests/test_kernels.py's bf16 limit
    and within FLASH_TIGHT (one bf16 ulp of |want| plus fp32 slack). The
    reference limit must refuse the kernel with its causal mask off and
    with the wrong kv head; the tight one must also refuse the three
    faults of ``flash_faults``, which move only late rows. The same shape
    in fp32 on its own route, timed. Then fp32 and bf16 cases: MQA, head
    dims 64 and 32, non-causal GQA, q_offsets and ragged lengths (Sq = Skv
    = 1000 is no multiple of the bf16 kernel's 128-row tile). Every bf16
    call must run on the ``wgmma_bf16`` route and every fp32 call on
    ``simt_f32``."""
    import torch.nn.functional as F

    from repro_torch.kernels import attention as kfa
    from repro_torch.kernels import ref

    B, S, H, KV, hd = SERVE_B, SERVE_S, 24, 8, 128
    bf16 = torch.bfloat16
    q, k, v = randn(B, S, H, hd, dtype=bf16), randn(B, S, KV, hd, dtype=bf16), \
        randn(B, S, KV, hd, dtype=bf16)
    atol = FLASH_ATOL["bfloat16"]
    got = on_route(kfa.flash_attention, "wgmma_bf16",
                   lambda: kfa.flash_attention(q, k, v, causal=True))
    want = ref.flash_attention(q, k, v, causal=True)
    ok, err = allclose(torch, got, want, FLASH_RTOL, atol)
    check(ok, f"flash_attention disagrees with its plain version at the "
              f"serving shape: {err}")
    ok, _ = allclose(torch, got, want, FLASH_TIGHT["rtol"],
                     FLASH_TIGHT["atol"])
    check(ok, f"flash_attention differs from its plain version by more than "
              f"one bf16 rounding at the serving shape: {err}")
    # the reference limit must refuse a kernel without its mask or on the
    # wrong head
    ok_full, err_full = allclose(torch, kfa.flash_attention(q, k, v,
                                                            causal=False),
                                 want, FLASH_RTOL, atol)
    ok_head, err_head = allclose(torch, kfa.flash_attention(
        q, k.roll(1, dims=2), v.roll(1, dims=2), causal=True), want,
        FLASH_RTOL, atol)
    check(not ok_full and not ok_head,
          f"flash_attention's limit passes a kernel without the causal mask "
          f"({err_full}) or on the wrong kv head ({err_head})")
    rejects = {"causal_off_max_abs_err": err_full,
               "wrong_kv_head_max_abs_err": err_head}
    # the tight limit must also refuse faults that move only late rows
    for fault, bad in flash_faults(kfa, got, q, k, v).items():
        ok_tight, err_fault = allclose(torch, bad, want, FLASH_TIGHT["rtol"],
                                       FLASH_TIGHT["atol"])
        check(not ok_tight, f"flash_attention's tight limit passes the "
                            f"fault {fault} ({err_fault})")
        rejects[f"{fault}_max_abs_err"] = err_fault
        rejects[f"{fault}_within_reference_limit"] = allclose(
            torch, bad, want, FLASH_RTOL, atol)[0]
        del bad
    del got, want
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, out, k, v
    flops = flash_flops(B, H, S, S, hd, True)
    bms16, by16 = bound(nbytes, flops, BF16_TENSOR_FLOPS)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    ms = cuda_ms(torch, lambda: kfa.flash_attention(q, k, v), iters=20)
    rows["flash_attention"] = dict(
        shape=f"q({B},{S},{H},{hd}) k,v({B},{S},{KV},{hd}) bf16 causal",
        kernel_route="wgmma_bf16", max_abs_err=err,
        tol={"atol": atol, "rtol": FLASH_RTOL},
        tight_tol=FLASH_TIGHT, limit_rejects=rejects, ms=ms,
        plain_ms=cuda_ms(torch, lambda: ref.flash_attention(q, k, v),
                         iters=3, warmup=1),
        bound_ms=bms16, bound_by=by16, bound_peak="bf16 tensor cores",
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters=20),
        library="F.scaled_dot_product_attention(is_causal=True, "
                "enable_gqa=True), bf16")
    del qt, kt, vt
    # the fp32 route at the same shape
    q32, k32, v32 = q.float(), k.float(), v.float()
    del q, k, v
    got = on_route(kfa.flash_attention, "simt_f32",
                   lambda: kfa.flash_attention(q32, k32, v32))
    want = ref.flash_attention(q32, k32, v32)
    ok, err32 = allclose(torch, got, want, FLASH_RTOL, FLASH_ATOL["float32"])
    check(ok, f"flash_attention fp32 disagrees with its plain version at the "
              f"serving shape: {err32}")
    del got, want
    qt, kt, vt = q32.transpose(1, 2), k32.transpose(1, 2), v32.transpose(1, 2)
    bms32, by32 = bound(2 * nbytes, flops)
    simt = dict(
        shape=f"q({B},{S},{H},{hd}) k,v({B},{S},{KV},{hd}) fp32 causal",
        kernel_route="simt_f32", max_abs_err=err32,
        tol={"atol": FLASH_ATOL["float32"], "rtol": FLASH_RTOL},
        ms=cuda_ms(torch, lambda: kfa.flash_attention(q32, k32, v32),
                   iters=10),
        plain_ms=cuda_ms(torch, lambda: ref.flash_attention(q32, k32, v32),
                         iters=3, warmup=1),
        bound_ms=bms32, bound_by=by32, bound_peak="fp32 pipes",
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), iters=10),
        library="F.scaled_dot_product_attention(is_causal=True, "
                "enable_gqa=True), fp32")
    emit({"phase": "kernels.flash", "gflop": flops / 1e9,
          "mma_gflop_split_p": 1.5 * flops / 1e9,
          "bound_bf16_tensor_ms": bms16,
          "tflops": flops / ms / 1e9,
          "mma_tflops": 1.5 * flops / ms / 1e9,
          "bf16_tensor_bound_share": bms16 / ms})
    rows["flash_attention"]["simt_f32"] = simt
    del q32, k32, v32, qt, kt, vt
    torch.cuda.empty_cache()
    checked = []
    f32 = torch.float32
    cases = {  # B, Sq, Skv, H, KV, hd, dtype, causal, q_offset
        "fp32 GQA 3:1 hd128 causal": (2, 1024, 1024, 24, 8, 128, f32, True, 0),
        "MQA hd32 causal": (2, 96, 96, 8, 1, 32, f32, True, 0),
        "GQA 4:1 hd64 non-causal": (1, 256, 256, 8, 2, 64, f32, False, 0),
        "MHA hd32 bf16 causal": (2, 128, 128, 4, 4, 32, bf16, True, 0),
        "q_offset 896 hd128 bf16": (2, 128, 1024, 24, 8, 128, bf16, True, 896),
        "ragged 100x200 hd64 q_offset 100": (1, 100, 200, 6, 3, 64, f32, True,
                                             100),
        "ragged 100x200 hd64 q_offset 100 bf16": (1, 100, 200, 6, 3, 64, bf16,
                                                  True, 100),
        "1000x1000 hd128 bf16 causal": (2, 1000, 1000, 24, 8, 128, bf16, True,
                                        0),
        "GQA 4:1 hd64 bf16 non-causal": (1, 256, 256, 8, 2, 64, bf16, False,
                                         0)}
    # the plain version keeps the reference's rule that its blocks divide
    # the lengths: 1000 is no multiple of its default 512, so one block
    plain_blocks = {"1000x1000 hd128 bf16 causal": dict(bq=1000, bk=1000)}
    for label, (b, sq, skv, h, kv, d, dt, causal, qo) in cases.items():
        x = randn(b, sq, h, d, dtype=dt)
        y, z = randn(b, skv, kv, d, dtype=dt), randn(b, skv, kv, d, dtype=dt)
        tol = FLASH_ATOL["float32" if dt == f32 else "bfloat16"]
        route = "simt_f32" if dt == f32 else "wgmma_bf16"
        got = on_route(kfa.flash_attention, route,
                       lambda: kfa.flash_attention(x, y, z, causal=causal,
                                                   q_offset=qo))
        want = ref.flash_attention(x, y, z, causal=causal, q_offset=qo,
                                   **plain_blocks.get(label, {}))
        ok, err = allclose(torch, got, want, FLASH_RTOL, tol)
        check(ok, f"flash_attention disagrees with its plain version: "
                  f"{label}: {err}")
        if dt == bf16:
            ok, _ = allclose(torch, got, want, FLASH_TIGHT["rtol"],
                             FLASH_TIGHT["atol"])
            check(ok, f"flash_attention differs from its plain version by "
                      f"more than one bf16 rounding: {label}: {err}")
        checked.append(f"flash_attention {label}: {route}, max_abs_err "
                       f"{err:.3g} <= {tol:g} + {FLASH_RTOL:g}|want|")
    return checked


def model_bucket_bytes(n: int) -> int:
    """The bucket ``allreduce_tree`` takes by default on a ring of ``n``:
    the cost model's, derived from the H100 model's loopback constants."""
    from repro_torch.comm.autotune import derive_bucket_bytes
    from repro_torch.comm.topology import AxisTopology

    return derive_bucket_bytes((AxisTopology("x", n, "ring"),))


def layer_hop_chunks(n: int, bucket_bytes=None):
    """Elements per ring hop of each bucket of one SERVE_ARCH layer's
    gradient on a ring of ``n`` (the model's buckets unless given)."""
    from repro_torch.benchmarks.overlap_bench import hop_chunks, layer_shapes
    from repro_torch.configs import get_config

    return hop_chunks(layer_shapes(get_config(SERVE_ARCH)),
                      bucket_bytes or model_bucket_bytes(n), n)


def kernels_ring(torch, randn, rows):
    """ring_add_step at the allreduce phase's largest hop chunk, bit for bit
    with its plain version; then at 2^21 fp32 (a 32 MiB bucket's chunk,
    which the L2 holds), at 2^28 fp32 and bf16, into ``out = acc``, on a
    misaligned
    view (the scalar path) and, through ``fused_chunk_add``, ragged fp32
    and fp16 chunks, which launch the kernel once each. Then the kernel's
    and ``torch.add``'s device time alone at every hop chunk of the
    allreduce phase and at 2^21."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ring as kring

    chunks = layer_hop_chunks(ALLREDUCE_RANKS)
    hop = max(chunks)
    bf16 = torch.bfloat16
    cases = {"largest hop chunk": (hop, torch.float32, 200),
             "2^21 fp32 (L2)": (1 << 21, torch.float32, 500),
             "2^28 fp32 (HBM)": (1 << 28, torch.float32, 20),
             "2^28 bf16 (HBM)": (1 << 28, bf16, 20)}
    shapes = {}
    for label, (n, dt, iters) in cases.items():
        a, b = randn(n // 128, 128, dtype=dt), randn(n // 128, 128, dtype=dt)
        want = ref.ring_add_step(a, b)
        check(bitwise(torch, kring.ring_add_step(a, b), want),
              f"ring_add_step differs from its plain version: {label}")
        acc = a.clone()
        kring.ring_add_step(acc, b, out=acc)
        check(bitwise(torch, acc, want),
              f"ring_add_step into out=acc differs: {label}")
        size = a.element_size()
        bms, by = bound(3 * size * n, n)
        shapes[label] = dict(
            shape=f"({n // 128},128) {str(dt)[6:]}",
            max_abs_err=max_abs(acc, want), tol="bitwise",
            ms=cuda_ms(torch, lambda: kring.ring_add_step(a, b), iters=iters),
            ms_in_place=cuda_ms(torch, lambda: kring.ring_add_step(
                acc, b, out=acc), iters=iters),
            plain_ms=cuda_ms(torch, lambda: ref.ring_add_step(a, b),
                             iters=max(iters // 4, 5)),
            bound_ms=bms, bound_by=by,
            library_ms=cuda_ms(torch, lambda: torch.add(a, b), iters=iters),
            library="torch.add(acc, recv)")
        if 3 * size * n <= 50e6:
            shapes[label]["note"] = ("three arrays of %.1f MB fit the 50 MB "
                                     "L2: the HBM bound does not bind, and "
                                     "ms is no reading against it"
                                     % (size * n / 1e6))
        del a, b, want, acc
        torch.cuda.empty_cache()
    rows["ring_add_step"] = shapes["largest hop chunk"]
    checked = []
    m = 128 * 4099
    big = randn(2 * m + 3)
    x, y = big[1:1 + m].view(-1, 128), big[m + 2:2 + 2 * m].view(-1, 128)
    check(bitwise(torch, kring.ring_add_step(x, y), ref.ring_add_step(x, y)),
          "ring_add_step differs on misaligned operands")
    checked.append("ring_add_step misaligned 128x4099: bitwise")
    for dt in (torch.float32, torch.float16):
        r1, r2 = randn(128 * 1000 + 37, dtype=dt), randn(128 * 1000 + 37,
                                                       dtype=dt)
        before = kring.ring_add_step.launches
        out = kring.fused_chunk_add(r1, r2)
        check(kring.ring_add_step.launches == before + 1,
              f"fused_chunk_add did not launch the kernel once for a ragged "
              f"{dt} chunk")
        check(bitwise(torch, out, ref.ring_add_step(r1, r2)),
              f"fused_chunk_add differs from its plain version on a ragged "
              f"{dt} chunk")
        checked.append(f"fused_chunk_add ragged 128000+37 {str(dt)[6:]}: "
                       "1 launch, bitwise")
    # device time alone: at the L2-resident sizes the CUDA events of
    # back-to-back calls also hold the wrapper's host time
    device = {}
    for n in sorted(set(chunks) | {1 << 21}):
        a, b = randn(n // 128, 128), randn(n // 128, 128)
        device[n] = dict(
            ring_add_step_ms=queued_ms(
                torch, lambda: kring.ring_add_step(a, b, out=a), 200),
            torch_add_ms=queued_ms(
                torch, lambda: torch.add(a, b, out=a), 200),
            events_ms=cuda_ms(
                torch, lambda: kring.ring_add_step(a, b, out=a), 200),
            bound_ms=bound(12 * n, n)[0])
    emit({"phase": "kernels.ring", "shapes": shapes, "hop_chunks": chunks,
          "device_ms_in_place_fp32": device})
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
    routes = ops.launches_by_route()
    per_fact = res.details["launches"]
    check(res.error < 1.0, f"HPL residual {res.error} >= 1")
    for name in ops.KERNELS:
        want = nb if name in ops.HPL_KERNELS else 0
        check(per_fact[name] == want and counts[name] == want * (reps + 1),
              f"{name} launched {counts[name]} times in {reps + 1} "
              f"factorizations, expected {want} each")
    for name, route in HPL_ROUTES.items():
        want = {r: nb * (reps + 1) * (r == route) for r in routes[name]}
        check(routes[name] == want,
              f"{name} launched {routes[name]} by route, expected {want}")
    emit({"phase": "hpl", "n": N_MAIN, "b": B_MAIN, "gflops": res.metric,
          "seconds": res.times["best"], "residual": res.error,
          "residual_as_recorded": res.error == HPL_RESIDUAL,
          "factorizations": reps + 1, "launches": counts,
          "launches_by_route": {k: routes[k] for k in HPL_ROUTES},
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
        want.update(lookahead_launches(nb, d))
        check(counts == want, f"lookahead d={d} launches {counts}, "
                              f"expected {want}")
        routes = ops.launches_by_route()
        for name, route in HPL_ROUTES.items():
            check(routes[name][route] == nb + d,
                  f"lookahead d={d}: {name} launched {routes[name]} by "
                  f"route, expected {nb + d} on {route}")
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


def phase_serve(torch):
    """llama3.2-3b at full width and depth on the card through the port's
    ``generate`` with the one-rank mesh (the flash path); then the prefill
    and decode steps timed apart, and the fp32 prefill through flash
    against the plain attention."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import single_rank_mesh
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import cast_params
    from repro_torch.train.serve import (generate, make_decode_step,
                                         make_prefill_step)

    cfg = get_config(SERVE_ARCH)
    B, S, new = SERVE_B, SERVE_S, SERVE_NEW
    dev = torch.device("cuda")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(0, device=dev)  # fp32, from a seeded generator
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=dev, dtype=torch.int32)
    mesh = single_rank_mesh(("x",))

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = generate(model, params, prompts, max_new_tokens=new, mesh=mesh)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    routes = dict(kfa.flash_attention.launches_by_route)
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(ops.KERNELS, 0)
    want["flash_attention"] = cfg.num_layers
    check(counts == want, f"generate launched {counts}, expected one flash "
                          f"launch per layer ({cfg.num_layers}) and nothing "
                          "else")
    check(routes == {"wgmma_bf16": cfg.num_layers, "simt_f32": 0},
          f"generate's flash launches by route {routes}, expected all "
          f"{cfg.num_layers} on wgmma_bf16")
    check(tuple(out.shape) == (B, S + new), f"output shape {tuple(out.shape)}")
    check(torch.equal(out[:, :S], prompts), "generate changed the prompts")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "generated tokens outside the vocabulary")
    t0 = time.perf_counter()
    again = generate(model, params, prompts, max_new_tokens=new, mesh=mesh)
    torch.cuda.synchronize()
    generate2_s = time.perf_counter() - t0
    check(torch.equal(again, out), "two greedy runs differ")
    del again

    # the same work, step by step: prefill and each decode step timed
    sp = cast_params(params, torch.bfloat16)
    cache = model.init_cache(B, S + new, torch.bfloat16, device=dev)
    prefill, decode = make_prefill_step(model, mesh), make_decode_step(model,
                                                                       mesh)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(sp, {"tokens": prompts}, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_flash = ops.launch_counts()["flash_attention"]
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    check(tuple(logits.shape) == (B, S, cfg.padded_vocab()),
          f"prefill logits {tuple(logits.shape)}")
    tok = torch.argmax(logits[:, -1], dim=-1).to(prompts.dtype)[:, None]
    del logits
    toks, steps = [tok], []
    for _ in range(new - 1):
        t0 = time.perf_counter()
        logits, cache = decode(sp, tok, cache, {})
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(logits).all()), "decode logits not finite")
        tok = torch.argmax(logits[:, -1], dim=-1).to(prompts.dtype)[:, None]
        toks.append(tok)
    decode_flash = ops.launch_counts()["flash_attention"] - prefill_flash
    check(prefill_flash == cfg.num_layers and decode_flash == 0,
          f"flash launches: prefill {prefill_flash}, decode {decode_flash}")
    check(torch.equal(torch.cat(toks, 1), out[:, S:]),
          "the timed steps differ from generate")
    del cache, sp, logits
    torch.cuda.empty_cache()
    steps.sort()
    p50 = steps[len(steps) // 2]

    # fp32 prefill: flash (one-rank mesh) against plain attention (no mesh)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = build_model(cfg32)
    p1 = prompts[:1]
    lg, prefill_routes = {}, {}
    for label, m, mdl, dt in (("flash", mesh, model32, torch.float32),
                              ("plain", None, model32, torch.float32),
                              ("flash_bf16", mesh, model, torch.bfloat16)):
        c = mdl.init_cache(1, S, dt, device=dev)
        ops.reset_launch_counts()
        lg[label] = make_prefill_step(mdl, m)(cast_params(params, dt),
                                              {"tokens": p1}, c)[0].float()
        prefill_routes[label] = dict(kfa.flash_attention.launches_by_route)
        del c
    n = cfg.num_layers
    check(prefill_routes == {
        "flash": {"wgmma_bf16": 0, "simt_f32": n},
        "plain": {"wgmma_bf16": 0, "simt_f32": 0},
        "flash_bf16": {"wgmma_bf16": n, "simt_f32": 0}},
        f"prefill flash launches by route {prefill_routes}")
    err32 = max_abs(lg["flash"], lg["plain"])
    err_bf16 = max_abs(lg["flash_bf16"], lg["plain"])
    check(bool(torch.isfinite(lg["flash"]).all()), "fp32 logits not finite")
    check(err32 <= FP32_PREFILL_ATOL,
          f"fp32 prefill through flash differs from plain attention by "
          f"{err32} > {FP32_PREFILL_ATOL}")
    check(err_bf16 > FP32_PREFILL_ATOL,
          f"the fp32 limit {FP32_PREFILL_ATOL} passes the bf16 prefill "
          f"({err_bf16})")
    logit_rms = rms(lg["plain"])
    del lg
    torch.cuda.empty_cache()
    emit({"phase": "serve", "arch": SERVE_ARCH, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "params": cfg.param_count(),
          "batch": B, "prompt_tokens": S, "new_tokens": new,
          "dtype": cfg.dtype, "init_s": init_s,
          "generate_s": generate_s, "generate_s_second_run": generate2_s,
          "generated_tokens_per_s": B * new / generate2_s,
          "prefill_s": prefill_s, "prompt_tokens_per_s": B * S / prefill_s,
          "decode_ms_p50": p50 * 1e3, "decode_ms_min": steps[0] * 1e3,
          "decode_ms_max": steps[-1] * 1e3,
          "decode_tokens_per_s": B / p50,
          "peak_memory_gb": peak / 1e9, "launches": counts,
          "flash_launches": {"prefill": prefill_flash, "decode": decode_flash},
          "flash_launches_by_route": routes,
          "bitwise_repeat": True,
          "fp32_prefill": {"batch": 1, "flash_routes": prefill_routes,
                           "max_abs_flash_vs_plain": err32,
                           "atol": FP32_PREFILL_ATOL,
                           "bf16_vs_fp32_max_abs": err_bf16,
                           "logit_rms": logit_rms}})
    return counts


def phase_allreduce(torch):
    """Four processes on the card reduce one llama3.2-3b layer's gradient
    through ``allreduce_tree``: every schedule exact on integer leaves, rs_ag
    in every bucket mode, and normal leaves through rs_ag bit for bit across
    the ranks and against the plain replay, with the kernel launched as
    often as ``pack_buckets`` says."""
    from repro_torch.benchmarks import overlap_bench as ob
    from repro_torch.comm.engine import schedules_for
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops

    n = ALLREDUCE_RANKS
    cfg = get_config(SERVE_ARCH)
    shapes = ob.layer_shapes(cfg)
    schedules = schedules_for("allreduce")
    runs = [(s, "model", "int8_exact" if s == "int8_ef" else "ints")
            for s in schedules]
    runs += [("rs_ag", m, "ints") for m in ("monolithic", "bucketed",
                                            "leafwise")]
    runs.append(("rs_ag", "model", "normal"))
    # the children only load the libraries, and find the card's memory free
    _build.build()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = ob.run(n, shapes, runs, seed=0, device="cuda",
                     timeout=ALLREDUCE_TIMEOUT)
    wall = time.perf_counter() - t0
    check(all(v == 0 for v in ops.launch_counts().values()),
          "the parent launched kernels during the allreduce phase")
    expected = {}
    table = {}
    for i, (schedule, mode, kind) in enumerate(runs):
        recs = [r[i] for r in results]
        if mode == "model":
            check(all(rec["bucket_bytes"] == model_bucket_bytes(n)
                      for rec in recs),
                  f"{schedule}/model: buckets of "
                  f"{[rec['bucket_bytes'] for rec in recs]} bytes, the cost "
                  f"model derives {model_bucket_bytes(n)}")
        chunks = layer_hop_chunks(n, recs[0]["bucket_bytes"])
        launching = sum(1 for c in chunks if c)
        want = (n - 1) * launching if schedule in (
            "rs_ag", "ring2d", "int8_ef") else 0
        expected[f"{schedule}/{mode}/{kind}"] = want
        for rank, rec in enumerate(recs):
            what = f"{schedule}/{mode}/{kind} rank {rank}"
            check(rec["device"].startswith("cuda"), f"{what} on {rec['device']}")
            check(rec.get("exact", True), f"{what}: not the exact sum")
            check(rec["launches"] == ({"ring_add_step": want} if want else {}),
                  f"{what} launched {rec['launches']}, expected "
                  f"ring_add_step {want}")
            check(rec["staged_bytes"] > 0, f"{what} staged nothing")
            check(rec["buckets"] == len(chunks), f"{what}: {rec['buckets']} "
                  f"buckets, pack_buckets gives {len(chunks)}")
        if kind == "normal":
            check(all(rec["replay_equal"] for rec in recs),
                  f"{schedule}/{mode}: differs from the plain replay of the "
                  "ring's order")
            check(len({rec["digest"] for rec in recs}) == 1,
                  f"{schedule}/{mode}: ranks disagree")
        table[f"{schedule}/{mode}/{kind}"] = dict(
            seconds=max(rec["seconds"] for rec in recs),
            bucket_bytes=recs[0]["bucket_bytes"], buckets=recs[0]["buckets"],
            staged_bytes_per_rank=recs[0]["staged_bytes"],
            ring_add_step_per_rank=recs[0]["launches"].get("ring_add_step", 0))
    main = [r[-1] for r in results]
    launches = main[0]["launches"].get("ring_add_step", 0)
    emit({"phase": "allreduce", "arch": SERVE_ARCH, "ranks": n,
          "transport": "gloo, staged through host memory; kernels on the card",
          "layer_shapes": shapes, "bytes_per_rank": main[0]["bytes"],
          "cut": f"depth only: one of {cfg.num_layers} layers (every layer's "
                 "leaves pack into the same buckets; the whole gradient is "
                 f"{cfg.param_count() * 4 / 1e9:.1f} GB per rank)",
          "bucket_bytes_model": model_bucket_bytes(n),
          "hop_chunks_model": layer_hop_chunks(n),
          "runs": table, "ring_add_step_expected": expected,
          "main_path": "rs_ag/model/normal: bitwise across ranks and with "
                       "the plain replay",
          "wall_s": wall,
          "what_the_time_measures": "the host's loopback (gloo on one "
                                    "machine), not a link rate"})
    return launches, sum(rec["launches"].get("ring_add_step", 0)
                         for rec in main)


def phase_gups(torch):
    """RandomAccess at full size on one rank through both entry points;
    their forward tables bit for bit; the card's streams against the
    CPU's."""
    from repro_torch.comm.engine import CollectiveEngine
    from repro_torch.core import randomaccess as ra
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import single_rank_mesh

    kw = dict(table_log=GUPS_TABLE_LOG, rngs_per_device=GUPS_RNGS,
              updates_per_rng=GUPS_UPDATES)
    results, peaks = {}, {}
    ops.reset_launch_counts()
    for name, run in (("drop_local", ra.run_randomaccess),
                      ("routed", ra.run_randomaccess_dist)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res = run(**kw, reps=2, device="cuda")
        peaks[name] = torch.cuda.max_memory_allocated()
        check(res.error == 0.0, f"GUPS {name}: restore error {res.error}")
        check(res.details["updates"] == GUPS_RNGS * GUPS_UPDATES,
              f"GUPS {name}: {res.details['updates']} updates")
        results[name] = res
    check(all(v == 0 for v in ops.launch_counts().values()),
          f"GUPS launched hand kernels: {ops.launch_counts()}")

    mesh = single_rank_mesh(("x",))
    table, seeds = ra.from_reference(
        *ra.reference_state(1, table_log=GUPS_TABLE_LOG,
                            rngs_per_device=GUPS_RNGS), mesh, "cuda")
    step_kw = dict(updates_per_rng=GUPS_UPDATES, table_log=GUPS_TABLE_LOG)
    fwd_local = ra.make_step(mesh, **step_kw)(table, seeds)
    fwd_routed = ra.make_routed_step(mesh, CollectiveEngine.for_mesh(mesh),
                                     **step_kw)(table, seeds)
    check(bitwise(torch, fwd_local, fwd_routed),
          "GUPS drop-local and routed forward tables differ on one rank")
    changed = int((fwd_local != table).sum())
    check(changed > 0, "GUPS forward step left the table unchanged")
    sha = bits_sha(fwd_local)
    card = ra.gen_updates(seeds[:64], GUPS_UPDATES).cpu()
    host = ra.gen_updates(seeds[:64].cpu(), GUPS_UPDATES)
    check(torch.equal(card, host), "GUPS streams differ between card and CPU")
    del table, seeds, fwd_local, fwd_routed
    torch.cuda.empty_cache()
    emit({"phase": "gups", "table_log": GUPS_TABLE_LOG,
          "table_bytes": 4 << GUPS_TABLE_LOG,
          "rngs_per_device": GUPS_RNGS, "updates_per_rng": GUPS_UPDATES,
          "updates": results["routed"].details["updates"],
          "gups": {k: r.metric for k, r in results.items()},
          "seconds_best": {k: r.times["best"] for k, r in results.items()},
          "seconds_by_phase": {k: r.details["phase_seconds"]
                               for k, r in results.items()},
          "peak_memory_bytes": peaks, "error": 0.0,
          "forward_tables_bitwise_equal": True, "forward_sha": sha,
          "words_changed": changed, "streams_card_equal_cpu": 64,
          "schedule": results["routed"].details["schedule"],
          "reduced": "HPCC's table of half the memory cannot be had: like "
                     "the reference, a step materializes every update and "
                     "its bucket buffer, and the routed step's peak is "
                     f"{peaks['routed'] / (1 << GUPS_TABLE_LOG):.0f} bytes "
                     "per table word; table_log 28 is a 1 GiB table",
          "device": results["routed"].details["device"]})


def phase_fft(torch):
    """Both FFT entry points at full size on one rank; the pencil step
    against the local one, bit for bit; cuFFT's device time."""
    from repro_torch.comm.engine import CollectiveEngine
    from repro_torch.core import fft
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import single_rank_mesh

    kw = dict(log_size=FFT_LOG, batch_per_device=FFT_BATCH, reps=3,
              device="cuda")
    ops.reset_launch_counts()
    res = {"local": fft.run_fft(**kw),
           "pencil": fft.run_fft_dist(**kw, nchunks=1)}
    check(all(v == 0 for v in ops.launch_counts().values()),
          f"FFT launched hand kernels: {ops.launch_counts()}")
    for name, r in res.items():
        check(r.error < 1e-5, f"FFT {name}: error {r.error} >= 1e-5")
    n = 1 << FFT_LOG
    x = fft.make_signals(FFT_BATCH, n, device="cuda")
    eng = CollectiveEngine.for_mesh(single_rank_mesh(("x",)))
    local = fft.fft_local(x)
    check(bitwise(torch, fft.make_dist_step(eng)(x), local),
          "FFT pencil step differs from the local transform on one rank")
    check(bitwise(torch, fft.make_dist_step(eng, nchunks=4)(x), local),
          "FFT pencil step (nchunks=4) differs from the local transform")
    ms = cuda_ms(torch, lambda: fft.fft_local(x), iters=10)
    nbytes = 2 * x.numel() * x.element_size()
    flops = 5.0 * n * math.log2(n) * FFT_BATCH
    bound_ms, bound_by = bound(nbytes, flops)
    del x, local
    torch.cuda.empty_cache()
    emit({"phase": "fft", "log_size": FFT_LOG, "batch": FFT_BATCH,
          "bytes": nbytes // 2,
          "gflops": {k: r.metric for k, r in res.items()},
          "seconds_best": {k: r.times["best"] for k, r in res.items()},
          "error": {k: r.error for k, r in res.items()},
          "pencil_bitwise_equal_local": True, "cufft_ms": ms,
          "cufft_gflops": flops / ms / 1e6, "bound_ms": bound_ms,
          "bound_by": bound_by,
          "schedule": res["pencil"].details["schedule"],
          "device": res["local"].details["device"]})


def a2a_rank(mesh):
    """Runs on every rank of the a2a phase: routed GUPS and the pencil FFT
    through each ``all_to_all_tiles`` schedule and chunking on the card.
    Returns per (op, schedule, nchunks) the entry point's result, the
    bytes staged through the host by one GUPS exchange and one FFT step,
    and digests of what they moved."""
    import torch

    from repro_torch.comm.engine import (CollectiveEngine,
                                         reset_staged_bytes, schedules_for,
                                         staged_bytes)
    from repro_torch.core import fft
    from repro_torch.core import randomaccess as ra

    torch.cuda.set_device(0)
    ax = mesh.axis("x")
    table, seeds = ra.from_reference(
        *ra.reference_state(ax.size, table_log=A2A_TABLE_LOG,
                            rngs_per_device=A2A_RNGS), mesh, "cuda")
    ra_kw = dict(table_log=A2A_TABLE_LOG, updates_per_rng=GUPS_UPDATES)
    n = 1 << FFT_LOG
    ns = n // ax.size
    cols = slice(ax.index * ns, (ax.index + 1) * ns)
    x = fft.make_signals(A2A_FFT_BATCH * ax.size, n, device="cuda")
    x_loc = x[:, cols].contiguous()
    want = torch.cat([fft.fft_local(b.clone())
                      for b in x.chunk(ax.size)])[:, cols]
    buf = ra.bucket_updates(ra.gen_updates(seeds, GUPS_UPDATES).reshape(-1),
                            table_log=A2A_TABLE_LOG,
                            local_size=table.shape[0], n_dev=ax.size,
                            sign=1)
    out = {"buf": bits_sha(buf)}
    for s in schedules_for("all_to_all_tiles"):
        eng = CollectiveEngine.for_mesh(mesh, schedule=s)
        for k in A2A_CHUNKS:
            res = ra.run_randomaccess_dist(
                mesh, **ra_kw, rngs_per_device=A2A_RNGS, reps=1, schedule=s,
                nchunks=k, device="cuda")
            # the digests come from one exchange of the buckets built above
            # and the routed step's scatter, not from another whole step
            reset_staged_bytes()
            recv = ra.exchange_updates(eng, buf, k)
            fwd = ra.scatter_add(table, recv[..., 0].reshape(-1),
                                 recv[..., 1].reshape(-1))
            out["gups", s, k] = dict(
                error=res.error, gups=res.metric, seconds=res.times["best"],
                seconds_by_phase=res.details["phase_seconds"],
                schedule=res.details["schedule"],
                staged_bytes=staged_bytes(), recv=bits_sha(recv),
                table=bits_sha(fwd), changed=int((fwd != table).sum()))
            res = fft.run_fft_dist(mesh, log_size=FFT_LOG,
                                   batch_per_device=A2A_FFT_BATCH, reps=1,
                                   schedule=s, nchunks=k, device="cuda")
            reset_staged_bytes()
            got = fft.make_dist_step(eng, nchunks=k)(x_loc)
            out["fft", s, k] = dict(
                error=res.error, gflops=res.metric,
                seconds=res.times["best"], schedule=res.details["schedule"],
                staged_bytes=staged_bytes(),
                bitwise_block=bitwise(torch, got, want), out=bits_sha(got))
    return out


def phase_a2a(torch):
    """Routed GUPS and the pencil FFT on four processes sharing the card:
    every schedule and chunking exact, and each rank's results identical
    across them."""
    from repro_torch.comm.engine import schedules_for
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import spawn_mesh

    n = A2A_RANKS
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = spawn_mesh(n, a2a_rank, axes=("x",), timeout=A2A_TIMEOUT)
    wall = time.perf_counter() - t0
    combos = [(s, k) for s in schedules_for("all_to_all_tiles")
              for k in A2A_CHUNKS]
    # bytes each schedule stages through the host for a payload of P per
    # rank: native copies P out and P back; chain's rounds carry
    # n(n-1)/2 tiles of P/n out and back; staged copies P out and the n
    # gathered payloads back. GUPS stages one exchange, the FFT two.
    times_payload = {"native": 2, "chain": n - 1, "staged": n + 1}
    payload = {"gups": n * A2A_RNGS * GUPS_UPDATES * 2 * 4,
               "fft": 2 * A2A_FFT_BATCH * (1 << FFT_LOG) * 8}
    table = {}
    for op in ("gups", "fft"):
        for s, k in combos:
            recs = [r[op, s, k] for r in results]
            what = f"a2a {op} {s} nchunks={k}"
            check(all(r["schedule"] == s for r in recs),
                  f"{what}: resolved {[r['schedule'] for r in recs]}")
            want = times_payload[s] * payload[op]
            check(all(r["staged_bytes"] == want for r in recs),
                  f"{what}: staged {[r['staged_bytes'] for r in recs]} "
                  f"bytes per rank, not {want}")
            if op == "gups":
                check(all(r["error"] == 0.0 for r in recs),
                      f"{what}: restore error {[r['error'] for r in recs]}")
                check(all(r["changed"] > 0 for r in recs),
                      f"{what}: a rank's table did not change")
            else:
                check(all(r["error"] < 1e-5 for r in recs),
                      f"{what}: error {[r['error'] for r in recs]}")
                check(all(r["bitwise_block"] for r in recs),
                      f"{what}: differs from torch.fft.fft at (B/4, n)")
            table[f"{op}/{s}/nchunks={k}"] = dict(
                seconds=max(r["seconds"] for r in recs),
                staged_bytes_per_rank=[r["staged_bytes"] for r in recs],
                **({"gups": recs[0]["gups"],
                    "seconds_by_phase_rank0": recs[0]["seconds_by_phase"]}
                   if op == "gups" else {"gflops": recs[0]["gflops"],
                                         "error": max(r["error"]
                                                      for r in recs)}))
    for rank, r in enumerate(results):
        for key in ("recv", "table"):
            check(len({r["gups", s, k][key] for s, k in combos}) == 1,
                  f"a2a rank {rank}: GUPS {key} differs across schedules")
        check(len({r["fft", s, k]["out"] for s, k in combos}) == 1,
              f"a2a rank {rank}: FFT output differs across schedules")
    check(all(v == 0 for v in ops.launch_counts().values()),
          "the parent launched kernels during the a2a phase")
    emit({"phase": "a2a", "ranks": n,
          "transport": "gloo, staged through host memory; compute on the "
                       "card",
          "gups": {"table_log": A2A_TABLE_LOG, "rngs_per_rank": A2A_RNGS,
                   "updates_per_rng": GUPS_UPDATES,
                   "exchange_bytes_per_rank": payload["gups"]},
          "fft": {"log_size": FFT_LOG, "batch_per_rank": A2A_FFT_BATCH,
                  "exchange_bytes_per_rank": payload["fft"] // 2},
          "staged_bytes_times_payload": times_payload,
          "cut": "depth only: the gups and fft phases run full size on one "
                 "rank; here four ranks share one card and the host",
          "runs": table, "restore_exact": True,
          "fft_bitwise_block_shape": True,
          "identical_across_schedules": ["received buckets", "tables",
                                         "fft output"],
          "wall_s": wall,
          "what_the_time_measures": "the host's loopback (gloo on one "
                                    "machine), not a link rate"})


def lookahead_launches(nb: int, d: int) -> dict:
    """Kernel launches of one depth-``d`` factorization of ``nb`` blocks:
    the prologue's d panel sets, then per iteration the bulk update, one
    panel set and 2d strip updates (none at d = 0)."""
    if d == 0:
        return {"gemm_update": nb, "lu_factor_block": nb,
                "trsm_lower_left": nb, "trsm_upper_right": nb}
    return {"gemm_update": d * (d - 1) + nb * (2 * d + 1),
            "lu_factor_block": nb + d, "trsm_lower_left": nb + d,
            "trsm_upper_right": nb + d}


def phase_autotune(torch, rows):
    """The cost model and autotuner on the card: HPL with lookahead="auto"
    at the main size, bit for bit the integer depth the model chose (and
    eager); the one-card section of hpl_scaling; the loopback's link
    constants on four gloo processes; the quick measured autotune and the
    --autotune gate on a ring of four. Its two-size table goes to a
    temporary directory, so the checkout's results/tuning_torch.json and
    the process's default model stay as they were."""
    import dataclasses
    import tempfile

    from repro_torch.benchmarks import hpl_scaling, hw_model
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.comm import autotune
    from repro_torch.comm.topology import AxisTopology
    from repro_torch.comm.types import H100_80GB
    from repro_torch.core.hpl import generate_system, make_factorize, run_hpl
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import single_rank_mesh

    t0 = time.perf_counter()
    nb = N_MAIN // B_MAIN
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    res = run_hpl(n=N_MAIN, b=B_MAIN, reps=1, lookahead="auto",
                  device="cuda")
    counts = ops.launch_counts()
    depth = res.details["lookahead_depth"]
    check(1 <= depth <= autotune.MAX_LOOKAHEAD_DEPTH,
          f"lookahead='auto' ran at depth {depth}")
    check(res.error < 1.0, f"HPL residual {res.error} >= 1 at lookahead "
                           f"'auto' (depth {depth})")
    per_fact = {k: v for k, v in res.details["launches"].items() if v}
    check(per_fact == lookahead_launches(nb, depth),
          f"lookahead 'auto' (depth {depth}) launched {per_fact} per "
          f"factorization, expected {lookahead_launches(nb, depth)}")
    check(counts == {k: 2 * v for k, v in res.details["launches"].items()},
          f"lookahead 'auto' launched {counts} in two factorizations")
    hpl_s = time.perf_counter() - t0

    a = torch.from_numpy(generate_system(N_MAIN)[0]).cuda()
    mesh = single_rank_mesh()
    lu = {la: make_factorize(mesh, pg=1, nb=nb, b=B_MAIN, lookahead=la)(a)
          for la in ("auto", depth, False)}
    check(bitwise(torch, lu["auto"], lu[depth]),
          f"lookahead 'auto' differs from depth {depth}")
    check(bitwise(torch, lu["auto"], lu[False]),
          "lookahead 'auto' differs from eager")
    del a, lu
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    scaling = hpl_scaling.main(quick=True, device="cuda")
    for key, rec in scaling.items():
        if isinstance(rec, dict) and "lookahead_depth" in rec:
            check(rec["err"] is None or rec["err"] < 1.0,
                  f"hpl_scaling {key}: residual {rec['err']}")
            check(rec["gflops"] > 0, f"hpl_scaling {key}: no rate")
    check(len(scaling["extrapolation"]) == len(hpl_scaling.DEVICES),
          "hpl_scaling: no extrapolation")
    scaling_s = time.perf_counter() - t1

    t1 = time.perf_counter()
    links = hw_model.link_constants(timeout=AUTOTUNE_TIMEOUT)
    links_s = time.perf_counter() - t1

    t1 = time.perf_counter()
    default = autotune.default_cost_model()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "tuning_torch.json"
        gate = bench_run.autotune_gate(True, device="cuda", path=path,
                                       timeout=AUTOTUNE_TIMEOUT)
        check(gate["path"] == str(path)
              and autotune.TuningTable.load(path).to_json() == gate["table"],
              f"the gate's table was not saved to {path}")
    table = gate["table"]
    check(table["meta"]["device"] == "cuda"
          and table["meta"]["backend"] == "gloo",
          f"tuning table measured on {table['meta']}")
    check(set(table["entries"]) == set(autotune.MEASURED_OPS),
          f"tuning table holds {sorted(table['entries'])}")
    check(autotune.default_cost_model() is default,
          "the smoke's table replaced the process's default model")
    gate_s = time.perf_counter() - t1

    ring = (AxisTopology("x", ALLREDUCE_RANKS, "ring"),)
    measured = {"peak_flops": 2.0 * N_MAIN * N_MAIN * B_MAIN
                / (rows["gemm_update"]["ms"] * 1e-3),
                "hbm_bw": 2.0 * STREAM_ELEMS * 4
                / (rows["stream_copy"]["ms"] * 1e-3)}
    emit({"phase": "autotune", "hw_model": dataclasses.asdict(H100_80GB),
          "measured_in_this_run": {
              "from_phase_kernels": measured,
              "links_loopback": links},
          "hpl": {"n": N_MAIN, "b": B_MAIN, "lookahead": "auto",
                  "depth": depth, "residual": res.error,
                  "gflops": res.metric, "seconds": res.times["best"],
                  "launches_per_factorization": per_fact,
                  "bitwise_equal": [f"depth {depth}", "eager"]},
          "hpl_scaling_quick": scaling,
          "bucket_bytes_ring4": autotune.derive_bucket_bytes(ring),
          "tuning_table": table, "gate": "ok",
          "seconds": {"hpl": hpl_s, "hpl_scaling": scaling_s,
                      "links": links_s, "autotune_gate": gate_s,
                      "phase": time.perf_counter() - t0},
          "what_the_link_times_measure": "the host's loopback (gloo "
                                         "between processes on one "
                                         "machine), not a link rate"})
    return counts


def faults_rank(mesh):
    """Runs on every rank of the faults phase: the link-down section at
    ``failover_bench.DOWN_HOP`` and the train-retune loop, payloads on the
    card."""
    from repro_torch.benchmarks import failover_bench, resilience_bench

    return (failover_bench.link_down_rank(
                mesh, (failover_bench.DOWN_HOP,), "cuda"),
            resilience_bench.train_retune_rank(mesh, "cuda"))


def phase_faults(torch):
    """The fault layer on four processes sharing the card: a severed ring
    hop rerouted and repaired, and the in-run retune under a degraded
    link, both gated, with ``ring_add_step`` launched only on the ring
    route; then the measured retune's quick ladder from this process."""
    from repro_torch.benchmarks import failover_bench as fb
    from repro_torch.benchmarks import resilience_bench as rb
    from repro_torch.comm.engine import schedules_for
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import spawn_mesh

    n = fb.RANKS
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    results = spawn_mesh(n, faults_rank, axes=("x",), timeout=FAULTS_TIMEOUT)
    ranks_s = time.perf_counter() - t0
    ld = fb.link_down_record([r[0] for r in results], fb.DOWN_HOP)
    tr = rb.train_retune_record([r[1] for r in results])
    check(ld["device"].startswith("cuda") and tr["device"].startswith("cuda"),
          f"faults ran on {ld['device']} and {tr['device']}")
    bad = fb.gate_link_down(ld)
    check(not bad, f"link-down gate: {bad}")
    bad = rb.gate_train_retune(tr)
    check(not bad, f"train-retune gate: {bad}")
    # the float allreduce's ring_add_step launches per rank: n - 1 per call
    # on the ring route, none on staged
    want = {ph: n - 1 if ld[f"resolved_{ph}"]["allreduce"] in ("ring2d",
                                                                "rs_ag")
            else 0 for ph in fb.PHASES}
    check(want == {"before": n - 1, "during": 0, "after": n - 1},
          f"allreduce resolved {[ld[f'resolved_{ph}'] for ph in fb.PHASES]}"
          ": not the ring route, then staged, then the ring route")
    check(all(ld["ring_add_step_per_rank"][ph] == [want[ph]] * n
              for ph in fb.PHASES),
          f"ring_add_step per rank {ld['ring_add_step_per_rank']}, "
          f"expected {want}")

    t1 = time.perf_counter()
    mr = rb.measured_retune_section(True, "cuda")
    measured_s = time.perf_counter() - t1
    for key in ("clean_winners", "degraded_winners"):
        names = [name for rows in mr[key].values() for _, name in rows]
        check(names and all(nm in schedules_for("bcast") for nm in names),
              f"measured retune {key}: {mr[key]}")
    check(all(v == 0 for v in ops.launch_counts().values()),
          "the parent launched kernels during the faults phase")
    emit({"phase": "faults", "ranks": n, "nbytes_per_rank": fb.NBYTES,
          "transport": "gloo, staged through host memory; payloads on the "
                       "card",
          "link_down": {k: ld[k] for k in (
              "down_hop", "resolved_before", "resolved_during",
              "resolved_after", "route_during", "route_excludes_cut",
              "ranks_agree", "bit_identical", "bcast_correct",
              "allreduce_correct", "ring_add_step_per_rank",
              "recovery_s")},
          "train_retune": {k: tr[k] for k in (
              "beta_scale", "fault_at", "heal_at", "steps", "by_phase",
              "events", "flip_events", "detect_degrade_steps",
              "detect_heal_steps", "ranks_agree", "bit_identical",
              "retune_s")},
          "measured_retune": mr,
          "gates": "ok",
          "seconds": {"ranks": ranks_s, "measured_retune": measured_s,
                      "phase": time.perf_counter() - t0},
          "what_the_time_measures": "the host's loopback (gloo on one "
                                    "machine), not a link rate"})


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
    launches["flash_attention"] = phase_serve(torch)["flash_attention"]
    launches["ring_add_step"], ring_all_ranks = phase_allreduce(torch)
    phase_gups(torch)
    phase_fft(torch)
    phase_a2a(torch)
    phase_autotune(torch, rows)
    phase_faults(torch)

    check(set(launches) == set(rows) == set(SOURCES),
          f"kernels {sorted(rows)} vs launches {sorted(launches)}")
    kernels = []
    for name, r in rows.items():
        entry = dict(name=name, route="cuda", source=SOURCES[name],
                     replaces=REPLACES[name], launches=launches[name])
        if name in ops.HPL_KERNELS:
            entry["launches_per_factorization"] = per_fact[name]
        if name in ops.ALLREDUCE_KERNELS:
            entry["launches_all_ranks"] = ring_all_ranks
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
