"""Where the time of two kernel routes goes: text variants of
``csrc/flash_attention.cu`` (route ``simt_f32``) and ``csrc/gemm_update.cu``
(route ``wgmma_bf16``), timed against each other on the card.

    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_variants [--parent DIR] [--rounds 7]

Each variant is a copy of the source with pieces of text replaced
(:data:`VARIANTS`): a phase's loop bound set to 0 drops that phase, so the
differences split the kernel's time into its phases; other variants undo
one design choice. Each copy is compiled with ``nvcc`` and the build's
flags into ``build/kernel_variants/`` and called through its C entry point
at the main paths' shapes: the fp32 flash at the serving prefill's (q
8x1024x24x128, k and v 8x1024x8x128, causal), the bf16 update at HPL's (C
16384^2, K 64). ``--parent DIR`` adds the sources in DIR (an earlier
commit's ``csrc``, unpacked with ``git archive``) as one more variant of
each. Times are medians of alternated rounds, the order rotated and
reversed from round to round; the variants that keep the function are
also held against the plain version (``max_abs_err``). Prints one JSON
line per kernel, with the card's name.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.core.hpcc import device_name, resolve_device
from repro_torch.kernels import _build, ref
from repro_torch.kernels import attention as kfa
from repro_torch.kernels import gemm as kgemm

OUT = _build.BUILD_ROOT.parent / "kernel_variants"
# kernel: {variant: ([(text, replacement)], whether it keeps the function)}
VARIANTS = {
    "flash": {
        "final": ([], True),
        "no_tile_skip": ([("if (causal && kv0 > q_offset + q0 + 16 * (ty >> 1)"
                           " + 15) {", "if (false) {")], True),
        "no_qk": ([("for (int d = 0; d < HD; d += 4) {",
                    "for (int d = 0; d < 0; d += 4) {")], False),
        "no_pv": ([("for (int kk = 0; kk < BK; kk += 4) {",
                    "for (int kk = 0; kk < 0; kk += 4) {")], False),
        "no_qk_no_pv": ([("for (int d = 0; d < HD; d += 4) {",
                          "for (int d = 0; d < 0; d += 4) {"),
                         ("for (int kk = 0; kk < BK; kk += 4) {",
                          "for (int kk = 0; kk < 0; kk += 4) {")], False),
        "no_exp": ([("s[i][j] = expf(s[i][j] - m_new);",
                     "s[i][j] = s[i][j] - m_new;"),
                    ("const float alpha = expf(m[i] - m_new);",
                     "const float alpha = m[i] - m_new;")], False),
        "q_read_once": ([("&Qs[(rbase + 2 * i) * LD + d]",
                          "&Qs[rbase * LD + d]")], False),
        "no_row_reductions": ([(
            "for (int off = 8; off > 0; off >>= 1)\n      rmax",
            "for (int off = 0; off > 0; off >>= 1)\n      rmax"), (
            "for (int off = 8; off > 0; off >>= 1)\n      rsum",
            "for (int off = 0; off > 0; off >>= 1)\n      rsum")], False),
        "mask_every_tile": ([("      softmax_step<false>(s, m, l, acc",
                              "      softmax_step<true>(s, m, l, acc")], True),
        "no_mask": ([("      softmax_step<true>(s, m, l, acc",
                      "      softmax_step<false>(s, m, l, acc")], False),
        # the ring filled once, then only handed back: stale tiles, the same
        # products; what it saves is the load time the ring does not hide
        "no_refills": ([("((z / BUFS) & 1) ^ 1);\n      if (z & 1)",
                         "((z / BUFS) & 1) ^ 1);\n      if (z >= BUFS) {\n"
                         "      } else if (z & 1)")], False),
    },
    "gemm_bf16": {
        "final": ([], True),
        "c_stages_2": ([("constexpr int C_STAGES = 3;",
                         "constexpr int C_STAGES = 2;")], True),
        "c_stages_4": ([("constexpr int C_STAGES = 3;",
                         "constexpr int C_STAGES = 4;")], True),
    },
}
STEM = {"flash": "flash_attention", "gemm_bf16": "gemm_update"}


def variant_sources(kernel: str, parent=None) -> dict:
    """``{name: (source text, keeps the function)}`` for ``kernel``; each
    replaced text must occur exactly once in the source."""
    src = (_build.CSRC / f"{STEM[kernel]}.cu").read_text()
    out = {}
    for name, (reps, keeps) in VARIANTS[kernel].items():
        text = src
        for old, new in reps:
            if text.count(old) != 1:
                raise ValueError(f"variant {kernel}/{name}: {old!r} occurs "
                                 f"{text.count(old)} times in the source")
            text = text.replace(old, new)
        out[name] = (text, keeps)
    if parent:
        out["parent"] = ((Path(parent) / f"{STEM[kernel]}.cu").read_text(),
                         True)
    return out


def _compile(sources: dict) -> dict:
    """Build every ``{tag: text}`` in parallel; ``{tag: loaded library}``."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, text in sources.items():
        (OUT / f"{tag}.cu").write_text(text)
        procs[tag] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{tag}.so"),
             str(OUT / f"{tag}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for tag, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {tag} failed to build:\n{log[-3000:]}")
        libs[tag] = ctypes.CDLL(str(OUT / f"{tag}.so"))
    return libs


def _alternated_ms(fns: dict, rounds: int, iters: int) -> dict:
    """Median ms per call of each of ``fns`` over ``rounds`` rounds of
    ``iters`` back-to-back calls between CUDA events, one warm-up call
    first, the order rotated and reversed from round to round."""
    names, times = list(fns), {k: [] for k in fns}
    for r in range(rounds):
        order = names[r % len(names):] + names[:r % len(names)]
        for k in (order[::-1] if r % 2 else order):
            fns[k]()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fns[k]()
            end.record()
            torch.cuda.synchronize()
            times[k].append(start.elapsed_time(end) / iters)
    return {k: statistics.median(v) for k, v in times.items()}


def _flash_call(lib, q, k, v):
    fn = lib.repro_flash_attention_f32
    fn.argtypes, fn.restype = kfa._ARGTYPES, ctypes.c_int

    def call():
        out = torch.empty_like(q)
        strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out)
                                          for s in t.stride()[:3]))
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), strides, q.shape[0], q.shape[2],
                        k.shape[2], q.shape[1], k.shape[1], q.shape[3], 1, 0,
                        float(q.shape[3] ** -0.5),
                        torch.cuda.current_stream().cuda_stream),
                     "flash variant")
        return out
    return call


def _gemm_call(lib, c, a, b, tile, ctas):
    fn = lib.repro_gemm_update_bf16
    fn.argtypes, fn.restype = kgemm._ARGTYPES, ctypes.c_int

    def call():
        _build.check(fn(a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
                        c.data_ptr(), c.stride(0), c.shape[0], c.shape[1],
                        a.shape[1], -1.0, tile, ctas,
                        torch.cuda.current_stream().cuda_stream),
                     "gemm_update variant")
        return c
    return call


def main(parent=None, rounds: int = 7) -> dict:
    device = resolve_device(None)
    gen = torch.Generator(device=device).manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = {}
    for kernel in VARIANTS:
        for name, (text, _) in variant_sources(kernel, parent).items():
            sources[f"{kernel}.{name}"] = text
    libs = _compile(sources)
    result = {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    q, k, v = randn(8, 1024, 24, 128), randn(8, 1024, 8, 128), \
        randn(8, 1024, 8, 128)
    want = ref.flash_attention(q, k, v)
    calls, errs = {}, {}
    for name, (_, keeps) in variant_sources("flash", parent).items():
        calls[name] = _flash_call(libs[f"flash.{name}"], q, k, v)
        if keeps:
            errs[name] = float((calls[name]() - want).abs().max())
    del want
    result["flash"] = {"ms": _alternated_ms(calls, rounds, iters=10),
                       "max_abs_err": errs}
    del q, k, v, calls
    torch.cuda.empty_cache()

    m, kk = 16384, 64
    a, b, c0 = (randn(m, kk).bfloat16(), randn(kk, m).bfloat16(),
                randn(m, m).bfloat16())
    want = ref.gemm_update(c0, a, b)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    calls, errs = {}, {}
    for name, (text, _) in variant_sources("gemm_bf16", parent).items():
        lib = libs[f"gemm_bf16.{name}"]
        # a source without the tensor-core kernel ran bf16 through the fp32
        # route's template and geometry
        geometry = kgemm.gemm_geometry_bf16 \
            if "gemm_update_bf16_kernel" in text else kgemm.gemm_geometry
        errs[name] = float((_gemm_call(lib, c0.clone(), a, b,
                                       *geometry(m, m, sms))()
                            .float() - want.float()).abs().max())
        calls[name] = _gemm_call(lib, c0.clone(), a, b, *geometry(m, m, sms))
    calls["library"] = lambda: torch.addmm(c0, a, b, alpha=-1.0)
    result["gemm_bf16"] = {"ms": _alternated_ms(calls, rounds, iters=10),
                           "max_abs_err": errs}
    for kernel, row in result.items():
        print(json.dumps({"kernel_variants": kernel,
                          "device": device_name(device),
                          **row}), flush=True)
    return result


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", default=None,
                   help="a directory holding an earlier commit's csrc")
    p.add_argument("--rounds", type=int, default=7)
    args = p.parse_args()
    main(parent=args.parent, rounds=args.rounds)
