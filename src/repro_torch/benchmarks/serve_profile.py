"""Where the serving path's time goes on the card: one prefill and one
decode step under torch.profiler.

    PYTHONPATH=src python -m repro_torch.benchmarks.serve_profile [--arch llama3.2-3b] [--layers N] [--batch 8] [--prompt 1024] [--engine]

Builds the model at full width with random weights (seed 0), at its full
depth or, with ``--layers``, at N layers (e.g. ``--arch
qwen3-moe-235b-a22b --layers 4``, whose 94 layers do not fit one card, or
``--arch llama-3.2-vision-90b --layers 5``, one period with its cross
layer), casts them once to the compute dtype, warms both steps, then
profiles one prefill of ``batch`` x ``prompt`` tokens on the one-rank mesh
(the flash path) and one decode step after it. A vlm model gets
``num_patches`` x ``vision_dim`` patch embeddings per request from the
seed (its decode recomputes their cross K/V every step, as the reference
does), an encoder-decoder (``--arch whisper-base``) ``audio_ctx`` frames.

``--engine`` profiles the continuous-batching
:class:`~repro_torch.serve.ServeEngine` instead (attention-only decoders):
``batch`` requests of ``prompt`` tokens on a pool of pages of 16 tokens,
one slot each, admitted in one step; after a warm run it profiles that
admission step (``batch`` batch-1 prefills without a mesh, their commits
into the pages and the first paged decode) and the next step (one paged
decode over every slot).

Prints one JSON line per step: wall time (host clock, ending in a
synchronize), device time summed by kernel name, and the device's busy
share of the wall time. The work runs on one stream, so device activities
do not overlap and their sum over the wall time is the busy share. The
profiler adds host cost to every launch, so these wall times are longer
than ``chip_smoke.py``'s.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core.hpcc import device_name, resolve_device
from repro_torch.launch.mesh import single_rank_mesh
from repro_torch.models.model import build_model
from repro_torch.models.transformer import cast_params, dtype_of
from repro_torch.train.serve import make_decode_step, make_prefill_step

ENGINE_PAGE, ENGINE_NEW = 16, 32


def _profiled(fn):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total:
            by_name[evt.key] = (evt.self_device_time_total / 1e3, evt.count)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return out, {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
                 "busy_share": busy_ms / (wall * 1e3),
                 "launches": sum(cnt for _, cnt in by_name.values()),
                 "by_kernel": [{"name": k[:120], "ms": ms, "count": cnt}
                               for k, (ms, cnt) in top[:15]]}


def _extras(cfg, batch: int, gen, device) -> dict:
    """The model's other inputs from the seed: vlm patch embeddings,
    encoder-decoder frames."""
    if cfg.family == "vlm":
        return {"patch_embeds": torch.randn(
            (batch, cfg.num_patches, cfg.vision_dim), generator=gen,
            device=device)}
    if cfg.is_encoder_decoder:
        return {"frames": torch.randn((batch, cfg.audio_ctx, cfg.d_model),
                                      generator=gen, device=device)}
    return {}


def _steps(model, params, tokens, extras):
    """The prefill and the decode step on the one-rank mesh."""
    batch, prompt = tokens.shape
    dtype = dtype_of(model.cfg.dtype)
    mesh = single_rank_mesh(("x",))
    prefill, decode = make_prefill_step(model, mesh), make_decode_step(model,
                                                                       mesh)
    decode_extras = {k: v for k, v in extras.items() if k != "frames"}

    def run_prefill():
        cache = model.init_cache(batch, prompt + 2, dtype,
                                 device=tokens.device)
        logits, cache = prefill(params, {"tokens": tokens, **extras}, cache)
        return torch.argmax(logits[:, -1], -1).to(tokens.dtype)[:, None], \
            cache

    def run_decode(tok, cache):
        return decode(params, tok, cache, decode_extras)

    tok, cache = run_prefill()  # warm: kernels loaded, allocator primed
    run_decode(tok, cache)
    del cache
    (tok, cache), pre = _profiled(run_prefill)
    _, dec = _profiled(lambda: run_decode(tok, cache))
    return (("prefill", pre), ("decode", dec))


def _engine_steps(model, params, tokens):
    """The engine's admission step and its next (decode-only) step."""
    from repro_torch.models.kvcache import PagedCacheConfig
    from repro_torch.serve import ServeEngine

    batch, prompt = tokens.shape
    max_seq = prompt + ENGINE_NEW
    pcfg = PagedCacheConfig(page_size=ENGINE_PAGE,
                            num_pages=batch * -(-max_seq // ENGINE_PAGE),
                            max_slots=batch, max_seq=max_seq)
    prompts = list(tokens.cpu().numpy())

    def engine():
        eng = ServeEngine(model, params, pcfg, dtype=params.embed.dtype,
                          prefill_token_budget=batch * prompt)
        for p in prompts:
            eng.submit(p, ENGINE_NEW)
        return eng

    engine().run()  # warm
    eng = engine()
    admit, pre = _profiled(eng.step)
    if admit["prefills"] != batch or admit["active"] != batch:
        raise RuntimeError(f"the engine admitted {admit['prefills']} of "
                           f"{batch} requests in one step")
    _, dec = _profiled(eng.step)
    return (("engine_admit", pre), ("engine_decode", dec))


def main(arch: str = "llama3.2-3b", batch: int = 8, prompt: int = 1024,
         layers: int = 0, engine: bool = False) -> list:
    device = resolve_device(None)
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = build_model(cfg)
    params = cast_params(model.init(0, device=device), dtype_of(cfg.dtype))
    gen = torch.Generator(device=device).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                           device=device, dtype=torch.int32)
    if engine:
        steps = _engine_steps(model, params, tokens)
    else:
        steps = _steps(model, params, tokens,
                       _extras(cfg, batch, gen, device))
    records = []
    for step, rec in steps:
        record = {"step": step, "arch": arch, "layers": cfg.num_layers,
                  "batch": batch, "prompt": prompt,
                  "device": device_name(device), **rec}
        print(json.dumps(record), flush=True)
        records.append(record)
    return records


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: full)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=1024)
    ap.add_argument("--engine", action="store_true",
                    help="profile the continuous-batching engine's steps")
    args = ap.parse_args()
    main(args.arch, args.batch, args.prompt, args.layers, args.engine)
