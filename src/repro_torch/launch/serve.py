"""Serving launcher: continuous-batching generation over the paged cache.

Port of ``repro/launch/serve.py``.

    python -m repro_torch.launch.serve --arch llama3-8b --requests 8
        [--mode gspmd|explicit] [--schedule NAME] [--ranks 4]
        [--device cuda|cpu]

Serves the reduced config (random weights, seed 0), on the card unless
``--device`` says otherwise, through :class:`repro_torch.serve.ServeEngine`:
requests with mixed prompt lengths are queued, admitted under a per-step
prefill-token budget, prefilled into the paged KV cache, and decoded as
one continuously batched stream with slots recycled on EOS / max-new.
``--mode gspmd`` serves on one process. ``--mode explicit`` routes the
per-token collectives through the collective engine (the ``decode.*``
callsites, on ``--schedule`` where given): it spawns ``n = gcd(ranks,
heads, KV heads[, experts])`` gloo processes, ``--ranks`` standing in for
the reference's device count, and shrinks the slots to a multiple of
``n``, as the reference shrinks its device mesh; rank 0 prints.
``--legacy`` keeps the whole-batch ``generate`` loop, which also serves
the model families the paged cache does not cover (encoder-decoder and SSM
layers).
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.core.hpcc import device_name
from repro_torch.models.model import build_model
from repro_torch.train.serve import generate


def paged_ok(cfg) -> bool:
    """Whether the paged engine serves ``cfg``: attention-only decoders."""
    return (not cfg.is_encoder_decoder
            and all(k == "attn" for k in cfg.layer_kinds()))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _legacy(model, params, cfg, args, device):
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.requests, args.prompt_len)).astype(np.int32))
    extras = {}
    if cfg.family == "vlm":
        extras["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (args.requests, cfg.num_patches, cfg.vision_dim)).astype(
                np.float32))
    if cfg.is_encoder_decoder:
        extras["frames"] = torch.from_numpy(rng.standard_normal(
            (args.requests, cfg.audio_ctx, cfg.d_model)).astype(np.float32))

    t0 = time.perf_counter()
    out = generate(model, params, prompts, max_new_tokens=args.max_new,
                   temperature=args.temperature, extras=extras)
    _sync(device)
    dt = time.perf_counter() - t0
    new_tokens = args.requests * args.max_new
    print(f"arch={args.arch} batch={args.requests} prompt={args.prompt_len} "
          f"new={args.max_new} device={device_name(device)} "
          f"[legacy generate]")
    print(f"generated {new_tokens} tokens in {dt:.2f}s "
          f"({new_tokens / dt:.1f} tok/s incl. warm-up)")
    print("first sequence:", out[0].cpu().numpy()[:args.prompt_len + 8])
    return out


# seconds the explicit mode's processes may take
EXPLICIT_TIMEOUT = 600.0


def explicit_ranks(cfg, ranks: int) -> int:
    """The explicit decode's process count: the largest divisor of
    ``ranks`` that the heads, the KV heads and the experts (where present)
    split over, as the reference shrinks its mesh."""
    n = math.gcd(math.gcd(ranks, cfg.num_heads), cfg.num_kv_heads)
    if cfg.num_experts:
        n = math.gcd(n, cfg.num_experts)
    return n


def _serve(model, params, cfg, args, device, mesh=None):
    """The engine's run on this process: ``mesh`` is the explicit mode's
    ring (every process of it calls this), None in gspmd mode."""
    from repro_torch.launch.train import parse_fault_args
    from repro_torch.models.kvcache import PagedCacheConfig
    from repro_torch.serve import ServeEngine

    fault = parse_fault_args(args.fault_schedule, args.fail_rank)

    max_seq = args.prompt_len + args.max_new
    # two slots per rank, as the reference sizes its batch by its devices
    n = mesh.axis("x").size if mesh is not None else 1
    slots = max(min(args.requests, 2 * n), 1)
    slots = max(slots // n, 1) * n
    pcfg = PagedCacheConfig(
        page_size=args.page_size,
        num_pages=slots * (-(-max_seq // args.page_size)) * 2,
        max_slots=slots, max_seq=max_seq)
    eng = ServeEngine(model, params, pcfg, mode=args.mode, mesh=mesh,
                      schedule=args.schedule,
                      prefill_token_budget=args.prefill_budget,
                      eos_id=args.eos_id, temperature=args.temperature,
                      preempt=args.preempt,
                      admission_retries=args.admission_retries,
                      fault_schedule=fault)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size,
                            size=(int(rng.integers(args.prompt_len // 2,
                                                   args.prompt_len + 1)),)
                            ).astype(np.int32)
               for _ in range(args.requests)]
    for p in prompts:
        eng.submit(p, args.max_new, deadline_s=args.deadline_s)
    t0 = time.perf_counter()
    out, stats = eng.run(collect_stats=True)
    dt = time.perf_counter() - t0
    return out, stats, dt, prompts, pcfg, n


def _explicit_rank(mesh, args, device):
    """One process of the explicit mode (module level, so that spawned
    processes import it): the engine's run on the ring."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(0)
    cfg = reduced(get_config(args.arch))
    model = build_model(cfg)
    params = model.init(0, device=device)
    return _serve(model, params, cfg, args, device, mesh)


def _paged(model, params, cfg, args, device):
    if args.mode == "explicit":
        from repro_torch.launch import serve as this  # not __main__
        from repro_torch.launch.mesh import spawn_mesh

        n = explicit_ranks(cfg, args.ranks)
        out, stats, dt, prompts, pcfg, n = spawn_mesh(
            n, this._explicit_rank, args, str(device), axes=("x",),
            timeout=EXPLICIT_TIMEOUT)[0]
    else:
        out, stats, dt, prompts, pcfg, n = _serve(model, params, cfg, args,
                                                  device)
    new_tokens = sum(out[r].shape[0] - p.shape[0]
                     for r, p in enumerate(prompts))
    decode_steps = [s["decode_s"] for s in stats if s["decode_tokens"]]
    print(f"arch={args.arch} mode={args.mode} requests={args.requests} "
          f"slots={pcfg.max_slots} pages={pcfg.num_pages}x{pcfg.page_size} "
          f"ranks={n} device={device_name(device)}")
    print(f"generated {new_tokens} tokens in {dt:.2f}s "
          f"({new_tokens / dt:.1f} tok/s incl. warm-up) over "
          f"{len(stats)} steps ({len(decode_steps)} decode batches)")
    if decode_steps:
        lat = np.sort(decode_steps)
        print(f"decode-step latency p50={lat[len(lat) // 2] * 1e3:.2f}ms "
              f"p99={lat[min(int(len(lat) * 0.99), len(lat) - 1)] * 1e3:.2f}ms")
    degraded = {k: sum(s.get(k, 0) for s in stats)
                for k in ("preempted", "timeouts", "rejected", "drained")}
    if any(degraded.values()):
        print("degradation: " + " ".join(f"{k}={v}"
                                         for k, v in degraded.items()))
    print("first sequence:", out[0][:prompts[0].shape[0] + 8])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--mode", choices=("gspmd", "explicit"), default="gspmd")
    ap.add_argument("--schedule", default=None,
                    help="override the decode collectives' schedule "
                         "(explicit mode)")
    ap.add_argument("--ranks", type=int, default=4,
                    help="processes available to the explicit mode (the "
                         "reference's device count); it runs on the "
                         "largest divisor the model's heads split over")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-budget", type=int, default=512)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--preempt", action="store_true",
                    help="evict the youngest active request (tokens kept, "
                         "re-prefilled) when the head cannot get pages")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall-clock deadline; expired requests "
                         "finish with reason 'timeout'")
    ap.add_argument("--admission-retries", type=int, default=256,
                    help="failed admission attempts before the queue head "
                         "is rejected")
    ap.add_argument("--fault-schedule", default=None, metavar="SPEC",
                    help="scripted fault timeline applied per serve step "
                         "(repro_torch.comm.faults.FaultSchedule.parse), "
                         "e.g. 'delay@5-20:seconds=0.05,callsite=serve.step'")
    ap.add_argument("--fail-rank", default=None, metavar="RANK@STEP",
                    help="shorthand: lose device RANK at serve step STEP; "
                         "requests with KV pages on it drain and re-prefill "
                         "on surviving pages")
    ap.add_argument("--legacy", action="store_true",
                    help="whole-batch generate loop instead of the "
                         "continuous-batching engine")
    ap.add_argument("--device", default="cuda",
                    help="where to serve (default: the card)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to "
                         "serve on the CPU")
    if args.schedule is not None:
        from repro_torch.comm.engine import known_schedules
        if args.schedule not in known_schedules():
            raise SystemExit(f"unknown schedule {args.schedule!r}; "
                             f"registered: {sorted(known_schedules())}")
    cfg = reduced(get_config(args.arch))
    model = build_model(cfg)
    if not args.legacy and paged_ok(cfg) and args.mode == "explicit":
        # the processes draw their own weights
        return _paged(model, None, cfg, args, device)
    params = model.init(0, device=device)

    if args.legacy or not paged_ok(cfg):
        return _legacy(model, params, cfg, args, device)
    return _paged(model, params, cfg, args, device)


if __name__ == "__main__":
    main()
