"""Batched serving example: prefill + streamed decode with a KV cache,
greedy and sampled, for any assigned architecture.

    python -m repro_torch.examples.serve_lm [--arch jamba-1.5-large-398b]
        [--device cuda|cpu] [--ranks 1|4]

Port of ``examples/serve_lm.py``: the reduced config with random weights
(seed 0), ``generate`` greedy and then sampled (generator seed 7), the
first row's new tokens printed. With ``--ranks 1`` (the default)
``generate`` runs without a mesh, so the prefill takes the plain
attention, as the reference's does without one (ROADMAP C7). With
``--ranks 4`` four gloo processes run the GSPMD ``generate`` on
``make_local_mesh()`` (2x2) with the whole weights, and rank 0 prints its
rows; the MoE, SSM, vlm and encoder-decoder layers wait for ROADMAP A15
there.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.examples import _ranks


def serve(device, args):
    """Both generations on this process: printable lines and the greedy
    tokens."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_local_mesh, world
    from repro_torch.models.model import build_model
    from repro_torch.train.serve import generate

    device = torch.device(device)
    cfg = reduced(get_config(args.arch))
    model = build_model(cfg)
    params = model.init(0, device=device)
    mesh = make_local_mesh() if world()[1] > 1 else None

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32))
    extras = {}
    if cfg.family == "vlm":
        extras["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.num_patches, cfg.vision_dim)).astype(np.float32))
    if cfg.is_encoder_decoder:
        extras["frames"] = torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.audio_ctx, cfg.d_model)).astype(np.float32))

    lines, greedy = [], None
    for temp, label in ((0.0, "greedy"), (args.temperature, "sampled")):
        gen = torch.Generator(device=device).manual_seed(7)
        t0 = time.perf_counter()
        out = generate(model, params, prompts, max_new_tokens=args.max_new,
                       temperature=temp, extras=extras, generator=gen,
                       mesh=mesh)
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        toks = args.batch * args.max_new
        first = out[0, args.prompt_len:].cpu().tolist()
        lines.append(f"{label:8s}: {toks} tokens in {dt:.2f}s "
                     f"({toks/dt:.1f} tok/s incl. warm-up)")
        lines.append(f"  first row: {first}")
        if greedy is None:
            greedy = first
    return lines, greedy


def main(argv=None):
    from repro_torch.configs import list_archs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.8)
    _ranks.add_args(ap)
    args = ap.parse_args(argv)
    device = _ranks.check_device(args.device)
    lines, greedy = _ranks.run(serve, args.ranks, device, args)
    print("\n".join(lines))
    return greedy


if __name__ == "__main__":
    main()
