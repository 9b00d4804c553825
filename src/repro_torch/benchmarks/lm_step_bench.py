"""LM train and decode step timings per architecture.

Port of the per-architecture section of ``benchmarks/lm_step_bench.py``
(``main``, ``:300-350``):

    python -m repro_torch.benchmarks.lm_step_bench [--quick]
        [--device cuda|cpu]

For each architecture (``--quick``: llama3-8b, mamba2-130m and qwen3-moe),
its ``reduced()`` configuration (fp32, d_model 64) trains one step through
:func:`repro_torch.train.step.make_train_step` (remat ``full``, batch 4 x
64 synthetic tokens) after a warm-up step, and decodes one token through
the serving steps after a prefill; both are timed on the host's clock,
the device drained. The vlm gets zero patch embeddings and whisper zero
frames, as in the reference. Writes
``results/bench/torch_lm_step_bench.json``.

The reference's other sections are named under ``not_ported`` in the
record (:data:`NOT_PORTED`).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.benchmarks.common import save_result, table
from repro_torch.configs import RunConfig, get_config, list_archs, reduced
from repro_torch.core.hpcc import device_name, resolve_device
from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
from repro_torch.models.model import build_model
from repro_torch.train.serve import make_decode_step, make_prefill_step
from repro_torch.train.step import init_train_state, make_train_step

QUICK_ARCHS = ("llama3-8b", "mamba2-130m", "qwen3-moe-235b-a22b")
B, S = 4, 64
NOT_PORTED = {
    "moe_explicit": "the explicit-vs-GSPMD MoE layer on a multi-rank GSPMD "
                    "mesh needs the sharding specs of ROADMAP A12's second "
                    "half (benchmarks/lm_step_bench.py:42-147)",
    "whole_model": "make_whole_model_train_step_explicit, ROADMAP A12's "
                   "second half (benchmarks/lm_step_bench.py:150-271)",
    "production_roofline": "reads launch/dryrun.py's results, ROADMAP A14 "
                           "(benchmarks/lm_step_bench.py:395-414)",
}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def arch_steps(arch: str, device) -> dict:
    """One timed train step and one timed decode step of ``arch``'s
    reduced configuration."""
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, B, S))
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in data.batch(0).items()}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros(
            (B, cfg.num_patches, cfg.vision_dim), device=device)
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.zeros((B, cfg.audio_ctx, cfg.d_model),
                                      device=device)

    state = init_train_state(model, 0, device=device)
    step = make_train_step(model, RunConfig(learning_rate=1e-3,
                                            warmup_steps=1))
    state, _ = step(state, batch)  # warm-up
    _sync(device)
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    t_train = time.perf_counter() - t0

    cache = model.init_cache(B, S + 8, torch.float32, device=device)
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    logits, cache = prefill(state.params, batch, cache)
    extras = {k: v for k, v in batch.items() if k not in ("tokens", "frames")}
    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    _, cache = decode(state.params, tok, cache, extras)  # warm-up
    _sync(device)
    t0 = time.perf_counter()
    decode(state.params, tok, cache, extras)
    _sync(device)
    return {"train_step_s": t_train, "decode_step_s":
            time.perf_counter() - t0, "loss": loss}


def main(quick: bool = False, device=None) -> dict:
    device = resolve_device(device)
    archs = QUICK_ARCHS if quick else list_archs()
    print(f"== LM step bench (reduced configs, {device_name(device)}, "
          "host clock) ==")
    record = {"device": device_name(device), "batch": [B, S],
              "not_ported": NOT_PORTED}
    rows = []
    for arch in archs:
        rec = arch_steps(arch, device)
        record[arch] = rec
        rows.append([arch, f"{rec['train_step_s'] * 1e3:.1f}ms",
                     f"{rec['decode_step_s'] * 1e3:.2f}ms",
                     f"{rec['loss']:.3f}"])
    print(table(rows, ["arch", "train_step", "decode_step", "loss"]))
    for name, why in NOT_PORTED.items():
        print(f"-- {name}: not ported yet, {why} --")
    save_result("lm_step_bench", record)
    return record


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(args.quick, args.device)
