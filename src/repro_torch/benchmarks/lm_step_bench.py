"""LM train and decode step timings per architecture, the explicit MoE
layer against the GSPMD one, and the explicit whole-model train step
against the one-rank step.

Port of the per-architecture section of ``benchmarks/lm_step_bench.py``
(``main``, ``:300-350``), of its ``moe_explicit`` section (``:42-147``)
and of its whole-model section (``:150-271``):

    python -m repro_torch.benchmarks.lm_step_bench [--quick]
        [--schedule NAME] [--device cuda|cpu]

For each architecture (``--quick``: llama3-8b, mamba2-130m and qwen3-moe),
its ``reduced()`` configuration (fp32, d_model 64) trains one step through
:func:`repro_torch.train.step.make_train_step` (remat ``full``, batch 4 x
64 synthetic tokens) after a warm-up step, and decodes one token through
the serving steps after a prefill; both are timed on the host's clock,
the device drained. The vlm gets zero patch embeddings and whisper zero
frames, as in the reference. A ``--schedule`` other than ``auto`` skips
these timings, which no schedule changes, as in the reference.

The ``moe_explicit`` section runs on a ring of four gloo processes
(payloads on the device): reduced qwen3-moe (``tiny(4, layers=1)``, one
expert per rank, 4 rows of 16 tokens with ``--quick``, else 32) through
the GSPMD ``apply_moe`` on each rank's rows of the batch-split input (the
ring's ``rules_for`` gives ``dp=('x',)``, no tensor axis: every rank holds
every expert) and through ``make_apply_moe_explicit`` with ``nchunks=
"auto"`` (dispatch and combine engine exchanges), with the maximum |Δ|
between them, both timed; then one explicit data-parallel step
(``make_dp_train_step_explicit``) so that ``dp.grads`` resolves at real
bucket payloads, and every callsite's resolved schedule.

The whole-model section runs on four gloo processes (payloads on the
device): reduced qwen3-moe (``tiny(4, layers=1)``, 4 rows of 16 tokens with
``--quick``, else 32) takes one step of
:func:`~repro_torch.train.step.make_whole_model_train_step_explicit` in
each attention mode (``tp``, ``sp``) with the requested engine schedule and
``nchunks="auto"``, from one initial state, then a timed second step. The
comparison leg is the port's one-rank ``make_train_step`` on the global
batch from the same state: the function the reference's GSPMD step
computes on a mesh whose parameters are replicated (its ``comparison``
field says so). Recorded: the loss, grad-norm and weight differences, the
step seconds (slowest rank), and every callsite's resolved schedule at
its per-rank payload (``tp.qkv``, ``tp.out``, ``sp.qkv``, ``sp.out``,
``sp.kv``, ``moe.dispatch``, ``moe.combine``, and ``dp.grads`` per
bucket of the replicated leaves); exits 1 if any names an unregistered
schedule. Writes ``results/bench/torch_lm_step_bench.json``.

The production roofline (reference ``benchmarks/lm_step_bench.py:
393-414``): per architecture, the three roofline terms of its
``train_4k`` cell on the single pod, from the meta-device dry run's
records in ``results/dryrun_torch/`` (:mod:`repro_torch.launch.dryrun`;
counts, not measurements). Every section of the reference is ported
(:data:`NOT_PORTED` is empty).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

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
MOE_ARCH = "qwen3-moe-235b-a22b"
RANKS = 4               # gloo processes of the whole-model section
TIMEOUT = 300.0         # seconds its world may take
NOT_PORTED: dict = {}
# callsite tag -> engine op, for the resolution gate
GATE_OPS = {
    "moe.dispatch": "all_to_all_tiles", "moe.combine": "all_to_all_tiles",
    "tp.qkv": "all_to_all_tiles", "tp.out": "all_to_all_tiles",
    "sp.qkv": "all_to_all_tiles", "sp.out": "all_to_all_tiles",
    "sp.kv": "ring_exchange",
    "dp.grads": "allreduce",
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


def moe_explicit_rank(mesh, requested: str, seq: int, device) -> dict:
    """Runs on every rank of a gloo ring: the reduced qwen3-moe layer
    through the GSPMD ``apply_moe`` on this rank's rows and through the
    explicit layer, then one explicit data-parallel step; returns this
    rank's maximum |Δ| between the layers, the seconds and every
    callsite's resolution."""
    from repro_torch import sharding as sh
    from repro_torch.comm.engine import CollectiveEngine
    from repro_torch.comm.overlap import pack_buckets, tree_flatten
    from repro_torch.configs.qwen3_moe_235b_a22b import tiny
    from repro_torch.models import moe as MOE
    from repro_torch.train.step import (GRADS_CALLSITE,
                                        make_dp_train_step_explicit)

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(0)
    n = mesh.axis("x").size
    cfg = tiny(n, layers=1)
    engine = CollectiveEngine.for_mesh(mesh, schedule=requested)
    B, D = n, cfg.d_model
    gen = torch.Generator(device=device)
    p = MOE.init_moe(gen.manual_seed(0), cfg, device)
    x = torch.randn((B, seq, D), generator=gen.manual_seed(1), device=device)
    r = mesh.axis("x").index
    rows = x[r * (B // n):(r + 1) * (B // n)]

    def timed(fn, *args, reps=2):
        out = fn(*args)  # warm-up
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        _sync(device)
        return out, (time.perf_counter() - t0) / reps

    # GSPMD: the batch-split input; on the ring every rank holds every
    # expert (no tensor axis), so the layer needs no exchange
    shard = sh.make_shard_fn(mesh, sh.rules_for(mesh))
    with torch.no_grad():
        out_g, t_gspmd = timed(lambda: MOE.apply_moe(p, cfg, rows,
                                                     shard=shard))
        explicit = MOE.make_apply_moe_explicit(cfg, mesh, engine=engine,
                                               nchunks="auto")
        local = MOE.expert_shard(p, mesh)
        out_e, t_explicit = timed(lambda: explicit(local, rows))
    err = float((out_e.float() - out_g.float()).abs().max())
    # the reference's limit for the explicit layer (tests/dist/test_moe.py)
    within = bool(torch.allclose(out_e.float(), out_g.float(), rtol=1e-4,
                                 atol=1e-5))

    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, B, seq))
    batch = data.batch(0)
    model = build_model(cfg)
    state = init_train_state(model, 2, device=device)
    step = make_dp_train_step_explicit(
        model, RunConfig(learning_rate=1e-3, warmup_steps=1), mesh,
        schedule_kind=requested)
    state, _ = step(state, batch)  # warm-up
    _sync(device)
    t0 = time.perf_counter()
    _, metrics = step(state, batch)
    _sync(device)
    t_dp = time.perf_counter() - t0

    C = MOE._capacity(cfg, seq)
    exchange_bytes = (B // n) * cfg.num_experts * C * D * 4
    bucket_bytes = engine.bucket_bytes_for("x")
    leaves = tree_flatten(state.params.tree())[0]
    payloads = sorted({sum(leaves[i].numel() * 4 for i in b
                           if leaves[i].numel())
                       for b in pack_buckets(leaves, bucket_bytes)} - {0})
    per_bucket = [engine.schedule_for("allreduce", nbytes=nb, axis="x",
                                      callsite=GRADS_CALLSITE)
                  for nb in payloads]
    resolved = {
        "moe.dispatch": engine.schedule_for(
            "all_to_all_tiles", nbytes=exchange_bytes, axis="x",
            callsite=MOE.DISPATCH_CALLSITE),
        "moe.combine": engine.schedule_for(
            "all_to_all_tiles", nbytes=exchange_bytes, axis="x",
            callsite=MOE.COMBINE_CALLSITE),
        "dp.grads": per_bucket[-1]}
    return {"max_abs_err_vs_gspmd": err, "within_tolerance": within,
            "t_gspmd_s": t_gspmd,
            "t_explicit_s": t_explicit, "t_dp_step_s": t_dp,
            "dp_loss": float(metrics["loss"]), "resolved": resolved,
            "nchunks": engine.pipeline_chunks(
                "all_to_all_tiles", nbytes=exchange_bytes, axis="x",
                callsite=MOE.DISPATCH_CALLSITE),
            "dp_grads_bucket_payloads": payloads,
            "dp_grads_resolved_per_bucket": per_bucket,
            "exchange_bytes": exchange_bytes, "bucket_bytes": bucket_bytes,
            "grad_bytes": 4 * sum(t.numel() for t in leaves)}


def moe_explicit_record(per_rank, requested: str, seq: int, device) -> dict:
    """The section's record from every rank's :func:`moe_explicit_rank`:
    the largest |Δ| and the slowest rank's seconds."""
    first = per_rank[0]
    return {"arch": MOE_ARCH, "config": f"tiny({RANKS}, layers=1)",
            "ranks": len(per_rank), "batch": [len(per_rank), seq],
            "device": device_name(torch.device(device)),
            "schedule_requested": requested,
            "max_abs_err_vs_gspmd": max(r["max_abs_err_vs_gspmd"]
                                        for r in per_rank),
            "within_tolerance": all(r["within_tolerance"] for r in per_rank),
            **{k: max(r[k] for r in per_rank)
               for k in ("t_gspmd_s", "t_explicit_s", "t_dp_step_s")},
            "schedule": first["resolved"]["moe.dispatch"],
            "ranks_agree": all(r["resolved"] == first["resolved"]
                               for r in per_rank),
            **{k: first[k] for k in (
                "dp_loss", "resolved", "nchunks",
                "dp_grads_bucket_payloads", "dp_grads_resolved_per_bucket",
                "exchange_bytes", "bucket_bytes", "grad_bytes")}}


def moe_explicit_section(quick: bool, schedule, device) -> dict:
    """The ``moe_explicit`` section on :data:`RANKS` gloo processes."""
    from repro_torch.launch.mesh import spawn_mesh

    requested = schedule or "auto"
    seq = 16 if quick else 32
    per_rank = spawn_mesh(RANKS, moe_explicit_rank, requested, seq,
                          str(device), axes=("x",), timeout=TIMEOUT)
    return moe_explicit_record(per_rank, requested, seq, device)


def whole_model_rank(mesh, requested: str, seq: int, device) -> dict:
    """Runs on every rank of a gloo ring: one explicit whole-model step per
    attention mode from the same initial state, then a timed second step;
    rank 0 also hands back the whole weights after the first step. Returns
    the metrics, the seconds and every callsite's resolution."""
    import torch.distributed as dist

    from repro_torch.comm.callsites import (MOE_COMBINE, MOE_DISPATCH,
                                            SP_KV, SP_OUT, SP_QKV, TP_OUT,
                                            TP_QKV)
    from repro_torch.comm.overlap import pack_buckets, tree_flatten
    from repro_torch.configs.qwen3_moe_235b_a22b import tiny
    from repro_torch.models import moe as MOE
    from repro_torch.models.parallel import ATTN_MODES
    from repro_torch.train.step import (GRADS_CALLSITE,
                                        gather_whole_model_state,
                                        make_whole_model_train_step_explicit,
                                        shard_whole_model_state,
                                        whole_model_param_specs)

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(0)
    n = mesh.axis("x").size
    cfg = tiny(n, layers=1)
    model = build_model(cfg)
    batch = SyntheticLMDataset(DataConfig(cfg.vocab_size, n, seq)).batch(0)
    run = RunConfig(learning_rate=1e-3, warmup_steps=1)
    out = {"modes": {}}
    for mode in ATTN_MODES:
        state = shard_whole_model_state(
            init_train_state(model, 0, device=device), mesh)
        step = make_whole_model_train_step_explicit(
            model, run, mesh, attn_mode=mode, schedule_kind=requested,
            nchunks="auto")
        state, metrics = step(state, batch)
        whole = gather_whole_model_state(state, mesh)
        rec = {"loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"])}
        if mesh.rank == 0:
            # copies: the timed step below updates the weights in place
            rec["params"] = [t.detach().cpu().numpy().copy() for t in
                             tree_flatten(whole.params.tree())[0]]
        del whole
        dist.barrier()
        t0 = time.perf_counter()
        step(state, batch)
        _sync(device)
        rec["t_step_s"] = time.perf_counter() - t0
        out["modes"][mode] = rec
    engine = step.engine
    # each callsite's resolution at its per-rank payload (never "auto")
    H, KV, hd, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    C = MOE._capacity(cfg, seq)
    b_loc = len(batch["tokens"]) // n
    attn_bytes = b_loc * seq * H * hd * 4        # a q/k/v exchange
    kv_ring_bytes = n * (seq // n) * KV * 2 * hd * 4  # the [k|v] block
    moe_bytes = b_loc * cfg.num_experts * C * D * 4

    def a2a(nbytes, cs):
        return engine.schedule_for("all_to_all_tiles", nbytes=nbytes,
                                   axis="x", callsite=cs)

    resolved = {TP_QKV: a2a(attn_bytes, TP_QKV),
                TP_OUT: a2a(attn_bytes, TP_OUT),
                SP_QKV: a2a(attn_bytes, SP_QKV),
                SP_OUT: a2a(attn_bytes, SP_OUT),
                SP_KV: engine.schedule_for("ring_exchange",
                                           nbytes=kv_ring_bytes, axis="x",
                                           callsite=SP_KV),
                MOE_DISPATCH: a2a(moe_bytes, MOE_DISPATCH),
                MOE_COMBINE: a2a(moe_bytes, MOE_COMBINE)}
    # dp.grads reduces the replicated leaves only (the expert shards are
    # complete on their rank and never ride the wire)
    leaves = tree_flatten(state.params.tree())[0]
    specs = tree_flatten(whole_model_param_specs(state.params))[0]
    rep = [t for t, s in zip(leaves, specs) if s.replicated]
    payloads = [sum(rep[i].numel() * 4 for i in b)
                for b in pack_buckets(rep, engine.bucket_bytes_for("x"))]
    per_bucket = [engine.schedule_for("allreduce", nbytes=nb, axis="x",
                                      callsite=GRADS_CALLSITE)
                  for nb in payloads]
    resolved[GRADS_CALLSITE] = per_bucket[-1]
    out.update(resolved=resolved, dp_grads_bucket_payloads=payloads,
               dp_grads_resolved_per_bucket=per_bucket,
               nchunks=engine.pipeline_chunks(
                   "all_to_all_tiles", nbytes=moe_bytes, axis="x",
                   callsite=MOE_DISPATCH),
               attn_exchange_bytes=attn_bytes, kv_ring_bytes=kv_ring_bytes,
               moe_exchange_bytes=moe_bytes)
    return out


def whole_model_section(quick: bool, schedule, device) -> dict:
    """The whole-model section on :data:`RANKS` gloo processes, then the
    one-rank comparison step in this process (after the ranks exit)."""
    from repro_torch.comm.overlap import tree_flatten
    from repro_torch.configs.qwen3_moe_235b_a22b import tiny
    from repro_torch.launch.mesh import spawn_mesh

    requested = schedule or "auto"
    seq = 16 if quick else 32
    per_rank = spawn_mesh(RANKS, whole_model_rank, requested, seq,
                          str(device), axes=("x",), timeout=TIMEOUT)
    cfg = tiny(RANKS, layers=1)
    model = build_model(cfg)
    batch = SyntheticLMDataset(DataConfig(cfg.vocab_size, RANKS,
                                          seq)).batch(0)
    state = init_train_state(model, 0, device=device)
    step = make_train_step(model, RunConfig(learning_rate=1e-3,
                                            warmup_steps=1))
    state, ref = step(state, batch)
    ref_leaves = [t.detach().cpu().numpy() for t in
                  tree_flatten(state.params.tree())[0]]
    modes = {}
    for mode, rec in per_rank[0]["modes"].items():
        modes[mode] = {
            "t_step_s": max(r["modes"][mode]["t_step_s"] for r in per_rank),
            "loss": rec["loss"],
            "loss_err_vs_one_rank": abs(rec["loss"] - float(ref["loss"])),
            "grad_norm_err_vs_one_rank": abs(rec["grad_norm"]
                                             - float(ref["grad_norm"])),
            "max_abs_param_err_vs_one_rank": max(
                float(abs(a - b).max()) if a.size else 0.0
                for a, b in zip(rec["params"], ref_leaves))}
    first = per_rank[0]
    return {"arch": MOE_ARCH, "config": "tiny(4, layers=1)",
            "ranks": RANKS, "batch": [RANKS, seq],
            "device": device_name(device),
            "schedule_requested": requested,
            "comparison": "the port's one-rank make_train_step on the global "
                          "batch: the function the reference's GSPMD step "
                          "computes on a mesh whose parameters are "
                          "replicated",
            "modes": modes,
            "ranks_agree": all(r["resolved"] == first["resolved"]
                               for r in per_rank),
            **{k: first[k] for k in (
                "resolved", "nchunks", "dp_grads_bucket_payloads",
                "dp_grads_resolved_per_bucket", "attn_exchange_bytes",
                "kv_ring_bytes", "moe_exchange_bytes")}}


def gate_resolved(section) -> list:
    """The resolutions that name no registered schedule of their op (or
    still the literal "auto"): the reference's ``_gate_resolved``."""
    from repro_torch.comm.engine import schedules_for

    checks = list(section["resolved"].items()) + [
        ("dp.grads", n) for n in section["dp_grads_resolved_per_bucket"]]
    return [(cs, name) for cs, name in checks
            if name == "auto" or name not in schedules_for(GATE_OPS[cs])]


def production_roofline_section(archs, d=None) -> list:
    """Per arch with an ``ok`` ``train_4k`` single-pod dry-run record in
    ``d`` (default ``results/dryrun_torch``): its roofline terms."""
    from repro_torch.launch.dryrun import RESULTS_DIR

    d = Path(d) if d is not None else RESULTS_DIR
    rows = []
    for arch in archs:
        path = d / f"{arch}__train_4k__single.json"
        if not path.exists():
            continue
        rec = json.loads(path.read_text())
        if rec.get("status") != "ok":
            continue
        rows.append({k: rec[k] for k in (
            "arch", "compute_s", "memory_s", "collective_s", "dominant",
            "useful_ratio", "chips")})
    return rows


def main(quick: bool = False, schedule=None, device=None) -> dict:
    device = resolve_device(device)
    archs = QUICK_ARCHS if quick else list_archs()
    if schedule not in (None, "auto"):
        # a fixed schedule only changes the whole-model section: skip the
        # schedule-invariant per-architecture timings
        archs = []
    record = {"device": device_name(device), "batch": [B, S],
              "not_ported": NOT_PORTED}
    if archs:
        print(f"== LM step bench (reduced configs, {device_name(device)}, "
              "host clock) ==")
    rows = []
    for arch in archs:
        rec = arch_steps(arch, device)
        record[arch] = rec
        rows.append([arch, f"{rec['train_step_s'] * 1e3:.1f}ms",
                     f"{rec['decode_step_s'] * 1e3:.2f}ms",
                     f"{rec['loss']:.3f}"])
    if rows:
        print(table(rows, ["arch", "train_step", "decode_step", "loss"]))

    moe = moe_explicit_section(quick, schedule, device)
    record["moe_explicit"] = moe
    print(f"\n-- explicit vs GSPMD MoE layer ({moe['ranks']} gloo "
          f"processes, {moe['config']}) --")
    print(f"   max|d| {moe['max_abs_err_vs_gspmd']:.2e}  gspmd "
          f"{moe['t_gspmd_s'] * 1e3:.1f}ms  explicit "
          f"{moe['t_explicit_s'] * 1e3:.1f}ms  dp step "
          f"{moe['t_dp_step_s'] * 1e3:.1f}ms  nchunks {moe['nchunks']}")
    print("   resolved: " + " ".join(
        f"{cs}={name}" for cs, name in sorted(moe["resolved"].items())))

    whole = whole_model_section(quick, schedule, device)
    record["whole_model"] = whole
    print(f"\n-- whole-model explicit train step vs the one-rank step "
          f"({whole['ranks']} gloo processes, {whole['config']}) --")
    print(table(
        [[mode, f"{m['t_step_s'] * 1e3:.1f}ms", f"{m['loss']:.4f}",
          f"{m['loss_err_vs_one_rank']:.2e}",
          f"{m['grad_norm_err_vs_one_rank']:.2e}",
          f"{m['max_abs_param_err_vs_one_rank']:.2e}"]
         for mode, m in whole["modes"].items()],
        ["mode", "step", "loss", "|dloss|", "|dgnorm|", "max|dparam|"]))
    print("   resolved: " + " ".join(
        f"{cs}={name}" for cs, name in sorted(whole["resolved"].items())))
    # production roofline per arch (train_4k, single pod) from the dry run
    prod = production_roofline_section(archs or list_archs())
    record["production_roofline"] = prod
    if prod:
        print(f"\n-- production mesh (train_4k, {prod[0]['chips']} ranks) "
              "roofline, dry-run counts --")
        print(table([[r["arch"], f"{r['compute_s']:.3g}",
                      f"{r['memory_s']:.3g}", f"{r['collective_s']:.3g}",
                      r["dominant"], f"{r['useful_ratio']:.1%}"]
                     for r in prod],
                    ["arch", "compute_s", "memory_s", "coll_s", "dominant",
                     "useful"]))
    save_result("lm_step_bench", record)
    bad = gate_resolved(whole) + gate_resolved(moe)
    if bad or not (whole["ranks_agree"] and moe["ranks_agree"]):
        print("UNREGISTERED explicit-path resolutions:", bad,
              "ranks agree:", whole["ranks_agree"], moe["ranks_agree"])
        raise SystemExit(1)
    return record


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--schedule", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(args.quick, args.schedule, args.device)
