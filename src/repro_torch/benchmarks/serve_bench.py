"""Continuous-batching serving benchmark on a ring of processes (reduced
qwen3-moe, ``tiny(n)``).

Port of ``benchmarks/serve_bench.py``.

    python -m repro_torch.benchmarks.serve_bench [--quick]
        [--schedule NAME] [--device cuda|cpu]

Four gloo processes form a ring ``('x',)`` (on one card they share it, and
gloo stages every payload through host memory), each holding the whole
weights (seed 0). Three sections:

* **decode equivalence**: the engine-routed explicit decode step
  (:func:`~repro_torch.train.serve.make_decode_step_explicit`, per-token
  exchanges tagged ``decode.qkv`` / ``decode.out`` / ``decode.moe``)
  against the one-rank paged decode
  (:func:`~repro_torch.train.serve.make_paged_decode_step`) from
  identical pages: max |dlogits| over each rank's rows and max |dpages|
  over each rank's KV share of the pool, per decode step, with the
  per-token step time of both programs (the slowest rank's, from a
  barrier to the drained card) and the bytes staged per rank by callsite;
* **batch sweep**: the explicit :class:`~repro_torch.serve.ServeEngine`
  at ``slots = n`` and ``2n`` (``n`` only with ``--quick``): tokens/s and
  p50/p99 per-token decode latency, with the prefill-token budget low
  enough that the scheduler interleaves prefill with in-flight decode
  (the mixed-step count is recorded);
* **mode comparison**: the same workload through the GSPMD engine on the
  same ring (each rank its slots), tokens/s beside the explicit engine's,
  and whether the two served the same streams.

Every section records the per-callsite resolved schedule at the decode
payloads the explicit step exchanges, never the literal ``"auto"``, and
the module exits 1 if any resolution names an unregistered schedule (the
``--autotune`` gate, ``_gate_resolved``), if the explicit step leaves the
reference's limit (2e-5, ``tests/dist/test_serve.py``) or if the two
engines' streams differ. The times are the host's loopback, not a link
rate. The rank body, :func:`serve_rank`, is a module-level function so
that spawned processes can import it. Writes
``results/bench/torch_serve_bench.json`` at the root of the checkout.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.benchmarks.common import save_result, table
from repro_torch.comm.callsites import DECODE_MOE, DECODE_OUT, DECODE_QKV
from repro_torch.comm.engine import schedules_for
from repro_torch.core.hpcc import device_name, resolve_device
from repro_torch.launch.mesh import spawn_mesh

ARCH = "qwen3-moe-235b-a22b"
RANKS = 4
PAGE = 4
S0 = 5                 # the equivalence section's prompt length
TOL = 2e-5             # tests/dist/test_serve.py: logits and pages, atol
TIMEOUT = 600.0


def resolved_decode(engine, cfg, slots: int, ndev: int):
    """Per-callsite resolutions at the payloads the explicit step
    exchanges (single-token tiles of the rank's rows), and the payloads."""
    from repro_torch.models import moe as MOE

    b_loc = max(slots // ndev, 1)
    qkv_bytes = b_loc * 1 * cfg.num_heads * cfg.head_dim * 4
    moe_bytes = b_loc * cfg.num_experts * MOE._capacity(cfg, 1) \
        * cfg.d_model * 4

    def a2a(nbytes, cs):
        return engine.schedule_for("all_to_all_tiles", nbytes=nbytes,
                                   axis="x", callsite=cs)

    return ({DECODE_QKV: a2a(qkv_bytes, DECODE_QKV),
             DECODE_OUT: a2a(qkv_bytes, DECODE_OUT),
             DECODE_MOE: a2a(moe_bytes, DECODE_MOE)},
            {"qkv_bytes": qkv_bytes, "moe_bytes": moe_bytes})


def gate_resolved(section) -> list:
    """The (callsite, name) resolutions of ``section`` that are
    unregistered or still the literal ``"auto"``."""
    registered = schedules_for("all_to_all_tiles")
    return [(cs, name) for cs, name in (section or {}).get(
        "resolved", {}).items() if name == "auto" or name not in registered]


def _gate_resolved(section) -> None:
    """SystemExit(1) if any decode-path resolution is unregistered: the
    same gate as ``--autotune``."""
    bad = gate_resolved(section)
    if bad:
        print("UNREGISTERED decode-path resolutions:", bad)
        raise SystemExit(1)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prefill_pages(model, params, pcfg, prompts, max_new, device):
    """Dense prefill of each prompt (a batch of one, no mesh) committed
    into a fresh whole pool; returns the pool, the allocator and the first
    greedy token per slot (B, 1). ``prompts``: a (B, S0) tensor or a list
    of 1-D token tensors of any lengths, one per slot."""
    from repro_torch.models import transformer as T
    from repro_torch.models.kvcache import PageAllocator, commit_prefill
    from repro_torch.train.serve import make_prefill_step

    B = len(prompts)
    prefill = make_prefill_step(model, None)
    alloc = PageAllocator(pcfg)
    pages = T.init_paged_cache(model.cfg, pcfg, torch.float32, device)
    first = torch.zeros((B, 1), dtype=torch.int32, device=device)
    for b in range(B):
        prompt = torch.as_tensor(prompts[b]).to(device)
        s0 = prompt.shape[0]
        slot = alloc.allocate(s0 + max_new)
        c1 = model.init_cache(1, s0, torch.float32, device=device)
        lg, c1 = prefill(params, {"tokens": prompt[None]}, c1)
        commit_prefill(pages["layers"], c1["layers"],
                       alloc.block_table[slot], s0,
                       page_size=pcfg.page_size)
        alloc.commit(slot, s0)
        first[slot, 0] = torch.argmax(lg[0, -1])
    return pages, alloc, first


def equivalence_rank(mesh, model, params, schedule, steps: int,
                     device) -> Dict:
    """This rank's decode equivalence: ``steps`` explicit steps against the
    one-rank paged step from identical pages (every rank runs the
    one-rank step on the whole batch beside its own)."""
    import torch.distributed as dist

    from repro_torch.comm.engine import (CollectiveEngine,
                                         reset_staged_bytes,
                                         staged_bytes_by_callsite)
    from repro_torch.models.kvcache import PagedCacheConfig, pool_heads
    from repro_torch.train.serve import (decode_rows, local_params,
                                         make_decode_step_explicit,
                                         make_paged_decode_step)

    cfg = model.cfg
    n = mesh.axis("x").size
    B = n
    pcfg = PagedCacheConfig(page_size=PAGE, max_slots=B, max_seq=S0 + steps,
                            num_pages=B * (-(-(S0 + steps) // PAGE)))
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, S0), generator=gen,
                            dtype=torch.int32).to(device)
    pages_g, alloc, tok = prefill_pages(model, params, pcfg, prompts, steps,
                                        device)
    rows = decode_rows(mesh, B, "x")
    start, count = pool_heads(cfg, mesh, "x")
    pages_e = {"layers": [{k: v.narrow(2, start, count).clone()
                           for k, v in layer.items()}
                          for layer in pages_g["layers"]]}
    engine = CollectiveEngine.for_mesh(mesh, schedule=schedule or "auto")
    pd_g = make_paged_decode_step(model, None)
    pd_e = make_decode_step_explicit(model, mesh, engine=engine,
                                     schedule=schedule)
    mine = local_params(params, mesh, "x")
    logits_err = cache_err = 0.0
    t_g, t_e = [], []
    reset_staged_bytes()
    for _ in range(steps):
        bt, ln = alloc.device_tables(device)
        _sync(device)
        t0 = time.perf_counter()
        lg, pages_g = pd_g(params, tok, pages_g, bt, ln)
        _sync(device)
        t_g.append(time.perf_counter() - t0)
        dist.barrier()
        t0 = time.perf_counter()
        le, pages_e = pd_e(mine, tok[rows], pages_e, bt, ln)
        _sync(device)
        t_e.append(time.perf_counter() - t0)
        logits_err = max(logits_err, float((lg[rows] - le).abs().max()))
        cache_err = max(cache_err, max(
            float((g[k].narrow(2, start, count) - e[k]).abs().max())
            for g, e in zip(pages_g["layers"], pages_e["layers"])
            for k in g))
        for s in range(B):
            alloc.append(s)
        tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
    resolved, payloads = resolved_decode(engine, cfg, B, n)
    return {"slots": B, "steps": steps, "t_gspmd_s": t_g,
            "t_explicit_s": t_e, "max_logits_err": logits_err,
            "max_cache_err": cache_err, "resolved": resolved,
            "staged_per_token": {str(k): v // steps for k, v in
                                 staged_bytes_by_callsite().items()},
            **payloads}


def _workload(rng, cfg, n_requests: int, pmax: int):
    return [rng.integers(0, cfg.vocab_size,
                         size=(int(rng.integers(max(pmax // 2, 1),
                                                pmax + 1)),)).astype(np.int32)
            for _ in range(n_requests)]


def run_engine(model, params, pcfg, prompts, max_new, device, **kw) -> Dict:
    """One engine run: its streams, tokens/s and per-token latencies over
    the steady-state decode steps (the first two carry the warm-up)."""
    import torch.distributed as dist

    from repro_torch.serve import ServeEngine

    eng = ServeEngine(model, params, pcfg, **kw)
    dist.barrier()
    t0 = time.perf_counter()
    out, stats = eng.run(prompts, max_new_tokens=max_new, collect_stats=True)
    _sync(device)
    wall = time.perf_counter() - t0
    dec = [(s["decode_s"], s["decode_tokens"])
           for s in stats if s["decode_tokens"]]
    steady = dec[2:] or dec[1:] or dec
    lat = sorted(t for t, _ in steady)
    return {
        "requests": len(prompts),
        "new_tokens": sum(out[r].shape[0] - p.shape[0]
                          for r, p in enumerate(prompts)),
        "steps": len(stats), "wall_s": wall,
        "mixed_steps": sum(1 for s in stats
                           if s["prefills"] and s["decode_tokens"]),
        "decode_tokens": sum(n for _, n in dec),
        "tok_per_s": sum(n for _, n in steady) / max(sum(lat), 1e-9),
        "first_decode_s": dec[0][0] if dec else 0.0,
        "p50_token_s": lat[len(lat) // 2],
        "p99_token_s": lat[min(int(len(lat) * 0.99), len(lat) - 1)],
        "streams": {r: v.tolist() for r, v in out.items()},
    }


def sweep_rank(mesh, model, params, schedule, quick: bool, device) -> Dict:
    """The batch sweep of the explicit engine and the mode comparison on
    this rank."""
    from repro_torch.comm.engine import CollectiveEngine
    from repro_torch.models.kvcache import PagedCacheConfig

    cfg = model.cfg
    n = mesh.axis("x").size
    engine = CollectiveEngine.for_mesh(mesh, schedule=schedule or "auto")
    pmax, max_new = 8, (4 if quick else 8)
    max_seq = pmax + max_new
    slot_counts = (n,) if quick else (n, 2 * n)

    def pcfg(slots):
        return PagedCacheConfig(page_size=PAGE, max_slots=slots,
                                max_seq=max_seq,
                                num_pages=slots * (-(-max_seq // PAGE)))

    rng = np.random.default_rng(0)
    sweep = {}
    for slots in slot_counts:
        sweep[slots] = run_engine(
            model, params, pcfg(slots), _workload(rng, cfg, 2 * slots, pmax),
            max_new, device, mode="explicit", mesh=mesh, engine=engine,
            schedule=schedule, prefill_token_budget=2 * pmax)
    slots = slot_counts[0]
    prompts = _workload(np.random.default_rng(0), cfg, 2 * slots, pmax)
    gspmd = run_engine(model, params, pcfg(slots), prompts, max_new, device,
                       mode="gspmd", mesh=mesh,
                       prefill_token_budget=2 * pmax)
    resolved, payloads = resolved_decode(engine, cfg, slots, n)
    return {"max_new": max_new, "sweep": sweep, "gspmd": gspmd,
            "resolved": resolved, **payloads}


def serve_rank(mesh, schedule: Optional[str], quick: bool, device) -> Dict:
    """Runs on every rank of the ring: both sections, the whole weights of
    ``tiny(n)`` drawn from seed 0 on ``device``."""
    from repro_torch.configs.qwen3_moe_235b_a22b import tiny
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(0)
    n = mesh.axis("x").size
    model = build_model(tiny(n))
    params = model.init(0, device=device)
    ops.reset_launch_counts()
    eq = equivalence_rank(mesh, model, params, schedule, 3 if quick else 4,
                          device)
    sw = sweep_rank(mesh, model, params, schedule, quick, device)
    return {"equivalence": eq, "sweep": sw,
            "launches": ops.launch_counts(), "device": str(device)}


def record_of(per_rank, schedule) -> Dict:
    """The sections' records from every rank's :func:`serve_rank`: the
    slowest rank's times, the largest errors, rank 0's resolutions."""
    first = per_rank[0]
    eqs = [r["equivalence"] for r in per_rank]
    e0 = eqs[0]
    steps = e0["steps"]
    # steady state: the first step carries the warm-up
    t_g = min(max(e["t_gspmd_s"][i] for e in eqs) for i in range(1, steps))
    t_e = min(max(e["t_explicit_s"][i] for e in eqs)
              for i in range(1, steps))
    logits_err = max(e["max_logits_err"] for e in eqs)
    cache_err = max(e["max_cache_err"] for e in eqs)
    requested = schedule or "auto"
    eq = {"arch": ARCH, "devices": len(per_rank), "slots": e0["slots"],
          "steps": steps, "schedule": e0["resolved"][DECODE_QKV],
          "schedule_requested": requested, "t_gspmd_s": t_g,
          "t_explicit_s": t_e, "time": t_e,
          "max_logits_err": logits_err, "max_cache_err": cache_err,
          "tolerance": TOL,
          "within_tolerance": logits_err <= TOL and cache_err <= TOL,
          "resolved": e0["resolved"],
          "staged_bytes_per_rank_per_token": e0["staged_per_token"],
          "qkv_bytes": e0["qkv_bytes"], "moe_bytes": e0["moe_bytes"],
          "device": first["device"]}
    s0 = first["sweep"]
    sweep = {}
    for slots, row in s0["sweep"].items():
        rows = [r["sweep"]["sweep"][slots] for r in per_rank]
        sweep[str(slots)] = {k: v for k, v in row.items() if k != "streams"}
        sweep[str(slots)]["p50_token_s"] = max(r["p50_token_s"] for r in rows)
        sweep[str(slots)]["p99_token_s"] = max(r["p99_token_s"] for r in rows)
        sweep[str(slots)]["tok_per_s"] = min(r["tok_per_s"] for r in rows)
    first_slots = next(iter(s0["sweep"]))
    explicit_streams = s0["sweep"][first_slots]["streams"]
    g = s0["gspmd"]
    return {
        "decode_equivalence": eq,
        "batch_sweep": {
            "arch": ARCH, "devices": len(per_rank),
            "max_new": s0["max_new"],
            "schedule": s0["resolved"][DECODE_QKV],
            "schedule_requested": requested,
            "time": sweep[str(first_slots)]["p50_token_s"],
            "sweep": sweep,
            "gspmd": {k: v for k, v in g.items() if k != "streams"},
            "modes_token_identical": g["streams"] == explicit_streams,
            "ranks_agree": all(
                r["sweep"]["gspmd"]["streams"] == g["streams"]
                and all(r["sweep"]["sweep"][s]["streams"]
                        == s0["sweep"][s]["streams"] for s in s0["sweep"])
                for r in per_rank),
            "resolved": s0["resolved"], "qkv_bytes": s0["qkv_bytes"],
            "moe_bytes": s0["moe_bytes"]},
        "launches_per_rank": [r["launches"] for r in per_rank],
    }


def main(quick: bool = False, schedule=None, device=None) -> dict:
    device = resolve_device(device)
    per_rank = spawn_mesh(RANKS, serve_rank, schedule, quick, str(device),
                          axes=("x",), timeout=TIMEOUT)
    record = record_of(per_rank, schedule)
    record["device"] = device_name(device)
    eq, sw = record["decode_equivalence"], record["batch_sweep"]
    print(f"-- explicit vs one-rank paged decode (engine-routed; "
          f"{eq['devices']} gloo processes, {record['device']}) --")
    print(table(
        [[eq["arch"], eq["slots"], f"{eq['t_gspmd_s'] * 1e3:.1f}ms",
          f"{eq['t_explicit_s'] * 1e3:.1f}ms",
          f"{eq['max_logits_err']:.2e}", f"{eq['max_cache_err']:.2e}"]],
        ["arch", "slots", "one-rank/tok", "explicit/tok", "max|dlogits|",
         "max|dcache|"]))
    print("   resolved: " + " ".join(
        f"{cs}={name}" for cs, name in sorted(eq["resolved"].items())))
    print("   staged bytes per rank per token: "
          + " ".join(f"{cs}={b}" for cs, b in sorted(
              eq["staged_bytes_per_rank_per_token"].items())))
    print("\n-- continuous batching: tokens/s and per-token latency vs "
          "batch size (explicit decode) --")
    rows = [[slots, r["requests"], r["mixed_steps"], f"{r['tok_per_s']:.1f}",
             f"{r['p50_token_s'] * 1e3:.2f}ms",
             f"{r['p99_token_s'] * 1e3:.2f}ms"]
            for slots, r in sw["sweep"].items()]
    g = sw["gspmd"]
    rows.append([f"{list(sw['sweep'])[0]} (gspmd)", g["requests"],
                 g["mixed_steps"], f"{g['tok_per_s']:.1f}",
                 f"{g['p50_token_s'] * 1e3:.2f}ms",
                 f"{g['p99_token_s'] * 1e3:.2f}ms"])
    print(table(rows, ["slots", "reqs", "mixed", "tok/s", "p50/tok",
                       "p99/tok"]))
    print(f"   modes token-identical={sw['modes_token_identical']} "
          f"ranks agree={sw['ranks_agree']}; the times are the host's "
          "loopback, not a link rate")
    save_result("serve_bench", record)
    _gate_resolved(eq)
    _gate_resolved(sw)
    bad = []
    if not eq["within_tolerance"]:
        bad.append(f"explicit decode {eq['max_logits_err']:.2e} / "
                   f"{eq['max_cache_err']:.2e} from the one-rank step, "
                   f"beyond {TOL}")
    if not (sw["modes_token_identical"] and sw["ranks_agree"]):
        bad.append("the explicit and GSPMD engines served different "
                   "streams")
    if bad:
        print("SERVE GATE FAILED:", bad)
        raise SystemExit(1)
    return record


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--schedule", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(args.quick, args.schedule, args.device)
