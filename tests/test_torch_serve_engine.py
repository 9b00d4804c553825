"""The port's continuous-batching engine on the CPU, held against the
reference engine: the engine tests of ``tests/test_kvcache.py`` (each also
compares the port's streams with the reference engine's on the same
weights), the rank-loss drain, every attention-only family through the
paged engine, the launcher and its fault flags, and resilience_bench's
serve-degradation section.

The weights are the reference's JAX init moved across with
``from_reference``; prompts come from numpy seeds. Greedy streams must be
equal token for token.
"""
from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.comm import faults as jfaults
from repro.launch.mesh import make_mesh
from repro.launch.train import parse_fault_args as jparse_fault_args
from repro.models import kvcache as jkv
from repro.models.model import build_model as jbuild_model
from repro.serve import ServeEngine as JServeEngine
from repro.serve import engine as jengine
from repro_torch import configs
from repro_torch.benchmarks import resilience_bench
from repro_torch.comm import faults
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch
from repro_torch.launch.mesh import single_rank_mesh
from repro_torch.launch.train import parse_fault_args
from repro_torch.models.kvcache import OutOfPagesError, PagedCacheConfig
from repro_torch.models.model import build_model, from_reference
from repro_torch.serve import SERVE_MODES, Request, ServeEngine
from repro_torch.serve import engine as engine_mod
from repro_torch.train import serve


def _jcfg(cfg):
    return jconfigs.ModelConfig(**dataclasses.asdict(cfg))


def _both(cfg):
    jmodel = jbuild_model(_jcfg(cfg))
    jparams = jmodel.init(jax.random.key(0))
    params = from_reference(cfg, jax.tree.map(np.asarray, jparams),
                            device="cpu")
    return build_model(cfg), params, jmodel, jparams


@pytest.fixture(scope="module")
def setup():
    cfg = configs.reduced(configs.get_config("llama3.2-3b"), layers=2,
                          d_model=32)
    return (cfg, *_both(cfg))


def _pair(setup, geometry, **kw):
    """The port's and the reference's engine on the same weights."""
    cfg, model, params, jmodel, jparams = setup
    return (ServeEngine(model, params, PagedCacheConfig(**geometry), **kw),
            JServeEngine(jmodel, jparams, jkv.PagedCacheConfig(**geometry),
                         **kw))


def _equal_streams(got, want):
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


def _prompts(cfg, seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
            for n in lengths]


def test_serve_engine_matches_generate(setup, monkeypatch):
    """Continuous batching (shared pool, slot churn, mixed steps) is
    token-exact against the whole-batch ``generate`` and against the
    reference engine, never beyond its slots, and launches no kernel (the
    prefill has no mesh, C7)."""
    cfg, model, params, _, _ = setup
    prompts = _prompts(cfg, 3, (5, 9, 3, 12))
    geometry = dict(page_size=4, num_pages=16, max_slots=2, max_seq=32)
    eng, jeng = _pair(setup, geometry, prefill_token_budget=12)
    calls = []
    orig = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    out, stats = eng.run(prompts, max_new_tokens=5, collect_stats=True)
    assert calls == []
    assert max(s["active"] for s in stats) <= 2
    _equal_streams(out, jeng.run(prompts, max_new_tokens=5))
    for rid, prompt in enumerate(prompts):
        ref = serve.generate(model, params, torch.from_numpy(prompt[None]),
                             max_new_tokens=5)
        np.testing.assert_array_equal(ref[0].numpy(), out[rid])


def test_serve_engine_eos_recycles_early(setup):
    cfg = setup[0]
    (prompt,) = _prompts(cfg, 4, (6,))
    geometry = dict(page_size=4, num_pages=8, max_slots=1, max_seq=16)
    free = _pair(setup, geometry)[0].run([prompt], max_new_tokens=6)
    eos = int(free[0][7])  # the 2nd generated token

    eng, jeng = _pair(setup, geometry, eos_id=eos)
    rid = eng.submit(prompt, max_new_tokens=6)
    jeng.submit(prompt, max_new_tokens=6)
    out = eng.run()
    assert out[rid].shape[0] < prompt.shape[0] + 6  # stopped at EOS
    assert out[rid][-1] == eos
    assert eng.alloc.free_slot_count == 1  # slot recycled
    _equal_streams(out, jeng.run())


def test_serve_engine_rejects_impossible_request(setup):
    geometry = dict(page_size=4, num_pages=2, max_slots=1, max_seq=16)
    eng, jeng = _pair(setup, geometry)  # a pool of 8 tokens
    for e, err in ((eng, OutOfPagesError), (jeng, jkv.OutOfPagesError)):
        with pytest.raises(err, match="never be admitted"):
            e.submit(np.zeros((8,), np.int32), max_new_tokens=4)  # 12
        assert not e.scheduler.has_work


def test_serve_engine_idle_pool_raise_via_scheduler_bypass(setup):
    from repro.serve import Request as JRequest
    geometry = dict(page_size=4, num_pages=2, max_slots=1, max_seq=16)
    eng, jeng = _pair(setup, geometry)
    for e, req, err in ((eng, Request, OutOfPagesError),
                        (jeng, JRequest, jkv.OutOfPagesError)):
        e.scheduler.submit(req(rid=0, prompt=np.zeros((8,), np.int32),
                               max_new_tokens=4))
        with pytest.raises(err, match="pool is idle yet too small"):
            e.run()


def test_serve_engine_mode_validation(setup):
    cfg, model, params, _, _ = setup
    pcfg = PagedCacheConfig(page_size=4, num_pages=8, max_slots=3,
                            max_seq=16)
    with pytest.raises(ValueError, match="unknown serve mode"):
        ServeEngine(model, params, pcfg, mode="speculative")
    with pytest.raises(ValueError, match="requires a mesh"):
        ServeEngine(model, params, pcfg, mode="explicit")
    assert SERVE_MODES == jengine.SERVE_MODES == ("gspmd", "explicit")


def test_serve_engine_explicit_mode_raises_naming_a12_a13(setup):
    """The reference's validation first (slots divisible by the axis);
    past it the explicit engine builds (the name is kept from when it
    raised naming A12 and A13) and, on a one-rank axis, serves the GSPMD
    engine's streams token for token."""
    cfg, model, params, _, _ = setup
    pcfg = PagedCacheConfig(page_size=4, num_pages=8, max_slots=3,
                            max_seq=16)

    class Wide:
        shape = {"x": 2}

    with pytest.raises(ValueError, match="divisible"):
        ServeEngine(model, params, pcfg, mode="explicit", mesh=Wide())
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (3, 5, 4)]
    want = ServeEngine(model, params, pcfg).run(prompts, max_new_tokens=4)
    got = ServeEngine(model, params, pcfg, mode="explicit",
                      mesh=single_rank_mesh(("x",))).run(prompts,
                                                         max_new_tokens=4)
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


@pytest.mark.parametrize("n,hi", [(5, None), (12, 16), (12, 20), (17, 20),
                                  (21, 20)])
def test_bucket_clamps_to_max_context(n, hi):
    try:
        want = jengine._bucket(n, hi=hi)
    except ValueError:
        with pytest.raises(ValueError, match="max context"):
            engine_mod._bucket(n, hi=hi)
        return
    assert engine_mod._bucket(n, hi=hi) == want


def test_serve_preemption_zero_lost_tokens(setup):
    """Under page exhaustion the engine evicts the youngest active request
    and re-prefills it later: token-exact against a pool that never had to
    preempt, and against the reference's preempting engine."""
    cfg = setup[0]
    pa, pb = _prompts(cfg, 7, (4, 4))
    big = _pair(setup, dict(page_size=4, num_pages=16, max_slots=2,
                            max_seq=16))[0]
    big.submit(pa, max_new_tokens=8)
    big.submit(pb, max_new_tokens=4)
    ref = big.run()
    # 4 pages: A (4+8 -> 3 pages) and B (4+4 -> 2 pages) cannot coexist
    small, jsmall = _pair(setup, dict(page_size=4, num_pages=4, max_slots=2,
                                      max_seq=16), preempt=True)
    for e in (small, jsmall):
        e.submit(pa, max_new_tokens=8)
        e.submit(pb, max_new_tokens=4)
    out, stats = small.run(collect_stats=True)
    assert small.scheduler.preempted_total >= 1
    assert sum(s["preempted"] for s in stats) == \
        small.scheduler.preempted_total
    _equal_streams(out, ref)
    jout, jstats = jsmall.run(collect_stats=True)
    _equal_streams(out, jout)
    assert [s["preempted"] for s in stats] == [s["preempted"]
                                               for s in jstats]


def test_serve_preemption_bounded_per_request(setup):
    """No request is evicted past max_preemptions (the livelock guard)."""
    cfg = setup[0]
    prompts = _prompts(cfg, 8, (4, 4, 4))
    eng, jeng = _pair(setup, dict(page_size=4, num_pages=4, max_slots=2,
                                  max_seq=16), preempt=True)
    rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
    for p in prompts:
        jeng.submit(p, max_new_tokens=8)
    out = eng.run()
    assert eng.scheduler.max_preemptions == 1
    assert set(out) == set(rids)
    assert all(out[r].shape[0] == 4 + 8 for r in rids)  # nobody lost tokens
    _equal_streams(out, jeng.run())
    assert eng.scheduler.preempted_total == jeng.scheduler.preempted_total


def test_serve_deadline_timeout_waiting_and_active(setup):
    cfg = setup[0]
    (prompt,) = _prompts(cfg, 9, (4,))
    # expires while waiting: the deadline check runs before admission
    eng = _pair(setup, dict(page_size=4, num_pages=8, max_slots=3,
                            max_seq=16))[0]
    eng.submit(prompt, max_new_tokens=4, deadline_s=1e-9)
    req = eng.scheduler.waiting[0]
    time.sleep(0.01)
    stats = eng.step()
    assert req.done and req.finish_reason == "timeout"
    assert stats["timeouts"] == 1 and req.generated == []

    # expires mid-decode: the partial generation is kept, the slot recycles
    eng2, jeng2 = _pair(setup, dict(page_size=4, num_pages=32, max_slots=3,
                                    max_seq=128))
    eng2.submit(prompt, max_new_tokens=64, deadline_s=0.05)
    req2 = eng2.scheduler.waiting[0]
    eng2.step()  # admit + prefill + first decode
    assert req2.slot is not None
    time.sleep(0.06)
    eng2.step()
    assert req2.done and req2.finish_reason == "timeout"
    assert 0 < len(req2.generated) < 64
    assert req2.slot is None and eng2.alloc.free_slot_count == 3
    # what it kept is the start of the reference's stream
    jeng2.submit(prompt, max_new_tokens=64)
    want = jeng2.run()[0][prompt.shape[0]:]
    np.testing.assert_array_equal(req2.generated,
                                  want[:len(req2.generated)])


def test_serve_bounded_retry_rejects_head(setup):
    """A head that cannot be admitted within admission_retries attempts is
    finished with reason 'rejected' instead of blocking forever."""
    cfg = setup[0]
    pa, pb = _prompts(cfg, 10, (4, 4))
    eng, jeng = _pair(setup, dict(page_size=4, num_pages=8, max_slots=1,
                                  max_seq=16), admission_retries=2)
    for e in (eng, jeng):
        e.submit(pa, max_new_tokens=12)  # holds the only slot 12 steps
        e.submit(pb, max_new_tokens=4)
    reqb = eng.scheduler.waiting[1]
    out, stats = eng.run(collect_stats=True)
    assert reqb.finish_reason == "rejected"
    assert sum(s["rejected"] for s in stats) == 1
    assert out[0].shape[0] == 4 + 12  # the active stream was untouched
    np.testing.assert_array_equal(out[1], pb)  # rejected: prompt only
    _equal_streams(out, jeng.run())


def test_rank_loss_drains_like_the_reference(setup):
    """``FaultSchedule.rank_loss`` on the port's engine with a one-rank
    mesh gives the reference engine's streams and ``drained`` counts on
    ``make_mesh((1,), ("x",))``: every active request is re-queued with
    its tokens and re-prefilled."""
    cfg, model, params, jmodel, jparams = setup
    prompts = _prompts(cfg, 11, (4, 6, 5))
    geometry = dict(page_size=4, num_pages=16, max_slots=4, max_seq=16)
    eng = ServeEngine(model, params, PagedCacheConfig(**geometry),
                      mesh=single_rank_mesh(("x",)), preempt=True,
                      fault_schedule=faults.FaultSchedule.rank_loss(
                          faults.FaultInjector(), 3, rank=0))
    jeng = JServeEngine(jmodel, jparams, jkv.PagedCacheConfig(**geometry),
                        mesh=make_mesh((1,), ("x",)), preempt=True,
                        fault_schedule=jfaults.FaultSchedule.rank_loss(
                            jfaults.FaultInjector(), 3, rank=0))
    for e in (eng, jeng):
        for p in prompts:
            e.submit(p, 8)
    out, stats = eng.run(collect_stats=True)
    jout, jstats = jeng.run(collect_stats=True)
    drained = [s["drained"] for s in stats]
    assert drained == [s["drained"] for s in jstats]
    assert sum(drained) == len(prompts)  # all three were active at step 3
    _equal_streams(out, jout)


# ---------------------------------------------------------------------------
# every attention-only family through the paged engine
# ---------------------------------------------------------------------------

FAMILIES = {"gqa": ("llama3.2-3b", 2), "qk-norm": ("llama3.2-3b", 2),
            "qwen3-moe": ("qwen3-moe-235b-a22b", 2),
            "maverick": ("llama4-maverick-400b-a17b", 2),
            "vlm": ("llama-3.2-vision-90b", 4)}


@pytest.mark.parametrize("kind", list(FAMILIES))
def test_every_attention_only_family_through_the_engine(kind):
    """Streams equal to the reference engine's. The vlm engine gets no
    patch embeddings, so its cross layers are skipped, as in the
    reference."""
    arch, layers = FAMILIES[kind]
    cfg = configs.reduced(configs.get_config(arch), layers=layers,
                          d_model=32)
    if kind == "gqa":
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
    if kind == "qk-norm":
        cfg = dataclasses.replace(cfg, use_qk_norm=True)
    assert launch.paged_ok(cfg)  # attention-only
    model, params, jmodel, jparams = _both(cfg)
    prompts = _prompts(cfg, 12, (6, 3, 7))  # one prefill bucket
    geometry = dict(page_size=4, num_pages=12, max_slots=2, max_seq=16)
    out = ServeEngine(model, params, PagedCacheConfig(**geometry),
                      prefill_token_budget=8).run(prompts, max_new_tokens=5)
    jout = JServeEngine(jmodel, jparams, jkv.PagedCacheConfig(**geometry),
                        prefill_token_budget=8).run(prompts,
                                                    max_new_tokens=5)
    _equal_streams(out, jout)


# ---------------------------------------------------------------------------
# the launcher, its fault flags, and the serve-degradation section
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_paged_ok_matches_reference(arch):
    cfg = configs.reduced(configs.get_config(arch))
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    want = (not jcfg.is_encoder_decoder
            and all(k == "attn" for k in jcfg.layer_kinds()))
    assert launch.paged_ok(cfg) == want


@pytest.mark.parametrize("spec,fail_rank", [
    (None, None), ("delay@5-20:seconds=0.05,callsite=serve.step", None),
    (None, "3@7"), ("down@2-4:axis=x,hop=1", "0@1")])
def test_parse_fault_args_matches_reference(spec, fail_rank):
    got, want = parse_fault_args(spec, fail_rank), jparse_fault_args(
        spec, fail_rank)
    if want is None:
        assert got is None
        return
    assert [dataclasses.asdict(e) for e in got.events] == \
        [dataclasses.asdict(e) for e in want.events]


def test_parse_fault_args_refuses_a_bad_rank():
    for fn in (parse_fault_args, jparse_fault_args):
        with pytest.raises(SystemExit, match="RANK@STEP"):
            fn(None, "three")


@pytest.mark.parametrize("arch,legacy", [
    ("llama3-8b", False), ("llama3-8b", True), ("whisper-base", False),
    ("llama-3.2-vision-90b", True), ("mamba2-130m", False)])
def test_launcher_serves_on_the_cpu(arch, legacy, capsys):
    """``python -m repro_torch.launch.serve`` with ``--device cpu``: the
    paged engine for attention-only decoders, ``generate`` otherwise or
    with ``--legacy``; every request gets its tokens."""
    argv = ["--arch", arch, "--requests", "3", "--prompt-len", "8",
            "--max-new", "4", "--device", "cpu", "--preempt"]
    out = launch.main(argv + (["--legacy"] if legacy else []))
    text = capsys.readouterr().out
    cfg = configs.reduced(configs.get_config(arch))
    if legacy or not launch.paged_ok(cfg):
        assert "[legacy generate]" in text and tuple(out.shape) == (3, 12)
    else:
        assert "mode=gspmd" in text and len(out) == 3
        assert all(4 + 4 <= o.shape[0] <= 8 + 4 for o in out.values())


def test_launcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        launch.main(["--arch", "llama3-8b"])


def test_serve_degradation_section_passes_its_gate():
    """resilience_bench's serve section at the reference's geometry: a
    4-page pool that must preempt, under a host delay, token-identical to
    a 16-page pool."""
    sec = resilience_bench.serve_degradation_section("cpu")
    assert resilience_bench.gate_serve_degradation(sec) == []
    assert sec["preempted"] >= 1 and sec["tokens_lost"] == 0
    bad = dict(sec, token_identical=False, tokens_lost=2, preempted=0)
    assert len(resilience_bench.gate_serve_degradation(bad)) == 2
