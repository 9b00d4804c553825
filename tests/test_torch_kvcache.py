"""The port's paged KV cache on the CPU, held against the reference: specs,
the host-side page allocator, ``gather_pages`` / ``commit_prefill``,
scheduler admission, and the paged decode step.

Every test of ``tests/test_kvcache.py`` up to the engine has a counterpart
here that runs the same calls on both packages and compares what they
return (the engine's are in ``tests/test_torch_serve_engine.py``).
Gathers and commits are pure data movement and must agree bit for bit;
the paged decode's logits agree within 1e-5 and its pools bit for bit
with the reference's scatter rule applied to the port's own token k/v.
The block table's sentinel (``num_pages``) is where torch indexing
differs from ``jnp``'s clip and drop modes: the sentinel tests run with
inactive slots and a slot whose length fills its last page.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import kvcache as jkv
from repro.models import transformer as jT
from repro.models.model import build_model as jbuild_model
from repro.serve import Request as JRequest
from repro.serve import Scheduler as JScheduler
from repro.train import serve as jserve
from repro_torch import configs
from repro_torch.models import kvcache as kv
from repro_torch.models import transformer as T
from repro_torch.models.model import build_model, from_reference
from repro_torch.serve import Request, Scheduler
from repro_torch.train import serve

ATOL = 1e-5


def _jcfg(cfg):
    return jconfigs.ModelConfig(**dataclasses.asdict(cfg))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pcfg(**kw):
    base = dict(page_size=4, num_pages=8, max_slots=3, max_seq=16)
    base.update(kw)
    return kv.PagedCacheConfig(**base), jkv.PagedCacheConfig(**base)


@pytest.fixture(scope="module")
def setup():
    cfg = configs.reduced(configs.get_config("llama3.2-3b"), layers=2,
                          d_model=32)
    jmodel = jbuild_model(_jcfg(cfg))
    jparams = jmodel.init(jax.random.key(0))
    params = from_reference(cfg, jax.tree.map(np.asarray, jparams),
                            device="cpu")
    return cfg, build_model(cfg), params, jmodel, jparams


# -- dense specs -----------------------------------------------------------


def test_dense_cache_specs():
    cfg = configs.reduced(configs.get_config("llama3.2-3b"))
    spec = kv.attn_cache_spec(cfg, 3, 16, torch.bfloat16)
    want = jkv.attn_cache_spec(_jcfg(cfg), 3, 16, jnp.bfloat16)
    assert spec["k"].shape == want["k"].shape == (3, 16, cfg.num_kv_heads,
                                                  cfg.head_dim)
    assert spec["v"].dtype == torch.bfloat16

    mcfg = configs.reduced(configs.get_config("mamba2-130m"))
    sspec = kv.ssm_cache_spec(mcfg, 2, torch.float32)
    jspec = jkv.ssm_cache_spec(_jcfg(mcfg), 2, jnp.float32)
    for name in jspec:
        assert tuple(sspec[name].shape) == jspec[name].shape
    assert sspec["conv_x"].shape[1] == mcfg.ssm_conv - 1
    assert sspec["state"].dtype == torch.float32  # SSD state stays fp32


def test_paged_spec_shapes():
    cfg = configs.reduced(configs.get_config("llama3.2-3b"))
    pcfg, jpcfg = _pcfg(page_size=4, num_pages=10, max_slots=2, max_seq=13)
    spec = kv.paged_attn_cache_spec(cfg, pcfg, torch.bfloat16)
    want = jkv.paged_attn_cache_spec(_jcfg(cfg), jpcfg, jnp.bfloat16)
    assert spec["k_pages"].shape == want["k_pages"].shape == \
        (10, 4, cfg.num_kv_heads, cfg.head_dim)
    assert spec["v_pages"].dtype == torch.bfloat16
    assert pcfg.pages_per_slot == jpcfg.pages_per_slot == 4


@pytest.mark.parametrize("geometry", [
    dict(page_size=0, num_pages=8, max_slots=2, max_seq=8),
    dict(page_size=4, num_pages=8, max_slots=-1, max_seq=8)])
def test_paged_config_validation(geometry):
    for mod in (kv, jkv):
        with pytest.raises(ValueError, match="non-positive"):
            mod.PagedCacheConfig(**geometry)


def test_init_paged_cache_matches_reference():
    """Per-layer pools of the reference's per-super-block shape; SSM and
    hybrid models are refused by both."""
    cfg = configs.reduced(configs.get_config("llama-3.2-vision-90b"))
    pcfg, jpcfg = _pcfg()
    pages = T.init_paged_cache(cfg, pcfg, torch.float32, device="cpu")
    jpages = jT.init_paged_cache(_jcfg(cfg), jpcfg, jnp.float32)
    assert "pos" not in pages and len(pages["layers"]) == cfg.num_layers
    period = T.period_of(cfg)
    for i, layer in enumerate(pages["layers"]):
        want = jpages["layers"][f"p{i % period}"]
        assert {k: tuple(v.shape) for k, v in layer.items()} == \
            {k: v.shape[1:] for k, v in want.items()}
    for arch in ("mamba2-130m", "jamba-1.5-large-398b"):
        scfg = configs.reduced(configs.get_config(arch), layers=8)
        with pytest.raises(ValueError, match="attention-only"):
            T.init_paged_cache(scfg, pcfg)
        with pytest.raises(ValueError, match="attention-only"):
            jT.init_paged_cache(_jcfg(scfg), jpcfg)


# -- allocator: every call on both, every state compared --------------------


def _same_state(a, b):
    np.testing.assert_array_equal(a.block_table, b.block_table)
    np.testing.assert_array_equal(a.seq_lens, b.seq_lens)
    assert (a.free_page_count, a.free_slot_count) == \
        (b.free_page_count, b.free_slot_count)


def _both(pcfgs):
    pcfg, jpcfg = pcfgs
    return kv.PageAllocator(pcfg), jkv.PageAllocator(jpcfg)


def test_allocate_append_release_roundtrip():
    allocs = _both(_pcfg())
    for alloc, mod in zip(allocs, (kv, jkv)):
        s = alloc.allocate(10)  # 3 pages
        assert alloc.free_page_count == 5
        row = alloc.block_table[s]
        assert (row[:3] < 8).all() and (row[3:] == 8).all()  # sentinel tail
        alloc.commit(s, 6)
        for _ in range(4):
            alloc.append(s)
        assert alloc.seq_lens[s] == 10
        alloc.append(s, 2)  # 3 pages = 12 tokens: 2 more fit, not 3
        with pytest.raises(mod.OutOfPagesError):
            alloc.append(s)
    _same_state(*allocs)
    for alloc in allocs:
        alloc.release(0)
        assert alloc.free_page_count == 8 and alloc.free_slot_count == 3
        assert (alloc.block_table[0] == 8).all() and alloc.seq_lens[0] == 0
    _same_state(*allocs)


def test_allocator_exhaustion_and_recycle():
    allocs = _both(_pcfg())  # 8 pages
    held = []
    for alloc, mod in zip(allocs, (kv, jkv)):
        a = alloc.allocate(16)  # 4 pages
        b = alloc.allocate(16)  # 4 pages -> pool empty
        assert not alloc.can_allocate(4)
        with pytest.raises(mod.OutOfPagesError):
            alloc.allocate(4)
        alloc.release(a)
        assert alloc.can_allocate(16)
        c = alloc.allocate(16)
        assert c != b and alloc.free_page_count == 0
        held.append((b, c))
    _same_state(*allocs)
    for alloc, mod, (b, c) in zip(allocs, (kv, jkv), held):
        alloc.release(b), alloc.release(c)
        for _ in range(3):  # all three slots busy, pages to spare
            alloc.allocate(4)
        assert not alloc.can_allocate(4)
        with pytest.raises(mod.OutOfPagesError):
            alloc.allocate(4)
    _same_state(*allocs)


def test_allocate_validates_max_seq():
    for alloc in _both(_pcfg()):
        with pytest.raises(ValueError):
            alloc.allocate(17)  # > max_seq
        with pytest.raises(ValueError):
            alloc.allocate(0)
        s = alloc.allocate(4)
        with pytest.raises(ValueError):
            alloc.commit(s, 5)  # past the single reserved page


def test_device_tables_are_int32_copies():
    alloc = kv.PageAllocator(_pcfg()[0])
    s = alloc.allocate(9)
    alloc.commit(s, 7)
    bt, lens = alloc.device_tables("cpu")
    jbt, jlens = jkv.PageAllocator(_pcfg()[1]).device_tables()
    assert bt.dtype == lens.dtype == torch.int32
    assert tuple(bt.shape) == jbt.shape and tuple(lens.shape) == jlens.shape
    np.testing.assert_array_equal(bt.numpy(), alloc.block_table)
    alloc.append(s)  # the tables are snapshots, not views
    assert int(lens[s]) == 7


# -- gather / commit: pure data movement, bit for bit -----------------------


def test_gather_pages_roundtrip():
    rng = np.random.default_rng(0)
    pages = rng.standard_normal((8, 4, 2, 3)).astype(np.float32)
    bt = np.asarray([[5, 1, 8, 8], [0, 8, 8, 8]], np.int32)
    g = kv.gather_pages(torch.from_numpy(pages), torch.from_numpy(bt))
    want = np.asarray(jkv.gather_pages(jnp.asarray(pages), jnp.asarray(bt)))
    assert tuple(g.shape) == want.shape == (2, 16, 2, 3)
    np.testing.assert_array_equal(g.numpy(), want)  # sentinels clip alike
    np.testing.assert_array_equal(g[0, :4].numpy(), pages[5])
    np.testing.assert_array_equal(g[0, 4:8].numpy(), pages[1])
    np.testing.assert_array_equal(g[1, :4].numpy(), pages[0])


def _prefill_both(setup, toks):
    cfg, model, params, jmodel, jparams = setup
    S = toks.shape[1]
    cache = model.init_cache(1, S, torch.float32, device="cpu")
    _, cache = serve.make_prefill_step(model)(
        params, {"tokens": torch.from_numpy(toks)}, cache)
    jcache = jmodel.init_cache(1, S, jnp.float32)
    _, jcache = jserve.make_prefill_step(jmodel, None)(
        jparams, {"tokens": jnp.asarray(toks)}, jcache)
    return cache, jcache


def test_commit_prefill_roundtrip(setup):
    """The reference's test (pad positions drop, the prefix lands in the
    reserved pages) on the port's own prefill, and the port's commit bit
    for bit the reference's on the same dense cache."""
    cfg = setup[0]
    pcfg, jpcfg = _pcfg(max_seq=12)
    alloc = kv.PageAllocator(pcfg)
    slot = alloc.allocate(9)
    row = alloc.block_table[slot]
    S0, Spad = 6, 8  # prefill padded past the true length
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, Spad)).astype(np.int32)
    dense, jdense = _prefill_both(setup, toks)

    pages = T.init_paged_cache(cfg, pcfg, torch.float32, device="cpu")
    out = kv.commit_prefill(pages["layers"], dense["layers"], row, S0,
                            page_size=pcfg.page_size)
    assert out is pages["layers"]
    for layer, d in zip(out, dense["layers"]):
        g = kv.gather_pages(layer["k_pages"], torch.from_numpy(row)[None])
        np.testing.assert_array_equal(g[0, :S0].numpy(),
                                      d["k"][0, :S0].numpy())
        assert not g[0, S0:].any()  # pad positions dropped: pages stay zero

    # bit for bit the reference's commit of the same (port) dense cache
    jpages = jT.init_paged_cache(_jcfg(cfg), jpcfg, jnp.float32)
    stacked = {"p0": {n: jnp.stack([jnp.asarray(d[n].numpy())
                                    for d in dense["layers"]])
                      for n in ("k", "v")}}
    want = jkv.commit_prefill(jpages["layers"], stacked, jnp.asarray(row),
                              S0, page_size=pcfg.page_size)
    for i, layer in enumerate(out):
        for name in ("k_pages", "v_pages"):
            np.testing.assert_array_equal(
                layer[name].numpy(), np.asarray(want["p0"][name][i]))
    # and the reference's own prefill committed: within the LM tolerance
    jout = jkv.commit_prefill(jpages["layers"], jdense["layers"],
                              jnp.asarray(row), S0, page_size=pcfg.page_size)
    for i, layer in enumerate(out):
        np.testing.assert_allclose(layer["k_pages"].numpy(),
                                   _np(jout["p0"]["k_pages"][i]), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("length", [12, 16], ids=["past_reservation",
                                                  "whole_row"])
def test_commit_prefill_drops_sentinel_positions(length):
    """Positions inside ``length`` whose block-table entry is the sentinel
    drop too (no index reaches past the pool), as the reference's scatter
    drops them."""
    rng = np.random.default_rng(2)
    pcfg, _ = _pcfg()
    row = np.asarray([6, 2, 8, 8], np.int32)  # 2 pages reserved, 8 tokens
    dense = [{n: torch.from_numpy(rng.standard_normal(
        (1, 16, 2, 3)).astype(np.float32)) for n in ("k", "v")}
        for _ in range(2)]
    pools = [{n: torch.from_numpy(rng.standard_normal(
        (8, 4, 2, 3)).astype(np.float32)) for n in ("k_pages", "v_pages")}
        for _ in range(2)]
    jpools = {"p0": {n: jnp.stack([jnp.asarray(p[n].numpy()) for p in pools])
                     for n in ("k_pages", "v_pages")}}
    jdense = {"p0": {n: jnp.stack([jnp.asarray(d[n].numpy()) for d in dense])
                     for n in ("k", "v")}}
    kv.commit_prefill(pools, dense, row, length, page_size=4)
    want = jkv.commit_prefill(jpools, jdense, jnp.asarray(row), length,
                              page_size=4)
    for i, layer in enumerate(pools):
        for name in ("k_pages", "v_pages"):
            np.testing.assert_array_equal(layer[name].numpy(),
                                          np.asarray(want["p0"][name][i]))


# -- scheduler: the same admissions on both ---------------------------------


def _schedulers(pcfg_kw, prompt_lens, max_new=4, **kw):
    pcfg, jpcfg = kv.PagedCacheConfig(**pcfg_kw), jkv.PagedCacheConfig(
        **pcfg_kw)
    pair = (Scheduler(kv.PageAllocator(pcfg), **kw),
            JScheduler(jkv.PageAllocator(jpcfg), **kw))
    for sched, req in zip(pair, (Request, JRequest)):
        for rid, plen in enumerate(prompt_lens):
            sched.submit(req(rid=rid, prompt=np.zeros((plen,), np.int32),
                             max_new_tokens=max_new))
    return pair


def _admitted(pair):
    got, want = ([(r.rid, r.slot) for r in s.admit()] for s in pair)
    assert got == want
    return got


def test_scheduler_budget_and_admission():
    pair = _schedulers(dict(page_size=4, num_pages=32, max_slots=4,
                            max_seq=24), (6, 6, 6), prefill_token_budget=10)
    first = _admitted(pair)
    assert [rid for rid, _ in first] in ([0, 1], [0])
    second = _admitted(pair)
    assert {rid for rid, _ in first + second} >= {0, 1}


def test_scheduler_oversized_head_admitted_alone():
    """A prompt longer than the budget must not starve at the head."""
    pair = _schedulers(dict(page_size=4, num_pages=32, max_slots=4,
                            max_seq=24), (12,), prefill_token_budget=4)
    assert [rid for rid, _ in _admitted(pair)] == [0]


def test_scheduler_rejects_over_max_seq():
    pcfg, jpcfg = _pcfg()
    for sched, req in ((Scheduler(kv.PageAllocator(pcfg)), Request),
                       (JScheduler(jkv.PageAllocator(jpcfg)), JRequest)):
        with pytest.raises(ValueError, match="exceeds max_seq"):
            sched.submit(req(rid=0, prompt=np.zeros((15,), np.int32),
                             max_new_tokens=4))  # 19 > max_seq=16


def test_scheduler_slot_recycling():
    pair = _schedulers(dict(page_size=4, num_pages=8, max_slots=1,
                            max_seq=16), (4, 4))
    assert _admitted(pair) == [(0, 0)]
    assert _admitted(pair) == []  # single slot busy
    for sched in pair:
        a = sched.active[0]
        sched.finish(a, "max_new")
        assert a.done and a.finish_reason == "max_new" and a.slot is None
    assert _admitted(pair) == [(1, 0)]  # recycled


def test_scheduler_preempts_youngest_and_expires():
    """Preemption order, re-queueing behind the head, and deadlines: the
    two schedulers walk through the same states. Five pages hold two of
    the three 2-page requests; the third waits one round, then evicts the
    youngest active request."""
    pair = _schedulers(dict(page_size=4, num_pages=5, max_slots=3,
                            max_seq=16), (4, 4, 4), max_new=4,
                       preempt=True)
    trace = []
    for sched in pair:
        steps = []
        for _ in range(3):
            steps.append([(r.rid, r.slot) for r in sched.admit()])
            steps.append([(r.rid, r.preemptions) for r in sched.waiting])
        req = sched.active[min(sched.active)]
        req.deadline_s, req.submitted_at = 1.0, 0.0
        expired = sched.expire(10.0)
        trace.append((steps, sched.preempted_total,
                      [(r.rid, r.finish_reason) for r in expired],
                      sorted(sched.active)))
    assert trace[0] == trace[1]
    assert trace[0][1] >= 1 and trace[0][2]


# -- the paged decode step ---------------------------------------------------


@pytest.fixture(scope="module")
def paged(setup):
    """Three requests prefilled and committed on both packages; slot 1
    free (sentinel row), slot 2's length fills its last page."""
    cfg, model, params, jmodel, jparams = setup
    pcfg, jpcfg = _pcfg(page_size=4, num_pages=12, max_slots=4, max_seq=16)
    alloc = kv.PageAllocator(pcfg)
    rng = np.random.default_rng(5)
    pages = T.init_paged_cache(cfg, pcfg, torch.float32, device="cpu")
    jpages = jT.init_paged_cache(_jcfg(cfg), jpcfg, jnp.float32)
    for total, plen in ((9, 5), (8, 3), (8, 8)):
        slot = alloc.allocate(total)
        toks = rng.integers(0, cfg.vocab_size, (1, plen)).astype(np.int32)
        dense, jdense = _prefill_both(setup, toks)
        kv.commit_prefill(pages["layers"], dense["layers"],
                          alloc.block_table[slot], plen,
                          page_size=pcfg.page_size)
        jpages = {"layers": jkv.commit_prefill(
            jpages["layers"], jdense["layers"],
            jnp.asarray(alloc.block_table[slot]), plen,
            page_size=pcfg.page_size)}
        alloc.commit(slot, plen)
    alloc.release(1)  # an inactive slot between active ones
    return dict(pcfg=pcfg, alloc=alloc, pages=pages, jpages=jpages)


def test_paged_decode_matches_reference(setup, paged, monkeypatch):
    """One paged decode step: logits within 1e-5 of the reference's
    ``make_paged_decode_step`` on the active rows; the pools bit for bit
    the reference's scatter of the port's own token k/v; no index past the
    pool, with slot 1 inactive and slot 2's token on a sentinel page."""
    cfg, model, params, jmodel, jparams = setup
    alloc, pcfg = paged["alloc"], paged["pcfg"]
    assert (alloc.block_table[1] == pcfg.num_pages).all()
    assert alloc.seq_lens[2] == 8 and alloc.block_table[2, 2] == \
        pcfg.num_pages  # its token at 8 falls on the sentinel: dropped
    pages = {"layers": [{n: t.clone() for n, t in layer.items()}
                        for layer in paged["pages"]["layers"]]}
    before = [{n: t.clone() for n, t in layer.items()}
              for layer in pages["layers"]]
    tok = np.asarray([[7], [0], [11], [3]], np.int32)
    bt, lens = alloc.device_tables("cpu")

    updates = []
    orig = T._apply_layer

    def spy(*a, **kw):
        x, upd = orig(*a, **kw)
        updates.append(upd)
        return x, upd

    monkeypatch.setattr(T, "_apply_layer", spy)
    logits, out = serve.make_paged_decode_step(model)(
        params, torch.from_numpy(tok), pages, bt, lens)
    jlogits, jout = jserve.make_paged_decode_step(jmodel)(
        jparams, jnp.asarray(tok), paged["jpages"],
        jnp.asarray(alloc.block_table), jnp.asarray(alloc.seq_lens))
    assert out["layers"] is pages["layers"]
    active = [0, 2]  # slot 1 released, slot 3 never allocated: inactive
    np.testing.assert_allclose(_np(logits)[active], _np(jlogits)[active],
                               atol=ATOL, rtol=0)
    bt_j, lens_j = jnp.asarray(alloc.block_table), jnp.asarray(
        alloc.seq_lens)
    ps = pcfg.page_size
    col = jnp.clip(lens_j // ps, 0, bt_j.shape[1] - 1)
    page_idx = jnp.take_along_axis(bt_j, col[:, None], axis=1)[:, 0]
    for i, (layer, upd) in enumerate(zip(out["layers"], updates)):
        for name in ("k", "v"):
            want = jnp.asarray(before[i][name + "_pages"].numpy()).at[
                page_idx, lens_j % ps].set(
                    jnp.asarray(upd[name + "_upd"][:, 0].numpy()),
                    mode="drop")
            np.testing.assert_array_equal(layer[name + "_pages"].numpy(),
                                          np.asarray(want))
            np.testing.assert_allclose(
                layer[name + "_pages"].numpy(),
                _np(jout["layers"]["p0"][name + "_pages"][i]), atol=ATOL,
                rtol=0)
    # slot 2's token went nowhere: its pages are unchanged
    for i, layer in enumerate(out["layers"]):
        for p in alloc.block_table[2, :2]:
            assert torch.equal(layer["k_pages"][p], before[i]["k_pages"][p])


def test_paged_prefill_is_refused(setup, paged):
    cfg, model, params, _, _ = setup
    alloc = paged["alloc"]
    bt, lens = alloc.device_tables("cpu")
    cache = {"pos": lens, "layers": paged["pages"]["layers"]}
    with pytest.raises(ValueError, match="decode-only"):
        model.apply(params, {"tokens": torch.zeros((4, 2), dtype=torch.int32)},
                    cache=cache, page_table={"block_table": bt,
                                             "lengths": lens})
