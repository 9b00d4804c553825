"""The explicit half of serving on four gloo processes, held against the JAX
reference's one-device paged decode and GSPMD engine.

Geometry of the reference's ``tests/dist/test_serve.py`` at ``NDEV = 4``:
qwen3-moe ``tiny(4)`` (8 q and 8 KV heads, 4 experts, one layer), ``B =
4`` slots, prompts of ``S0 = 5`` tokens, 3 decode steps, pages of 4. The
parent runs the reference (``repro.train.serve.make_paged_decode_step`` on
one device from committed prefill pages, and its GSPMD ``ServeEngine`` on
the reference test's workload) and hands its weights, pages, block tables
and tokens to one world of four CPU processes through a file. Every rank
runs:

* ``make_decode_step_explicit`` per schedule (None, ``chain``,
  ``native``, ``staged``) from the reference's pages cut to its KV heads,
  with its rows of the reference's tokens: logits and pool per step;
* the explicit ``ServeEngine`` on the reference test's workload;
* the GSPMD paged decode and engine on the ring ``('x',)``, on the 2x2
  ``('data', 'model')`` mesh and (the decode) on 1x4, on reduced
  llama3.2-3b with 2 KV heads for the two meshes with a ``tp`` axis (MoE
  layers do not split over ``tp``, ROADMAP A15), against the one-rank step
  and engine run in the same process;
* ``failover_bench.serve_rank_loss_rank``.

The parent holds the explicit step to the reference at its limit (logits
and pages, atol 2e-5), the schedules to each other bit for bit, and the
engines' streams token for token. The reference is imported inside
functions only, so the spawned ranks do not import JAX.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
import tempfile

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.benchmarks import common, failover_bench, serve_bench
from repro_torch.comm import autotune
from repro_torch.comm.autotune import CostModel
from repro_torch.comm.callsites import DECODE_MOE, DECODE_OUT, DECODE_QKV
from repro_torch.comm.engine import CollectiveEngine, schedules_for
from repro_torch.comm.topology import AxisTopology
from repro_torch.comm.types import H100_80GB
from repro_torch.configs.qwen3_moe_235b_a22b import tiny
from repro_torch.launch.mesh import MeshAxis, ProcessMesh, make_mesh, \
    spawn_mesh
from repro_torch.models.kvcache import PagedCacheConfig, pool_heads
from repro_torch.models.model import (build_model, from_reference,
                                      pages_from_reference)
from repro_torch.serve import ServeEngine
from repro_torch.train.serve import (decode_rows, local_params,
                                     make_decode_step_explicit,
                                     make_paged_decode_step)

RANKS = 4
B, S0, STEPS = RANKS, 5, 3
PAGE = 4
ATOL = 2e-5  # tests/dist/test_serve.py:113-116
SCHEDULES = [None] + sorted(schedules_for("all_to_all_tiles"))
LENGTHS = (5, 3, 7, 4, 6, 5, 4, 3, 6, 7)  # tests/dist/test_serve.py:128
MAX_NEW = 4
GSPMD_MESHES = {"ring": ((4,), ("x",)), "2x2": ((2, 2), ("data", "model")),
                "1x4": ((1, 4), ("data", "model"))}
GSPMD_ENGINE_MESHES = ("ring", "2x2")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the tiny models: under six test workers the
    default oversubscribes the cores and slows each small op many times
    over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pages(max_seq: int) -> int:
    return -(-max_seq // PAGE)


def _engine_pcfg(slots=B):
    return PagedCacheConfig(page_size=PAGE, max_slots=slots, max_seq=16,
                            num_pages=slots * _pages(16))


def _workload(cfg):
    rng = np.random.default_rng(5)
    return [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
            for n in LENGTHS]


def _dense_cfg():
    return dataclasses.replace(
        configs.reduced(configs.get_config("llama3.2-3b"), layers=2),
        num_kv_heads=2)


def _analytic(mesh, **kw):
    # an explicit analytic cost model: no measured table interferes
    return CollectiveEngine.for_mesh(mesh, cost_model=CostModel(hw=H100_80GB),
                                     **kw)


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------


def _explicit_steps(mesh, model, params, ref, schedule):
    cfg = model.cfg
    pages = pages_from_reference(cfg, ref["pages0"], device="cpu",
                                 kv_heads=pool_heads(cfg, mesh, "x"))
    step = make_decode_step_explicit(model, mesh, schedule=schedule,
                                     engine=_analytic(mesh))
    rows = decode_rows(mesh, B, "x")
    mine = local_params(params, mesh, "x")
    out = {"logits": [], "pages": []}
    for i in range(STEPS):
        bt, ln = (torch.from_numpy(a) for a in ref["tables"][i])
        tok = torch.from_numpy(ref["toks"][i])[rows]
        logits, pages = step(mine, tok, pages, bt, ln)
        out["logits"].append(logits.numpy().copy())
        out["pages"].append([t.numpy().copy() for layer in pages["layers"]
                             for t in (layer["k_pages"], layer["v_pages"])])
    qkv = B // RANKS * cfg.num_heads * cfg.head_dim * 4
    out["resolved"] = step.engine.schedule_for(
        "all_to_all_tiles", schedule, nbytes=qkv, axis="x",
        callsite=DECODE_QKV)
    return out


def _gspmd_decode(mesh, model, params):
    """The GSPMD paged decode on ``mesh`` and the one-rank step on the
    whole batch, from the same prefilled pages: this rank's rows' logits
    and the pages they write, both ways."""
    cfg = model.cfg
    pcfg = PagedCacheConfig(page_size=PAGE, max_slots=B, max_seq=S0 + STEPS,
                            num_pages=B * _pages(S0 + STEPS))
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, S0), generator=gen,
                            dtype=torch.int32)
    whole, alloc, tok = serve_bench.prefill_pages(model, params, pcfg,
                                                  prompts, STEPS, "cpu")
    start, count = pool_heads(cfg, mesh)
    mine = {"layers": [{k: v.narrow(2, start, count).clone()
                        for k, v in layer.items()}
                       for layer in whole["layers"]]}
    rows = decode_rows(mesh, B)
    local = local_params(params, mesh)
    one, wide = make_paged_decode_step(model, None), \
        make_paged_decode_step(model, mesh)
    out = {"logits": [], "want": [], "pages": [], "want_pages": []}
    for _ in range(STEPS):
        bt, ln = alloc.device_tables()
        lg, whole = one(params, tok, whole, bt, ln)
        got, mine = wide(local, tok[rows], mine, bt[rows], ln[rows])
        out["logits"].append(got.numpy().copy())
        out["want"].append(lg[rows].numpy().copy())
        for s in range(B):
            alloc.append(s)
        tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
    held = alloc.block_table[rows.start:rows.stop]
    held = torch.from_numpy(held[held < pcfg.num_pages].astype(np.int64))
    for w, m in zip(whole["layers"], mine["layers"]):
        for k in ("k_pages", "v_pages"):
            out["pages"].append(m[k][held].numpy().copy())
            out["want_pages"].append(
                w[k][held].narrow(2, start, count).numpy().copy())
    out["rows"] = (rows.start, rows.stop)
    out["pool_heads"] = (start, count)
    return out


def _streams(out):
    return {r: v.tolist() for r, v in out.items()}


def _rank(mesh, path):
    from repro_torch.kernels import ops

    with open(path, "rb") as f:
        ref = pickle.load(f)
    meshes = {name: (mesh if name == "ring" else make_mesh(*spec))
              for name, spec in GSPMD_MESHES.items()}
    ops.reset_launch_counts()
    cfg = tiny(RANKS)
    model = build_model(cfg)
    params = from_reference(cfg, ref["params"], device="cpu")
    out = {"explicit": {str(s): _explicit_steps(mesh, model, params, ref, s)
                        for s in SCHEDULES}}
    eng = ServeEngine(model, params, _engine_pcfg(), mode="explicit",
                      mesh=mesh, engine=_analytic(mesh),
                      prefill_token_budget=16)
    res, stats = eng.run(_workload(cfg), max_new_tokens=MAX_NEW,
                         collect_stats=True)
    out["engine"] = {"streams": _streams(res), "mixed": sum(
        1 for s in stats if s["prefills"] and s["decode_tokens"])}
    dense = build_model(_dense_cfg())
    dparams = dense.init(0, device="cpu")
    out["gspmd_decode"] = {
        name: _gspmd_decode(m, model if name == "ring" else dense,
                            params if name == "ring" else dparams)
        for name, m in meshes.items()}
    out["gspmd_engine"] = {}
    for name in GSPMD_ENGINE_MESHES:
        m, p = (model, params) if name == "ring" else (dense, dparams)
        wl = _workload(m.cfg)
        got = ServeEngine(m, p, _engine_pcfg(), mesh=meshes[name],
                          prefill_token_budget=16).run(
            wl, max_new_tokens=MAX_NEW)
        want = ServeEngine(m, p, _engine_pcfg(),
                           prefill_token_budget=16).run(
            wl, max_new_tokens=MAX_NEW)
        out["gspmd_engine"][name] = {"got": _streams(got),
                                     "want": _streams(want)}
    out["serve_rank_loss"] = failover_bench.serve_rank_loss_rank(mesh, "cpu")
    out["launches"] = ops.launch_counts()
    return out


# ---------------------------------------------------------------------------
# the reference and the world
# ---------------------------------------------------------------------------


def _clone_alloc(alloc, pcfg):
    from repro.models.kvcache import PageAllocator

    a2 = PageAllocator(pcfg)
    a2.block_table[:] = alloc.block_table
    a2.seq_lens[:] = alloc.seq_lens
    a2._capacity[:] = alloc._capacity
    return a2


def _reference():
    """The reference test's ``served`` fixture at four slots, one device,
    and its GSPMD engine's streams on the workload."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import transformer as JT
    from repro.models.kvcache import PageAllocator
    from repro.models.kvcache import PagedCacheConfig as JPagedCacheConfig
    from repro.models.kvcache import commit_prefill
    from repro.models.model import build_model as jbuild_model
    from repro.serve import ServeEngine as JServeEngine
    from repro.train.serve import make_paged_decode_step as jpaged
    from repro.train.serve import make_prefill_step

    cfg = tiny(RANKS)
    jmodel = jbuild_model(jconfigs.ModelConfig(**dataclasses.asdict(cfg)))
    jparams = jmodel.init(jax.random.key(0))
    pcfg = JPagedCacheConfig(page_size=PAGE, max_slots=B,
                             max_seq=S0 + STEPS,
                             num_pages=B * _pages(S0 + STEPS))
    prompts = jax.random.randint(jax.random.key(1), (B, S0), 0,
                                 cfg.vocab_size).astype(jnp.int32)
    prefill = make_prefill_step(jmodel, None)
    alloc = PageAllocator(pcfg)
    pages = JT.init_paged_cache(jmodel.cfg, pcfg, jnp.float32)
    first = np.zeros((B, 1), np.int32)
    for b in range(B):
        slot = alloc.allocate(S0 + STEPS)
        c1 = jmodel.init_cache(1, S0, jnp.float32)
        lg, c1 = prefill(jparams, {"tokens": prompts[b:b + 1]}, c1)
        pages["layers"] = commit_prefill(
            pages["layers"], c1["layers"],
            jnp.asarray(alloc.block_table[slot]), S0,
            page_size=pcfg.page_size)
        alloc.commit(slot, S0)
        first[slot, 0] = int(jnp.argmax(lg[0, -1]))
    pages0 = jax.tree.map(np.array, pages)

    pd = jpaged(jmodel, None)
    ref = {"logits": [], "pages": [], "tables": [], "toks": [first]}
    pg = jax.tree.map(lambda a: a.copy(), pages)
    a2 = _clone_alloc(alloc, pcfg)
    tok = first
    for _ in range(STEPS):
        bt, ln = a2.device_tables()
        ref["tables"].append((np.array(bt), np.array(ln)))
        lg, pg = pd(jparams, jnp.asarray(tok), pg, bt, ln)
        ref["logits"].append(np.array(lg))
        ref["pages"].append(jax.tree.map(np.array, pg))
        for s in range(B):
            a2.append(s)
        tok = np.asarray(jnp.argmax(lg[:, -1], -1), np.int32)[:, None]
        ref["toks"].append(tok)

    geometry = dataclasses.asdict(_engine_pcfg())
    eng = JServeEngine(jmodel, jparams, JPagedCacheConfig(**geometry),
                       prefill_token_budget=16)
    streams = eng.run(_workload(cfg), max_new_tokens=MAX_NEW)
    return {"params": jax.tree.map(np.asarray, jparams), "pages0": pages0,
            **ref, "streams": {r: np.asarray(v).tolist()
                               for r, v in streams.items()}}


@pytest.fixture(scope="module")
def world():
    ref = _reference()
    root = tempfile.mkdtemp(prefix="test_torch_serve_explicit_")
    try:
        path = os.path.join(root, "ref.pkl")
        with open(path, "wb") as f:
            pickle.dump({k: ref[k] for k in ("params", "pages0", "tables",
                                             "toks")}, f)
        ranks = spawn_mesh(RANKS, _rank, path, axes=("x",), timeout=300)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"ref": ref, "ranks": ranks}


def _ref_pages(ref, i):
    """The reference's pool after step ``i`` as the port's flat list (k,
    v per layer), whole KV heads."""
    cfg = tiny(RANKS)
    pages = pages_from_reference(cfg, ref["pages"][i], device="cpu")
    return [t.numpy() for layer in pages["layers"]
            for t in (layer["k_pages"], layer["v_pages"])]


# ---------------------------------------------------------------------------
# the explicit step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", [str(s) for s in SCHEDULES])
def test_explicit_decode_matches_reference(world, schedule):
    """Logits and every rank's pool against the reference's one-device
    paged decode (its KV share of the reference's pool), per step, at the
    reference's limit."""
    ref = world["ref"]
    for r, rank in enumerate(world["ranks"]):
        got = rank["explicit"][schedule]
        rows = slice(r * B // RANKS, (r + 1) * B // RANKS)
        kv = tiny(RANKS).num_kv_heads // RANKS
        for i in range(STEPS):
            np.testing.assert_allclose(got["logits"][i],
                                       ref["logits"][i][rows], rtol=0,
                                       atol=ATOL, err_msg=f"rank {r} {i}")
            for g, w in zip(got["pages"][i], _ref_pages(ref, i)):
                np.testing.assert_allclose(g, w[:, :, r * kv:(r + 1) * kv],
                                           rtol=0, atol=ATOL)
        assert got["resolved"] in schedules_for("all_to_all_tiles")


@pytest.mark.parametrize("schedule", sorted(schedules_for(
    "all_to_all_tiles")))
def test_explicit_decode_bitwise_across_schedules(world, schedule):
    """The exchanges only move whole heads: every schedule gives the
    auto-resolved step's bits."""
    for rank in world["ranks"]:
        got, want = rank["explicit"][schedule], rank["explicit"]["None"]
        for i in range(STEPS):
            assert np.array_equal(got["logits"][i], want["logits"][i])
            for g, w in zip(got["pages"][i], want["pages"][i]):
                assert np.array_equal(g, w)


def test_explicit_engine_matches_reference_gspmd_engine(world):
    want = world["ref"]["streams"]
    for rank in world["ranks"]:
        got = rank["engine"]
        assert got["mixed"] > 0
        assert set(got["streams"]) == set(want)
        for rid in want:
            np.testing.assert_array_equal(got["streams"][rid], want[rid])


def test_no_kernel_launched(world):
    for rank in world["ranks"]:
        assert not any(rank["launches"].values())


# ---------------------------------------------------------------------------
# the GSPMD decode and engine on meshes of several ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", sorted(GSPMD_MESHES))
def test_gspmd_paged_decode_matches_one_rank(world, mesh):
    covered = set()
    for rank in world["ranks"]:
        got = rank["gspmd_decode"][mesh]
        for g, w in zip(got["logits"], got["want"]):
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
        for g, w in zip(got["pages"], got["want_pages"]):
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
        covered.add(tuple(got["rows"]) + tuple(got["pool_heads"]))
    rows = {c[:2] for c in covered}
    # every row decoded by some rank: each of its block on the ring, the
    # data axis's halves on 2x2, all of them on 1x4
    assert {"ring": 4, "2x2": 2, "1x4": 1}[mesh] == len(rows)


@pytest.mark.parametrize("mesh", GSPMD_ENGINE_MESHES)
def test_gspmd_engine_on_a_mesh_matches_one_rank(world, mesh):
    for rank in world["ranks"]:
        got = rank["gspmd_engine"][mesh]
        assert got["got"] == got["want"]
    if mesh == "ring":  # the same weights as the reference's engine
        got = world["ranks"][0]["gspmd_engine"][mesh]["got"]
        assert got == world["ref"]["streams"]


def test_serve_rank_loss_gate(world):
    sec = failover_bench.serve_rank_loss_record(
        [r["serve_rank_loss"] for r in world["ranks"]])
    assert failover_bench.gate_serve_rank_loss(sec) == []
    assert sec["drained"] >= 1 and sec["tokens_lost"] == 0
    bad = dict(sec, drained=0, tokens_lost=2, token_identical=False)
    assert len(failover_bench.gate_serve_rank_loss(bad)) == 2


# ---------------------------------------------------------------------------
# refusals (the reference's tests/dist/test_serve.py:145-161)
# ---------------------------------------------------------------------------


def _ring4():
    return ProcessMesh(axes=(MeshAxis("x", RANKS, 0, tuple(range(RANKS))),))


@pytest.mark.parametrize("what", ["heads", "slots"])
def test_explicit_divisibility_errors(what):
    if what == "heads":  # 2 KV heads over 4 ranks
        with pytest.raises(ValueError, match="divisible"):
            make_decode_step_explicit(build_model(_dense_cfg()), _ring4())
    else:
        cfg = tiny(RANKS)
        model = build_model(cfg)
        with pytest.raises(ValueError, match="divisible"):
            ServeEngine(model, model.init(0, device="cpu"),
                        _engine_pcfg(RANKS + 1), mode="explicit",
                        mesh=_ring4())


# ---------------------------------------------------------------------------
# the decode autotune pattern
# ---------------------------------------------------------------------------

DECODE = "all_to_all_tiles@decode.qkv"
DECODE_TAGS = (DECODE, "all_to_all_tiles@decode.out",
               "all_to_all_tiles@decode.moe")


def test_decode_pattern_measured_and_filed_under_three_tags(tmp_path):
    table, record = autotune.autotune_mesh(ops=(DECODE,), quick=True,
                                           device="cpu", verbose=False,
                                           timeout=240)
    sig = f"ring[{RANKS}]"
    assert {int(k.rsplit("/", 1)[1]) for k in record} == \
        set(autotune.DECODE_SIZES_QUICK)
    assert autotune.untimed(record, autotune.DEFAULT_SIZES_QUICK,
                            ops=(DECODE,)) == []
    assert set(table.entries) == set(DECODE_TAGS)
    rows = table.entries[DECODE][sig]
    for tag in DECODE_TAGS:
        assert table.entries[tag][sig] == rows
    for _, name in rows:
        assert name in schedules_for("all_to_all_tiles")
    loaded = autotune.TuningTable.load(table.save(tmp_path / "t.json"))
    m = CostModel(hw=H100_80GB, table=loaded)
    axes = (AxisTopology("x", RANKS, "ring"),)
    want = m.choose("all_to_all_tiles", 1024, axes, callsite=DECODE_QKV)
    for cs in (DECODE_OUT, DECODE_MOE):
        assert m.choose("all_to_all_tiles", 1024, axes, callsite=cs) == want


@pytest.mark.parametrize("size", [1 << 8, 1 << 11, 1 << 12, 1 << 14,
                                  64 << 20])
def test_decode_resolutions_match_reference_cost_model(size):
    """The analytic resolutions of the decode callsites on the port's
    H100_80GB, against the reference's CostModel on the same figures."""
    from repro.comm import autotune as jautotune
    from repro.comm import types as jtypes
    from repro.comm.topology import AxisTopology as JAxis

    jm = jautotune.CostModel(hw=jtypes.HardwareModel(
        **dataclasses.asdict(H100_80GB)))
    m = CostModel(hw=H100_80GB)
    for n in (4, 8):
        for cs in (DECODE_QKV, DECODE_OUT, DECODE_MOE):
            assert m.choose("all_to_all_tiles", size,
                            (AxisTopology("x", n, "ring"),), callsite=cs) \
                == jm.choose("all_to_all_tiles", size,
                             (JAxis("x", n, "ring"),), callsite=cs)


def test_decode_ladders_are_the_references():
    from repro.comm import autotune as jautotune

    assert autotune.DECODE_SIZES == jautotune.DECODE_SIZES
    assert autotune.DECODE_SIZES_QUICK == jautotune.DECODE_SIZES_QUICK
    assert autotune.op_sizes(DECODE, autotune.DEFAULT_SIZES) == \
        autotune.DECODE_SIZES
    assert autotune.op_sizes(DECODE, (1 << 9,)) == (1 << 9,)
    assert DECODE in autotune.MEASURED_OPS


# ---------------------------------------------------------------------------
# the launcher and serve_bench
# ---------------------------------------------------------------------------


def test_launcher_explicit_mode_on_cpu(capsys):
    from repro_torch.launch import serve as launch

    argv = ["--arch", "llama3-8b", "--requests", "4", "--prompt-len", "8",
            "--max-new", "4", "--device", "cpu"]
    got = launch.main(argv + ["--mode", "explicit", "--schedule", "chain"])
    assert "mode=explicit" in capsys.readouterr().out
    want = launch.main(argv)
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    cfg = configs.reduced(configs.get_config("llama3-8b"))
    assert launch.explicit_ranks(cfg, 4) == 4
    assert launch.explicit_ranks(cfg, 6) == 2


def test_serve_bench_quick_on_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(common, "RESULTS", tmp_path)
    rec = serve_bench.main(quick=True, device="cpu")
    eq, sw = rec["decode_equivalence"], rec["batch_sweep"]
    assert eq["within_tolerance"] and eq["devices"] == RANKS
    assert sw["modes_token_identical"] and sw["ranks_agree"]
    assert serve_bench.gate_resolved(eq) == [] == \
        serve_bench.gate_resolved(sw)
    assert (tmp_path / "torch_serve_bench.json").is_file()
