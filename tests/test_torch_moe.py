"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
reference on the CPU.

Weights come from the reference's ``init_moe`` and inputs from numpy seeds.
Routing and the dispatch bookkeeping are held exactly (integers, and the
dispatch buffer bit for bit); ``apply_moe`` within 1e-5 on reduced
qwen3-moe, on reduced llama4-maverick (shared expert) and at capacity 0.5
(drops, with equal ``aux``); the combine's ordered sum is bitwise the
reference's scatter-add on the same weighted outputs. The mirrors of
``tests/test_models.py:103-124`` follow. One 4-rank gloo ring, spawned once
for the module, mirrors ``tests/dist/test_moe.py``: the expert-parallel
path for every ``all_to_all_tiles`` schedule and chunk count against the
single-process layer and the dense oracle, the same drops at capacity 0.5,
one expert per rank with top-1, the divisibility error, and the pipelined
exchanges bit-identical to the monolithic ones on integer payloads. Last,
the autotune pattern ``all_to_all_tiles@moe.dispatch`` on a quick measured
run, with its winner filed under ``@moe.combine`` too.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.comm import autotune as jautotune
from repro.models import moe as JMOE
from repro.models import transformer as jtransformer
from repro.models.model import build_model as jbuild_model
from repro_torch import configs
from repro_torch.comm import autotune
from repro_torch.comm.engine import CollectiveEngine, schedules_for
from repro_torch.launch.mesh import single_rank_mesh, spawn_mesh
from repro_torch.models import moe as MOE
from repro_torch.models import transformer
from repro_torch.models.model import build_model, from_reference

ATOL = 1e-5
RING = 4
A2A = tuple(sorted(schedules_for("all_to_all_tiles")))
CHUNKS = (1, 2, "auto")


def _jcfg(cfg):
    return jconfigs.ModelConfig(**dataclasses.asdict(cfg))


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


CASES = {
    "qwen3-moe": ("qwen3-moe-235b-a22b", {}),
    "maverick": ("llama4-maverick-400b-a17b", {}),
    "capacity-0.5": ("qwen3-moe-235b-a22b", {"capacity_factor": 0.5}),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    arch, over = CASES[request.param]
    cfg = dataclasses.replace(configs.reduced(configs.get_config(arch)),
                              **over)
    jcfg = _jcfg(cfg)
    jp = JMOE.init_moe(jax.random.key(1), jcfg)
    x = np.random.default_rng(2).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    return dict(name=request.param, cfg=cfg, jcfg=jcfg, jp=jp, p=_t(jp),
                x=x)


def _routing(case):
    cfg, jcfg, x = case["cfg"], case["jcfg"], case["x"]
    E, C = cfg.num_experts, MOE._capacity(cfg, x.shape[1])
    assert C == JMOE._capacity(jcfg, x.shape[1])
    jprobs, jids = JMOE.route(case["jp"], jcfg, jnp.asarray(x))
    probs, ids = MOE.route(case["p"], cfg, torch.from_numpy(x))
    return E, C, (jprobs, jids), (probs, ids)


def test_route_matches_reference(case):
    _, _, (jprobs, jids), (probs, ids) = _routing(case)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-6,
                               rtol=0)
    assert probs.dtype == torch.float32


def test_dispatch_indices_and_buffer_are_exact(case):
    E, C, (_, jids), (_, ids) = _routing(case)
    je, jc, jkeep, jonehot = JMOE._dispatch_indices(jids, E, C)
    e, c, keep, onehot = MOE._dispatch_indices(ids, E, C)
    for got, want in ((e, je), (c, jc), (keep, jkeep), (onehot, jonehot)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((c <= C).all()) and bool((c[~keep] == C).all())
    K = case["cfg"].num_experts_per_tok
    x = case["x"]
    jtok = jnp.repeat(jnp.asarray(x), K, axis=1)
    tok = MOE._tokens(torch.from_numpy(x), K)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    jbuf = JMOE._scatter_dispatch(jtok, je, jc, E, C)
    buf = MOE._scatter_dispatch(tok, e, c, E, C)
    assert buf.shape == (x.shape[0], E, C, x.shape[2])
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))


def test_combine_is_bitwise_the_reference_scatter_add(case):
    """The ordered per-token sum (ascending expert id, from 0.0) equals the
    reference's scatter-add on the CPU bit for bit, drops included."""
    cfg, x = case["cfg"], case["x"]
    E, C, (jprobs, jids), _ = _routing(case)
    B, S, D = x.shape
    K = cfg.num_experts_per_tok
    je, jc, jkeep, _ = JMOE._dispatch_indices(jids, E, C)
    y_w = np.random.default_rng(3).standard_normal(
        (B, E, C, D)).astype(np.float32)
    want = np.asarray(JMOE._combine_scatter(jnp.asarray(y_w), je, jc, S, K,
                                            E, C))
    got = MOE._combine_scatter(torch.from_numpy(y_w),
                               torch.from_numpy(np.array(je)).long(),
                               torch.from_numpy(np.array(jc)).long(),
                               torch.from_numpy(np.array(jkeep)), S, K)
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    w = MOE._combine_weights(torch.from_numpy(np.array(jprobs)),
                             torch.from_numpy(np.array(jkeep)),
                             torch.from_numpy(np.array(je)).long(),
                             torch.from_numpy(np.array(jc)).long(), E, C)
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(JMOE._combine_weights(jprobs, jkeep, je, jc,
                                                    E, C)))


def test_apply_moe_matches_reference(case):
    cfg, x = case["cfg"], case["x"]
    jaux, aux = {}, {}
    want = np.asarray(JMOE.apply_moe(case["jp"], case["jcfg"],
                                     jnp.asarray(x), aux=jaux))
    got = MOE.apply_moe(case["p"], cfg, torch.from_numpy(x), aux=aux)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert set(aux) == set(jaux) == {"moe_frac_tokens", "moe_dropped"}
    np.testing.assert_array_equal(aux["moe_frac_tokens"].numpy(),
                                  np.asarray(jaux["moe_frac_tokens"]))
    assert float(aux["moe_dropped"]) == float(jaux["moe_dropped"])
    if case["name"] == "capacity-0.5":
        assert float(aux["moe_dropped"]) > 0.0  # the edge case is exercised
    if cfg.shared_expert:
        assert "shared" in case["p"]


def test_reference_moe_matches_reference(case):
    cfg, x = case["cfg"], case["x"]
    want = np.asarray(JMOE.reference_moe(case["jp"], case["jcfg"],
                                         jnp.asarray(x)))
    got = MOE.reference_moe(case["p"], cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("common,lo,hi", [(0.0, 0.0, 0.01),
                                          (0.3, 0.10, 0.25),
                                          (0.6, 0.35, 0.55)])
def test_full_router_geometry_drops_match_reference(common, lo, hi):
    """qwen3-moe's router at full width (D 4096, E 128, k 8), one 1024-token
    row (C 80), the reference's router scale: the port's expert ids, kept
    slots and drop fraction equal the reference's. Tokens that share a
    component (``common`` of their rms) route onto the same experts and
    overflow the capacity; independent ones hardly drop."""
    cfg = configs.get_config("qwen3-moe-235b-a22b")
    D, E, S = cfg.d_model, cfg.num_experts, 1024
    C = MOE._capacity(cfg, S)
    assert C == JMOE._capacity(_jcfg(cfg), S) == 80
    rng = np.random.default_rng(5)
    router = (rng.standard_normal((D, E)) * 0.02).astype(np.float32)
    x = (common * rng.standard_normal((1, 1, D))
         + np.sqrt(1 - common ** 2) * rng.standard_normal((1, S, D))
         ).astype(np.float32)
    _, jids = JMOE.route({"router": jnp.asarray(router)}, _jcfg(cfg),
                         jnp.asarray(x))
    _, _, jkeep, _ = JMOE._dispatch_indices(jids, E, C)
    _, ids = MOE.route({"router": torch.from_numpy(router)}, cfg,
                       torch.from_numpy(x))
    _, _, keep, _ = MOE._dispatch_indices(ids, E, C)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    dropped = 1.0 - float(keep.float().mean())
    assert dropped == 1.0 - float(np.asarray(jkeep).mean())
    assert lo <= dropped <= hi


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_apply_moe_keeps_the_reference_dtypes(dtype):
    """Expert products in the activation dtype, the combine in fp32 cast
    once, the shared expert added after the cast: bf16 in, bf16 out, within
    bf16 rounding of the reference on the same bf16 input."""
    cfg = configs.reduced(configs.get_config("llama4-maverick-400b-a17b"))
    jp = JMOE.init_moe(jax.random.key(4), _jcfg(cfg))
    x = np.random.default_rng(5).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(JMOE.apply_moe(jp, _jcfg(cfg), jx).astype(jnp.float32))
    got = MOE.apply_moe(_t(jp), cfg,
                        torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = ATOL if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


def test_init_moe_has_the_reference_layout():
    for arch in ("qwen3-moe-235b-a22b", "llama4-maverick-400b-a17b"):
        cfg = configs.reduced(configs.get_config(arch))
        want = JMOE.init_moe(jax.random.key(0), _jcfg(cfg))
        got = MOE.init_moe(torch.Generator().manual_seed(0), cfg)
        assert jax.tree.structure(jax.tree.map(np.asarray, want)) == \
            jax.tree.structure(jax.tree.map(lambda t: t.numpy(), got))
        for a, b in zip(jax.tree.leaves(want),
                        jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                     got))):
            assert a.shape == b.shape and b.dtype == np.float32
        assert abs(float(got["w_gate"].std()) - 0.02) < 2e-3


def test_model_aux_is_the_references():
    """``transformer.apply``'s aux is the reference's: ``{}`` with
    ``collect_aux``, else None (its layers collect no MoE metrics); the
    model's ``apply`` gives None, as the reference's does."""
    cfg = configs.reduced(configs.get_config("qwen3-moe-235b-a22b"),
                          layers=2)
    jmodel = jbuild_model(_jcfg(cfg))
    jparams = jmodel.init(jax.random.key(0))
    params = from_reference(cfg, jax.tree.map(np.asarray, jparams),
                            device="cpu")
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                            (1, 8)).astype(np.int32)
    for collect in (False, True):
        _, _, jaux = jtransformer.apply(jparams, _jcfg(cfg), jnp.asarray(tok),
                                        collect_aux=collect)
        _, _, aux = transformer.apply(params, cfg, torch.from_numpy(tok),
                                      collect_aux=collect)
        assert aux == jaux == ({} if collect else None)
    assert jmodel.apply(jparams, {"tokens": jnp.asarray(tok)})[2] is None
    assert build_model(cfg).apply(
        params, {"tokens": torch.from_numpy(tok)})[2] is None


# ---------------------------------------------------------------------------
# mirrors of tests/test_models.py:103-124
# ---------------------------------------------------------------------------


def test_moe_matches_dense_oracle():
    """With capacity >> need, scatter dispatch equals the dense expert
    loop."""
    cfg = configs.reduced(configs.get_config("qwen3-moe-235b-a22b"))
    cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    p = _t(JMOE.init_moe(jax.random.key(1), _jcfg(cfg)))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    np.testing.assert_allclose(MOE.apply_moe(p, cfg, x).numpy(),
                               MOE.reference_moe(p, cfg, x).numpy(),
                               atol=1e-5, rtol=1e-4)


def test_moe_capacity_drops_are_bounded():
    cfg = configs.reduced(configs.get_config("llama4-maverick-400b-a17b"))
    p = _t(JMOE.init_moe(jax.random.key(1), _jcfg(cfg)))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32))
    aux = {}
    MOE.apply_moe(p, cfg, x, aux=aux)
    assert float(aux["moe_dropped"]) <= 0.6  # top-1 of 4 experts, cap 1.25
    np.testing.assert_allclose(float(aux["moe_frac_tokens"].sum()), 1.0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the expert-parallel path on a 4-rank gloo ring (tests/dist/test_moe.py)
# ---------------------------------------------------------------------------


def _dist_cfg(**over):
    cfg = configs.reduced(configs.get_config("qwen3-moe-235b-a22b"))
    base = dict(num_experts=2 * RING, num_experts_per_tok=2,
                capacity_factor=8.0)
    base.update(over)
    return dataclasses.replace(cfg, **base)


def _dist_inputs(cfg, seed, B=RING, S=16):
    p = jax.tree.map(np.asarray,
                     JMOE.init_moe(jax.random.key(seed), _jcfg(cfg)))
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    return p, x


DIST_CASES = {"main": (_dist_cfg(), 0),
              "drops": (_dist_cfg(capacity_factor=0.5), 6),
              "top1": (_dist_cfg(num_experts=RING, num_experts_per_tok=1,
                                 capacity_factor=16.0), 8)}
PIPE_CHUNKS = (2, 3, 64, "auto")  # 64 > C clamps to one slot per strip


def _moe_rank(mesh, cases):
    """Every rank: the explicit layer per case, schedule and chunk count;
    the divisibility error; and the pipelined exchanges on integers."""
    out = {}
    for name, (cfg, p_np, x_np) in cases.items():
        p = jax.tree.map(torch.from_numpy, p_np)
        x = torch.from_numpy(x_np)
        chunks = CHUNKS if name == "main" else \
            ((2,) if name == "drops" else (1, "auto"))
        for s in A2A:
            for k in chunks:
                out[name, s, k] = MOE.apply_moe_explicit(
                    p, cfg, x, mesh, schedule=s, nchunks=k).numpy()
        if name == "main":
            shard = MOE.expert_shard(p, mesh)
            impl = MOE.make_moe_impl(cfg, mesh, schedule="chain")
            b = mesh.index("x")
            out["impl"] = impl(shard, x[b:b + 1]).numpy()
            eng = CollectiveEngine.for_mesh(mesh, schedule="auto")
            x_loc = x[b:b + 1]
            out["auto_engine"] = MOE.apply_moe_explicit(
                p, cfg, x, mesh, engine=eng, nchunks="auto").numpy()
            nbytes = cfg.num_experts * MOE._capacity(cfg, x.shape[1]) \
                * cfg.d_model * 4 * x_loc.shape[0]
            out["auto_names"] = [eng.schedule_for(
                "all_to_all_tiles", nbytes=nbytes, axis="x", callsite=cs)
                for cs in (MOE.DISPATCH_CALLSITE, MOE.COMBINE_CALLSITE)]
    cfg, p_np, x_np = cases["main"]
    bad = dataclasses.replace(cfg, num_experts=RING - 2)
    errs = []
    for fn in (lambda: MOE.make_apply_moe_explicit(bad, mesh),
               lambda: MOE.make_moe_impl(bad, mesh),
               lambda: MOE.apply_moe_explicit(
                   {k: v[:RING - 2] if k != "router" else v[:, :RING - 2]
                    for k, v in jax.tree.map(torch.from_numpy,
                                             p_np).items()},
                   bad, torch.from_numpy(x_np), mesh),
               lambda: MOE.expert_shard(
                   {k: torch.zeros((RING - 2, 1)) for k in
                    ("w_gate", "w_in", "w_out", "router")}, mesh)):
        try:
            fn()
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    out["errors"] = errs
    rng = np.random.default_rng(9)
    buf = torch.from_numpy(rng.integers(-8, 8, (RING, 2, 2 * RING, 5, 4))
                           .astype(np.float32)[mesh.index("x")])
    for s in A2A:
        eng = CollectiveEngine.for_mesh(mesh, schedule=s)
        for k in (1,) + PIPE_CHUNKS:
            d = MOE.exchange_dispatch(buf, "x", eng, nchunks=k)
            out["pipe", s, k] = (
                d.numpy(), MOE.exchange_combine(d, "x", eng,
                                                nchunks=k).numpy())
    out["pipe_in"] = buf.numpy()
    return out


@pytest.fixture(scope="module")
def dist():
    cases = {name: (cfg, *_dist_inputs(cfg, seed))
             for name, (cfg, seed) in DIST_CASES.items()}
    ranks = spawn_mesh(RING, _moe_rank, cases, axes=("x",), timeout=300)
    want = {}
    for name, (cfg, p_np, x_np) in cases.items():
        jaux = {}
        want[name] = (np.asarray(JMOE.apply_moe(p_np, _jcfg(cfg),
                                                jnp.asarray(x_np),
                                                aux=jaux)),
                      np.asarray(JMOE.reference_moe(p_np, _jcfg(cfg),
                                                    jnp.asarray(x_np))),
                      float(jaux["moe_dropped"]))
        want[name, "port"] = MOE.apply_moe(
            _t(p_np), cfg,
            torch.from_numpy(x_np)).numpy()
    return ranks, want


def _gathered(ranks, key):
    return np.concatenate([r[key] for r in ranks], axis=0)


@pytest.mark.parametrize("nchunks", CHUNKS)
@pytest.mark.parametrize("schedule", A2A)
def test_explicit_matches_reference_and_single_process(dist, schedule,
                                                       nchunks):
    ranks, want = dist
    out = _gathered(ranks, ("main", schedule, nchunks))
    apply_ref, oracle, dropped = want["main"]
    assert dropped == 0.0
    np.testing.assert_allclose(out, oracle, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(out, apply_ref, atol=1e-6, rtol=1e-6)
    # the shared routing, drops and combine order: the single-process layer
    # bit for bit
    np.testing.assert_array_equal(out, want["main", "port"])


def test_explicit_schedules_agree_bitwise(dist):
    ranks, _ = dist
    base = _gathered(ranks, ("main", "native", 1))
    for s in A2A:
        for k in CHUNKS:
            np.testing.assert_array_equal(
                _gathered(ranks, ("main", s, k)), base, err_msg=f"{s}/{k}")
    np.testing.assert_array_equal(_gathered(ranks, "impl"), base)


def test_explicit_auto_engine_resolves_registered(dist):
    ranks, want = dist
    np.testing.assert_allclose(_gathered(ranks, "auto_engine"),
                               want["main"][1], atol=1e-5, rtol=1e-4)
    for r in ranks:
        for name in r["auto_names"]:
            assert name != "auto" and name in A2A


@pytest.mark.parametrize("schedule", A2A)
def test_capacity_overflow_drops_match_single_process(dist, schedule):
    ranks, want = dist
    apply_ref, _, dropped = want["drops"]
    assert dropped > 0.0  # the edge case is exercised
    out = _gathered(ranks, ("drops", schedule, 2))
    np.testing.assert_allclose(out, apply_ref, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(out, want["drops", "port"])


@pytest.mark.parametrize("nchunks", [1, "auto"])
def test_single_expert_per_rank_top1(dist, nchunks):
    ranks, want = dist
    for s in A2A:
        np.testing.assert_allclose(_gathered(ranks, ("top1", s, nchunks)),
                                   want["top1"][1], atol=1e-5, rtol=1e-4)


def test_experts_must_divide_over_axis(dist):
    ranks, _ = dist
    for r in ranks:
        assert len(r["errors"]) == 4
        assert all(e is not None and "divisible" in e for e in r["errors"])


@pytest.mark.parametrize("schedule", A2A)
def test_pipelined_exchange_bit_identical_to_monolithic(dist, schedule):
    ranks, _ = dist
    for r in ranks:
        mono_d, mono = r["pipe", schedule, 1]
        np.testing.assert_array_equal(mono, r["pipe_in"])  # an identity
        assert mono_d.shape == (2 * RING, 2, 5, 4)  # (B, E_loc, C, D)
        for k in PIPE_CHUNKS:
            d, back = r["pipe", schedule, k]
            np.testing.assert_array_equal(d, mono_d, err_msg=str(k))
            np.testing.assert_array_equal(back, mono, err_msg=str(k))


def test_one_rank_explicit_path_is_the_layer():
    """On a one-rank ring every exchange is the identity: the explicit
    layer equals ``apply_moe`` bit for bit for every schedule."""
    cfg, seed = DIST_CASES["main"]
    p_np, x_np = _dist_inputs(cfg, seed)
    p, x = jax.tree.map(torch.from_numpy, p_np), torch.from_numpy(x_np)
    want = MOE.apply_moe(p, cfg, x)
    mesh = single_rank_mesh(("x",))
    for s in A2A:
        for k in CHUNKS:
            got = MOE.apply_moe_explicit(p, cfg, x, mesh, schedule=s,
                                         nchunks=k)
            assert torch.equal(got, want), (s, k)


# ---------------------------------------------------------------------------
# the autotune pattern
# ---------------------------------------------------------------------------


def test_paired_aliases_are_the_references_moe_entry():
    # every paired pattern of the reference, the decode one too
    assert autotune.PAIRED_ALIASES == jautotune.PAIRED_ALIASES
    assert autotune.PAIRED_ALIASES["all_to_all_tiles@moe.dispatch"] == \
        jautotune.PAIRED_ALIASES["all_to_all_tiles@moe.dispatch"]
    assert "all_to_all_tiles@moe.dispatch" in autotune.MEASURED_OPS
    assert autotune.table_keys(("all_to_all_tiles@moe.dispatch",)) == [
        "all_to_all_tiles@moe.dispatch", "all_to_all_tiles@moe.combine"]


def test_moe_pattern_measured_and_filed_under_combine():
    op = "all_to_all_tiles@moe.dispatch"
    table, record = autotune.autotune_mesh(ops=(op,), quick=True,
                                           device="cpu", verbose=False,
                                           timeout=240)
    assert set(table.entries) == {op, "all_to_all_tiles@moe.combine"}
    assert table.entries[op] == table.entries["all_to_all_tiles@moe.combine"]
    assert set(table.entries[op]) == {"ring[4]"}
    assert autotune.untimed(record, (1 << 10, 1 << 16), ops=(op,)) == []
    for rec in record.values():
        assert set(rec["times_s"]) == set(autotune.exact_schedules(op))
        assert all(t > 0 for t in rec["times_s"].values())
    cm = autotune.CostModel(hw=autotune.H100_80GB, table=table)
    ring = (autotune.AxisTopology("x", RING, "ring"),)
    for cs in ("moe.dispatch", "moe.combine"):
        assert cm.choose("all_to_all_tiles", 1 << 10, ring, callsite=cs) \
            == table.lookup("all_to_all_tiles", "ring[4]", 1 << 10,
                            callsite="moe.dispatch")
