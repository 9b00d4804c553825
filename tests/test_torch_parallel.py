"""The port's explicit whole-model path on four gloo processes, held against
the JAX reference's one-device step on the global batch.

One world of four CPU processes (``spawn_mesh``, a ring ``x``) runs:

* the engine's differentiable exchanges, per engine schedule ``native``,
  ``chain``, ``rs_ag`` (not registered for these ops: it falls back to the
  cost model) and ``"auto"`` on an explicit ``CostModel(hw=H100_80GB)``:
  the backward of ``all_to_all_tiles`` (two axis pairs, and pipelined in
  three strips) and of ``ring_exchange`` equals the inverse exchange of
  the cotangent bit for bit, and both equal what every rank's seeded
  inputs say they must be;
* the ``tp`` and ``sp`` attention hooks (GQA 8 heads on 4 KV heads, 16
  tokens) against the port's plain ``attention`` on the gathered batch:
  the output and the q/k/v gradients of this rank's rows;
* ``make_whole_model_train_step_explicit`` on reduced qwen3-moe
  (``tiny(4, layers=2)``: one expert per rank, 8 heads, capacity factor 2
  so that nothing drops) for each mode x engine schedule ``native`` /
  ``chain`` x ``nchunks`` 1 / ``"auto"``, two steps from one state (lr
  1e-3 after one warmup step, so that the second step moves the weights);
* the explicit ``train_loop`` smoke in both modes.

The parent runs ``repro.train.step.make_train_step`` on a one-device mesh
on the global batch (4 rows x 16 tokens) from the same state
(``state_to_reference``), and holds every explicit run to the reference's
limits (``tests/dist/test_transformer.py:79-124``): loss atol 1e-5,
``grad_norm`` rtol 1e-4, weights atol 2e-5 rtol 1e-4; and the two modes to
each other at the same limits. The reference is imported inside functions
only, so the spawned ranks do not import JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.comm import autotune
from repro_torch.comm.autotune import CostModel
from repro_torch.comm.callsites import SP_KV, SP_OUT, SP_QKV, TP_OUT, TP_QKV
from repro_torch.comm.engine import CollectiveEngine
from repro_torch.comm.overlap import tree_flatten
from repro_torch.comm.topology import MeshTopology
from repro_torch.comm.types import H100_80GB
from repro_torch.configs.qwen3_moe_235b_a22b import tiny
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.launch.mesh import MeshAxis, ProcessMesh, spawn_mesh
from repro_torch.models import layers as L
from repro_torch.models.model import (build_model, state_from_reference,
                                      state_to_reference)
from repro_torch.models.parallel import ATTN_MODES, make_attn_impl
from repro_torch.train.loop import TrainLoopConfig, train_loop
from repro_torch.train.step import (gather_whole_model_state,
                                    init_train_state,
                                    make_whole_model_train_step_explicit,
                                    shard_whole_model_state)

RANKS = 4
B, S = RANKS, 16
STEPS = 2
SCHEDULES = ("native", "chain", "rs_ag", "auto")
STEP_SCHEDULES = ("native", "chain")
CHUNKS = (1, "auto")
LIMITS = dict(loss_atol=1e-5, gn_rtol=1e-4, atol=2e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's tiny models: under six test
    workers the default (one thread per core in every process)
    oversubscribes the cores and slows each small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(layers=2):
    return tiny(RANKS, layers=layers)


def _run():
    return configs.RunConfig(learning_rate=1e-3, warmup_steps=1)


def _batches():
    cfg = _cfg()
    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, B, S))
    return [data.batch(s) for s in range(STEPS)]


def _start():
    return state_to_reference(init_train_state(build_model(_cfg()), 0,
                                               device="cpu"))


def _seeded(rank, tag, shape):
    g = torch.Generator().manual_seed(1000 * tag + rank)
    return torch.randn(shape, generator=g)


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------


def _exchange_checks(mesh):
    """Per schedule: (forward exact, backward == the expected cotangent
    route, backward == the inverse exchange) for each exchange."""
    r = mesh.axis("x").index
    out = {}
    for name in SCHEDULES:
        eng = CollectiveEngine.for_mesh(mesh, schedule=name,
                                        cost_model=CostModel(hw=H100_80GB))
        checks = {}
        # all_to_all_tiles: (B_loc=2, 8, 3) split 1 / concat 0, and the
        # 4-d (2, 4, 8, 3) split 2 / concat 1
        for tag, shape, a, b in ((1, (2, 8, 3), 1, 0),
                                 (2, (2, 4, 8, 3), 2, 1)):
            xs = [_seeded(i, tag, shape) for i in range(RANKS)]
            cs = [_seeded(i, tag + 10, _a2a_shape(shape, a, b))
                  for i in range(RANKS)]
            x = xs[r].clone().requires_grad_(True)
            y = eng.all_to_all_tiles(x, "x", split_axis=a, concat_axis=b)
            y.backward(cs[r])
            want_y = torch.cat([t.chunk(RANKS, a)[r] for t in xs], b)
            want_g = torch.cat([t.chunk(RANKS, b)[r] for t in cs], a)
            inv = eng.all_to_all_tiles(cs[r], "x", split_axis=b,
                                       concat_axis=a)
            checks[f"a2a{tag}"] = (torch.equal(y.detach(), want_y),
                                   torch.equal(x.grad, want_g),
                                   torch.equal(x.grad, inv))
        # the MoE dispatch's pipelined form: three capacity strips
        xs = [_seeded(i, 3, (1, 8, 5, 2)) for i in range(RANKS)]
        cs = [_seeded(i, 13, (4, 2, 5, 2)) for i in range(RANKS)]
        x = xs[r].clone().requires_grad_(True)
        y = eng.pipelined("all_to_all_tiles", x, "x", nchunks=3,
                          split_axis=2, tile_split_axis=1,
                          tile_concat_axis=0)
        y.backward(cs[r])
        want_g = torch.cat([t.chunk(RANKS, 0)[r] for t in cs], 1)
        inv = eng.all_to_all_tiles(cs[r], "x", split_axis=0, concat_axis=1)
        checks["pipelined"] = (True, torch.equal(x.grad, want_g),
                               torch.equal(x.grad, inv))
        # ring_exchange: recv_from_left is rank r-1's x_fwd, recv_from_right
        # rank r+1's x_bwd; their cotangents travel back
        f = [_seeded(i, 4, (3, 6)) for i in range(RANKS)]
        bw = [_seeded(i, 5, (3, 6)) for i in range(RANKS)]
        cl = [_seeded(i, 14, (3, 6)) for i in range(RANKS)]
        cr = [_seeded(i, 15, (3, 6)) for i in range(RANKS)]
        xf = f[r].clone().requires_grad_(True)
        xb = bw[r].clone().requires_grad_(True)
        left, right = eng.ring_exchange(xf, xb, "x")
        ((left * cl[r]).sum() + (right * cr[r]).sum()).backward()
        back_l, back_r = eng.ring_exchange(cr[r], cl[r], "x")
        checks["ring"] = (
            torch.equal(left.detach(), f[(r - 1) % RANKS])
            and torch.equal(right.detach(), bw[(r + 1) % RANKS]),
            torch.equal(xf.grad, cl[(r + 1) % RANKS])
            and torch.equal(xb.grad, cr[(r - 1) % RANKS]),
            torch.equal(xf.grad, back_r) and torch.equal(xb.grad, back_l))
        out[name] = checks
    return out


def _a2a_shape(shape, a, b):
    s = list(shape)
    s[b] *= RANKS
    s[a] //= RANKS
    return tuple(s)


HOOK = dict(B=4, S=16, H=8, KV=4, hd=8)


def _hook_inputs():
    p = HOOK
    q = _seeded(0, 20, (p["B"], p["S"], p["H"], p["hd"]))
    k = _seeded(0, 21, (p["B"], p["S"], p["KV"], p["hd"]))
    v = _seeded(0, 22, (p["B"], p["S"], p["KV"], p["hd"]))
    cot = _seeded(0, 23, (p["B"], p["S"], p["H"], p["hd"]))
    return q, k, v, cot


def _hook_checks(mesh):
    """Each mode's output and q/k/v gradients on this rank's rows."""
    cfg = dataclasses.replace(_cfg(), num_heads=HOOK["H"],
                              num_kv_heads=HOOK["KV"], head_dim=HOOK["hd"])
    r = mesh.axis("x").index
    b = HOOK["B"] // RANKS
    rows = slice(r * b, (r + 1) * b)
    q, k, v, cot = _hook_inputs()
    out = {}
    for mode in ATTN_MODES:
        eng = CollectiveEngine.for_mesh(mesh, schedule="native",
                                        cost_model=CostModel(hw=H100_80GB))
        impl = make_attn_impl(mode, cfg, mesh, engine=eng)
        ql, kl, vl = (t[rows].clone().requires_grad_(True) for t in (q, k, v))
        o = impl(ql, kl, vl, causal=True)
        (o * cot[rows]).sum().backward()
        out[mode] = [t.detach().numpy() for t in (o, ql.grad, kl.grad,
                                                  vl.grad)]
    return out


def _step_runs(mesh):
    """Every mode x schedule x nchunks: STEPS steps of the explicit step
    from the same state, metrics on every rank and the whole weights
    (gathered) from rank 0."""
    cfg = _cfg()
    model = build_model(cfg)
    state_np, batches = _start(), _batches()
    out = {}
    for mode in ATTN_MODES:
        for name in STEP_SCHEDULES:
            for nchunks in CHUNKS:
                state = shard_whole_model_state(
                    state_from_reference(cfg, state_np, device="cpu"), mesh)
                step = make_whole_model_train_step_explicit(
                    model, _run(), mesh, attn_mode=mode, schedule_kind=name,
                    nchunks=nchunks, cost_model=CostModel(hw=H100_80GB))
                metrics = []
                for batch in batches:
                    state, m = step(state, batch)
                    metrics.append({k: float(v) for k, v in m.items()})
                whole = gather_whole_model_state(state, mesh)
                out[mode, name, nchunks] = {
                    "metrics": metrics,
                    "params": (state_to_reference(whole)["params"]
                               if mesh.rank == 0 else None)}
    return out


def _loop_smoke(mesh):
    cfg = _cfg(layers=1)
    out = {}
    for mode in ("explicit_tp", "explicit_sp"):
        hist = train_loop(cfg, _run(), DataConfig(cfg.vocab_size, B, S),
                          TrainLoopConfig(steps=3, log_every=1,
                                          step_mode=mode),
                          mesh=mesh, device="cpu")
        out[mode] = hist["loss"]
    return out


def _rank(mesh):
    return {"exchange": _exchange_checks(mesh), "hooks": _hook_checks(mesh),
            "steps": _step_runs(mesh), "loop": _loop_smoke(mesh)}


# ---------------------------------------------------------------------------
# the world and the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    ranks = spawn_mesh(RANKS, _rank, axes=("x",), timeout=300)

    import jax

    from repro import configs as jconfigs
    from repro.models.model import build_model as jbuild_model
    from repro.train import step as jstep

    cfg = _cfg()
    state_np = _start()
    jmodel = jbuild_model(jconfigs.ModelConfig(**dataclasses.asdict(cfg)))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("x",))
    batches = _batches()
    st, ref = jstep.TrainState(**state_np), []
    jfn = jstep.make_train_step(jmodel, jconfigs.RunConfig(
        **dataclasses.asdict(_run())), mesh, donate=False).lower(
        st, batches[0]).compile(compiler_options={
            "xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True})
    for batch in batches:
        st, m = jfn(st, batch)
        st = jax.tree.map(np.asarray, st)
        ref.append({k: float(v) for k, v in m.items()})
    return dict(ranks=ranks, ref=ref, ref_params=st.params)


def _leaves(tree):
    return tree_flatten(tree)[0]


def _hold(got_metrics, got_params, want_metrics, want_params, tag):
    for g, w in zip(got_metrics, want_metrics):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=0,
                                   atol=LIMITS["loss_atol"], err_msg=tag)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=LIMITS["gn_rtol"], err_msg=tag)
    if got_params is not None:
        for a, b in zip(_leaves(got_params), _leaves(want_params)):
            np.testing.assert_allclose(a, b, atol=LIMITS["atol"],
                                       rtol=LIMITS["rtol"], err_msg=tag)


# ---------------------------------------------------------------------------
# the exchanges under autograd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("exchange", ["a2a1", "a2a2", "pipelined", "ring"])
def test_exchange_backward_is_the_inverse_exchange(world, schedule,
                                                   exchange):
    for rank in world["ranks"]:
        fwd, route, inverse = rank["exchange"][schedule][exchange]
        assert fwd and route and inverse, (schedule, exchange)


# ---------------------------------------------------------------------------
# the attention hooks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ATTN_MODES)
def test_hook_matches_plain_attention_on_the_gathered_batch(world, mode):
    q, k, v, cot = _hook_inputs()
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = L.attention(*ts, causal=True)
    (o * cot).sum().backward()
    want = [o.detach()] + [t.grad for t in ts]
    b = HOOK["B"] // RANKS
    for r, rank in enumerate(world["ranks"]):
        for got, w in zip(rank["hooks"][mode], want):
            np.testing.assert_allclose(got, w[r * b:(r + 1) * b].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=mode)


def test_tp_hook_output_is_bitwise_plain_attention(world):
    """tp moves whole heads only: its output is the dense attention's."""
    q, k, v, _ = _hook_inputs()
    want = L.attention(q, k, v, causal=True).numpy()
    b = HOOK["B"] // RANKS
    for r, rank in enumerate(world["ranks"]):
        np.testing.assert_array_equal(rank["hooks"]["tp"][0],
                                      want[r * b:(r + 1) * b])


# ---------------------------------------------------------------------------
# the whole-model step against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ATTN_MODES)
@pytest.mark.parametrize("schedule", STEP_SCHEDULES)
@pytest.mark.parametrize("nchunks", CHUNKS)
def test_whole_model_matches_reference(world, mode, schedule, nchunks):
    tag = f"{mode}/{schedule}/nchunks={nchunks}"
    for rank in world["ranks"]:
        got = rank["steps"][mode, schedule, nchunks]
        _hold(got["metrics"], got["params"], world["ref"],
              world["ref_params"], tag)
    assert world["ranks"][0]["steps"][mode, schedule, nchunks]["params"] \
        is not None


def test_modes_agree_with_each_other(world):
    rank0 = world["ranks"][0]["steps"]
    tp, sp = rank0["tp", "native", 1], rank0["sp", "native", 1]
    _hold(sp["metrics"], sp["params"], tp["metrics"], tp["params"], "tp/sp")


def test_ranks_agree_on_the_metrics(world):
    """On ``native`` every rank reduces in the library's one order; ``chain``
    adds in a different order on every rank and is not held to this."""
    for key, got in world["ranks"][0]["steps"].items():
        if key[1] != "native":
            continue
        for rank in world["ranks"][1:]:
            assert rank["steps"][key]["metrics"] == got["metrics"], key


# ---------------------------------------------------------------------------
# validation errors
# ---------------------------------------------------------------------------


def _ring():
    return ProcessMesh(axes=(MeshAxis("x", RANKS, 0, tuple(range(RANKS))),))


def test_indivisible_heads_raise():
    cfg = dataclasses.replace(_cfg(), num_heads=2, num_kv_heads=2,
                              head_dim=32)  # 2 heads over 4 ranks
    with pytest.raises(ValueError, match="divisible"):
        make_attn_impl("tp", cfg, _ring())


def test_indivisible_sequence_raises():
    impl = make_attn_impl("sp", _cfg(), _ring())
    q = torch.zeros(1, 6, 8, 8)
    with pytest.raises(ValueError, match="divisible"):
        impl(q, q, q, causal=True)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown attention mode"):
        make_attn_impl("pp", _cfg(), _ring())


def test_grad_compression_rejected():
    run = configs.RunConfig(learning_rate=1e-3, warmup_steps=1,
                            grad_compression="int8_ef")
    with pytest.raises(ValueError, match="grad_compression"):
        make_whole_model_train_step_explicit(build_model(_cfg()), run,
                                             _ring())


def test_encoder_decoder_rejected():
    cfg = configs.reduced(configs.get_config("whisper-base"), layers=2)
    with pytest.raises(ValueError, match="decoder-only"):
        make_whole_model_train_step_explicit(build_model(cfg), _run(),
                                             _ring())


# ---------------------------------------------------------------------------
# the explicit train_loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step_mode", ["explicit_tp", "explicit_sp"])
def test_train_loop_explicit_smoke(world, step_mode):
    for rank in world["ranks"]:
        losses = rank["loop"][step_mode]
        assert len(losses) == 3 and all(np.isfinite(losses))
    assert len({tuple(r["loop"][step_mode]) for r in world["ranks"]}) == 1


# ---------------------------------------------------------------------------
# the autotune patterns of the attention exchanges
# ---------------------------------------------------------------------------

PATTERNS = ("all_to_all_tiles@tp.qkv", "all_to_all_tiles@sp.qkv")


def test_attention_patterns_and_aliases_are_the_references():
    from repro.comm import autotune as jautotune

    for op in PATTERNS:
        assert op in autotune.MEASURED_OPS
        assert autotune.PAIRED_ALIASES[op] == jautotune.PAIRED_ALIASES[op]
        assert autotune.table_keys((op,)) == [
            op, *jautotune.PAIRED_ALIASES[op]]


def test_attention_callsites_resolve_as_the_reference_cost_model():
    """On the port's constants, with no table and with one that files a
    pattern's winner under its alias, every attention callsite resolves as
    the reference's ``CostModel`` does."""
    import types

    from repro.comm import autotune as jautotune
    from repro.comm import topology as jtopology
    from repro.comm import types as jtypes

    ring = MeshTopology.from_mesh(types.SimpleNamespace(
        shape={"x": RANKS})).axis("x")
    jring = jtopology.AxisTopology(**dataclasses.asdict(ring))
    sig = autotune.axis_signature([ring])
    bands = [(1 << 12, "chain"), (None, "staged")]
    table, jtable = autotune.TuningTable(), jautotune.TuningTable()
    for op in PATTERNS:
        for key in autotune.table_keys((op,)):
            table.set(key, sig, bands)
            jtable.set(key, sig, bands)
    calls = [("all_to_all_tiles", cs) for cs in (TP_QKV, TP_OUT, SP_QKV,
                                                 SP_OUT)]
    calls.append(("ring_exchange", SP_KV))
    for tab, jtab in ((None, None), (table, jtable)):
        port = CostModel(hw=H100_80GB, table=tab)
        ref = jautotune.CostModel(hw=jtypes.HardwareModel(
            **dataclasses.asdict(H100_80GB)), table=jtab)
        for op, cs in calls:
            for n in (1 << 10, 1 << 14, 1 << 18, 1 << 22, 1 << 26):
                got = port.choose(op, n, (ring,), callsite=cs)
                assert got == ref.choose(op, n, (jring,), callsite=cs), \
                    (op, cs, n, tab is not None)
                if tab is not None and op == "all_to_all_tiles":
                    assert got == ("chain" if n <= 1 << 12 else "staged")


def test_attention_patterns_run_one_measurement():
    """Each pattern's body, on a one-rank mesh (no wire), runs and gives
    its pattern's output shape."""
    from repro_torch.launch.mesh import single_rank_mesh

    mesh = single_rank_mesh(("x",))
    eng = CollectiveEngine.for_mesh(mesh, cost_model=CostModel(hw=H100_80GB))
    for op in PATTERNS:
        out = autotune._op_body(eng, mesh, op, 1 << 10,
                                torch.device("cpu"))()
        assert out.shape == (1, 1, 256) and torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# tree walks hold no reference cycle
# ---------------------------------------------------------------------------


def test_tree_walks_leave_no_reference_cycle():
    """Flattening, unflattening and listing a checkpoint's leaves keep no
    leaf alive once the caller drops the results: a nested recursive
    helper (a cycle through its own closure cell) kept a whole training
    state on the card until the garbage collector ran, and the four ranks
    of the whole-model phase ran out of memory at the next leg."""
    import gc
    import weakref

    from repro_torch.checkpoint import manager
    from repro_torch.comm.overlap import tree_unflatten

    gc.disable()
    try:
        for walk in (lambda t: tree_unflatten(*reversed(tree_flatten(t))),
                     manager._leaves):
            leaf = torch.zeros(3)
            ref = weakref.ref(leaf)
            out = walk({"a": [leaf, None, (torch.ones(1),)], "b": {}})
            del leaf, out
            assert ref() is None
    finally:
        gc.enable()
