"""The GSPMD placement of the MoE, SSM, vlm and encoder-decoder families on
a ``model`` axis wider than 1, on four gloo processes, held against the
JAX reference's one-device step and generation.

One world of four CPU processes builds the meshes 2x2 and 1x4 over
``('data', 'model')``. For each reduced family of :data:`ARCHS` (GQA with
2 KV heads where the family has attention, so that on 1x4 each rank takes
the KV block its q head maps to; the vlm's cross gates opened from a numpy
seed) every rank runs, from seed 0's state:

* two steps of ``make_train_step`` with ZeRO-1, and with ``fsdp``, on 2x2
  and on 1x4, the whole weights and AdamW moments gathered afterwards by
  rank 0;
* greedy ``generate`` of 4 prompts of 128 tokens on 2x2 and 1x4;
* for the MoE families, a prefill of its rows with a spy on
  ``apply_moe`` reading every layer's ``moe_dropped`` and
  ``moe_frac_tokens``, beside the same prefill with whole weights and no
  mesh; for qwen3-moe the fp32 paged decode step on 2x2 from identical
  pages against the one-rank paged step;
* for the SSM families, the shapes of its decode cache; for the vlm, a
  prefill with the cross gates closed again, whose logits must move.

A dense model whose ``d_ff`` (90) the 1x4 mesh does not divide runs its
MLP whole on every rank. The parent runs ``repro.train.step.
make_train_step`` on a one-device mesh and ``repro.train.serve``'s
prefill and decode steps in ``generate``'s greedy loop on the same
weights (``state_to_reference``, ``to_reference``) and holds the ranks to
``tests/test_torch_gspmd.py``'s limits, and the moments to
``tests/test_torch_train_step.py``'s. The reference is
imported inside functions only, so the spawned ranks do not import JAX.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch import sharding as sh
from repro_torch.comm.overlap import tree_flatten
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.launch.mesh import make_mesh, spawn_mesh
from repro_torch.models.model import (build_model, state_to_reference,
                                      to_reference)
from repro_torch.train.step import (gather_state, init_train_state,
                                    make_train_step, shard_state)

RANKS = 4
B, S, STEPS = 4, 32, 2
PROMPT, NEW = 128, 3
LIMITS = dict(loss_atol=1e-5, gn_rtol=1e-4, atol=2e-5, rtol=1e-4)
MOE_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/dist/test_moe.py:106
# AdamW's moments after the two steps (tests/test_torch_train_step.py)
MOMENT_ATOL = {"mu": 2e-5, "nu": 1e-6}
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
# arch -> (catalog name, layers, GQA with 2 KV heads, meshes)
ARCHS = {"qwen3-moe": ("qwen3-moe-235b-a22b", 2, True, ("2x2", "1x4")),
         "maverick": ("llama4-maverick-400b-a17b", 2, True, ("2x2", "1x4")),
         "jamba": ("jamba-1.5-large-398b", 4, True, ("2x2", "1x4")),
         "mamba2": ("mamba2-130m", 2, False, ("2x2", "1x4")),
         "vlm": ("llama-3.2-vision-90b", 2, True, ("2x2", "1x4")),
         "whisper": ("whisper-base", 2, True, ("2x2", "1x4")),
         "dense_ff90": ("llama3.2-3b", 2, True, ("1x4",))}
MOE_ARCHS = ("qwen3-moe", "maverick", "jamba")
SSM_ARCHS = ("jamba", "mamba2")
LEGS = [(a, m, f) for a, spec in ARCHS.items() for m in spec[3]
        for f in (False, True)]
PAGE, PAGES = 8, 40
# XLA's options for the reference's compiles: the same HLO with LLVM's
# backend optimizations off (tests/test_torch_train_step.py)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch):
    name, layers, gqa, _ = ARCHS[arch]
    cfg = configs.reduced(configs.get_config(name), layers=layers)
    if gqa:
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
    if arch == "dense_ff90":
        cfg = dataclasses.replace(cfg, d_ff=90)
    return cfg


def _run():
    return configs.RunConfig(learning_rate=1e-3, warmup_steps=1)


def _extras(cfg, rows, seed):
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (rows, cfg.num_patches, cfg.vision_dim)).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal(
            (rows, cfg.audio_ctx, cfg.d_model)).astype(np.float32)
    return out


def _batches(cfg):
    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, B, S))
    return [{**data.batch(s), **_extras(cfg, B, 10 + s)}
            for s in range(STEPS)]


def _prompts(cfg):
    g = torch.Generator().manual_seed(7)
    return torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=g,
                         dtype=torch.int32)


def _state(model):
    """Seed 0's state with the vlm's cross gates opened from a numpy
    seed (the init closes them, which hides the cross branch)."""
    state = init_train_state(model, 0, device="cpu")
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for blk in getattr(state.params, "blocks", []):
            if "cross_gate" in blk:
                blk["cross_gate"].fill_(float(rng.uniform(0.5, 1.0)))
    return state


def _leaves(tree):
    return [t.detach().numpy().copy() for t in tree_flatten(tree)[0]]


def _local(params, mesh):
    return type(params)(params.cfg, sh.cut(params.tree(), sh.param_specs(
        params, sh.rules_for(mesh), mesh), mesh))


def _rows(mesh, n=B):
    idx, k = sh.block_of(mesh, sh.rules_for(mesh).dp_spec)
    return slice(idx * n // k, (idx + 1) * n // k)


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------


def _steps(model, mesh, fsdp, batches):
    state = shard_state(_state(model), mesh, zero1=True, fsdp=fsdp)
    step = make_train_step(model, _run(), mesh, zero1=True, fsdp=fsdp)
    metrics = []
    for batch in batches:
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    whole = gather_state(state, model, mesh, zero1=True, fsdp=fsdp)
    if mesh.rank:
        return {"metrics": metrics, "params": None}
    return {"metrics": metrics, "params": _leaves(whole.params.tree()),
            "mu": _leaves(whole.opt["mu"]), "nu": _leaves(whole.opt["nu"])}


def _prefill(model, params, mesh, batch):
    from repro_torch.train.serve import make_prefill_step

    rows = len(batch["tokens"]) if mesh is None else B
    cache = model.init_cache(rows, PROMPT, torch.float32, device="cpu",
                             mesh=mesh)
    return make_prefill_step(model, mesh)(params, batch, cache)


def _moe_aux(model, params, mesh, batch):
    """Every MoE layer's (moe_frac_tokens, moe_dropped) in a prefill of
    ``batch`` on ``mesh`` (``params`` this rank's) through a spy on
    ``apply_moe``."""
    from repro_torch.models import moe as MOE

    rec, orig = [], MOE.apply_moe

    def spy(p, cfg, x, aux=None, shard=None):
        aux = {}
        out = orig(p, cfg, x, aux=aux, shard=shard)
        rec.append((aux["moe_frac_tokens"].numpy().copy(),
                    float(aux["moe_dropped"])))
        return out

    MOE.apply_moe = spy
    try:
        _prefill(model, params, mesh, batch)
    finally:
        MOE.apply_moe = orig
    return rec


def _paged(model, params, mesh):
    """The fp32 paged decode step on ``mesh`` from pages drawn from a seed
    (this rank's rows and KV heads) against the one-rank step on every
    row and head: (logits, want, pages, want pages) of this rank."""
    from repro_torch.models.kvcache import pool_heads
    from repro_torch.train.serve import (decode_rows, local_params,
                                         make_paged_decode_step)

    cfg = model.cfg
    g = torch.Generator().manual_seed(3)
    pages = {"layers": [{k: torch.randn((PAGES, PAGE, cfg.num_kv_heads,
                                         cfg.head_dim), generator=g)
                         for k in ("k_pages", "v_pages")}
                        for _ in range(cfg.num_layers)]}
    table = torch.arange(B * 4, dtype=torch.int32).reshape(B, 4)
    lengths = torch.tensor([5, 17, 30, 9], dtype=torch.int32)
    tokens = torch.randint(0, cfg.vocab_size, (B, 1), generator=g,
                           dtype=torch.int32)
    start, n = pool_heads(cfg, mesh)
    mine = {"layers": [{k: v[:, :, start:start + n].clone()
                        for k, v in lay.items()} for lay in pages["layers"]]}
    want, want_pages = make_paged_decode_step(model, None)(
        params, tokens, pages, table, lengths)
    rows = decode_rows(mesh, B)
    got, got_pages = make_paged_decode_step(model, mesh)(
        local_params(params, mesh), tokens[rows], mine, table[rows],
        lengths[rows])
    own = table[rows].flatten().long()  # the pages this rank's rows write
    return {"logits": got.numpy(), "want": want[rows].numpy(),
            "pages": [[v[own].numpy() for v in lay.values()]
                      for lay in got_pages["layers"]],
            "want_pages": [[v[own][:, :, start:start + n].numpy()
                            for v in lay.values()]
                           for lay in want_pages["layers"]]}


def _arch_rank(arch, meshes):
    from repro_torch.train.serve import generate

    cfg = _cfg(arch)
    model = build_model(cfg)
    batches = _batches(cfg)
    out = {"steps": {}, "generate": {}, "aux": {}, "cache": {}}
    for m in ARCHS[arch][3]:
        mesh = meshes[m]
        for fsdp in (False, True):
            out["steps"][(m, fsdp)] = _steps(model, mesh, fsdp, batches)
        params = _state(model).params
        params.requires_grad_(False)
        extras = _extras(cfg, B, 5)
        out["generate"][m] = generate(
            model, params, _prompts(cfg), max_new_tokens=NEW, mesh=mesh,
            extras=extras).numpy()
        rows = _rows(mesh)
        batch = {"tokens": _prompts(cfg)[rows],
                 **{k: torch.from_numpy(v[rows]) for k, v in extras.items()}}
        local = _local(params, mesh)
        if arch in MOE_ARCHS:
            out["aux"][m] = {"got": _moe_aux(model, local, mesh, batch),
                             "want": _moe_aux(model, params, None, batch)}
        if arch in SSM_ARCHS:
            cache = model.init_cache(B, PROMPT, torch.float32, device="cpu",
                                     mesh=mesh)
            out["cache"][m] = [{k: tuple(v.shape) for k, v in lay.items()}
                               for lay in cache["layers"]]
        if arch == "vlm":
            opened = _prefill(model, local, mesh, batch)[0]
            with torch.no_grad():
                for blk in local.blocks:
                    if "cross_gate" in blk:
                        blk["cross_gate"].zero_()
            out["closed_gate_moves"] = float(
                (opened - _prefill(model, local, mesh, batch)[0]).abs().max())
        if arch == "qwen3-moe" and m == "2x2":
            out["paged"] = _paged(model, params, mesh)
    return out


def _rank(_ring):
    meshes = {name: make_mesh(*spec) for name, spec in MESHES.items()}
    return {arch: _arch_rank(arch, meshes) for arch in ARCHS}


# ---------------------------------------------------------------------------
# the world and the reference
# ---------------------------------------------------------------------------


def _reference(arch):
    """The reference's two one-device steps (metrics, whole weights in the
    port's leaf order) and greedy generation from the same state."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models.model import build_model as jbuild_model
    from repro.train import serve as jserve
    from repro.train import step as jstep
    from repro_torch.models.model import from_reference

    cfg = _cfg(arch)
    model = build_model(cfg)
    state = _state(model)
    jmodel = jbuild_model(jconfigs.ModelConfig(**dataclasses.asdict(cfg)))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("x",))
    batches = _batches(cfg)
    st, metrics = jstep.TrainState(**state_to_reference(state)), []
    jfn = jstep.make_train_step(jmodel, jconfigs.RunConfig(
        **dataclasses.asdict(_run())), mesh, donate=False).lower(
        st, batches[0]).compile(compiler_options=FAST_COMPILE)
    for batch in batches:
        st, m = jfn(st, batch)
        st = jax.tree.map(np.asarray, st)
        metrics.append({k: float(v) for k, v in m.items()})
    params = _leaves(from_reference(cfg, st.params, device="cpu").tree())
    moments = {k: _leaves(from_reference(cfg, st.opt[k], device="cpu")
                          .tree()) for k in ("mu", "nu")}

    # repro.train.serve.generate's greedy loop over its prefill and decode
    # steps, each compiled under FAST_COMPILE
    jparams = to_reference(state.params)
    extras = {k: jnp.asarray(v) for k, v in _extras(cfg, B, 5).items()}
    prompts = jnp.asarray(_prompts(cfg).numpy())
    cache = jmodel.init_cache(B, PROMPT + NEW, jnp.float32)
    batch = {"tokens": prompts, **extras}
    prefill = jserve.make_prefill_step(jmodel).lower(
        jparams, batch, cache).compile(compiler_options=FAST_COMPILE)
    logits, cache = prefill(jparams, batch, cache)
    out = [prompts, jnp.argmax(logits[:, -1], axis=-1).astype(
        jnp.int32)[:, None]]
    extras.pop("frames", None)
    decode = None
    for _ in range(NEW - 1):
        if decode is None:
            decode = jserve.make_decode_step(jmodel).lower(
                jparams, out[-1], cache, extras).compile(
                compiler_options=FAST_COMPILE)
        logits, cache = decode(jparams, out[-1], cache, extras)
        out.append(jnp.argmax(logits[:, -1], axis=-1).astype(
            jnp.int32)[:, None])
    return {"metrics": metrics, "params": params, **moments,
            "tokens": np.asarray(jnp.concatenate(out, axis=1))}


@pytest.fixture(scope="module")
def world():
    """The ranks' world and the reference's runs side by side: the world
    waits on its processes and XLA compiles outside the GIL, so threads
    overlap them."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(4) as pool:
        ranks = pool.submit(spawn_mesh, RANKS, _rank, axes=("x",),
                            timeout=300)
        refs = {arch: pool.submit(_reference, arch) for arch in ARCHS}
        return {"ranks": ranks.result(),
                "ref": {arch: f.result() for arch, f in refs.items()}}


def _hold(got, want, tag):
    for g, w in zip(got["metrics"], want["metrics"]):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=0,
                                   atol=LIMITS["loss_atol"], err_msg=tag)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=LIMITS["gn_rtol"], err_msg=tag)
    if got["params"] is not None:
        assert len(got["params"]) == len(want["params"])
        for a, b in zip(got["params"], want["params"]):
            np.testing.assert_allclose(a, b, atol=LIMITS["atol"],
                                       rtol=LIMITS["rtol"], err_msg=tag)
        # AdamW's step is near lr sign(g), blind to a gradient's scale: the
        # moments hold the gradients themselves
        for k, atol in MOMENT_ATOL.items():
            for a, b in zip(got[k], want[k]):
                np.testing.assert_allclose(a, b, atol=atol, rtol=0,
                                           err_msg=f"{tag} {k}")


def _data_rows(mesh_name, g):
    (dp, tp), _ = MESHES[mesh_name]
    b = B // dp
    return slice((g // tp) * b, (g // tp + 1) * b)


# ---------------------------------------------------------------------------
# training and generation against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,mesh,fsdp", LEGS)
def test_step_matches_reference(world, arch, mesh, fsdp):
    tag = f"{arch} {mesh} {'fsdp' if fsdp else 'zero1'}"
    for rank in world["ranks"]:
        _hold(rank[arch]["steps"][(mesh, fsdp)], world["ref"][arch], tag)
    assert world["ranks"][0][arch]["steps"][(mesh, fsdp)]["params"] \
        is not None


@pytest.mark.parametrize("arch,mesh,fsdp", LEGS)
def test_ranks_agree_on_the_metrics(world, arch, mesh, fsdp):
    got = world["ranks"][0][arch]["steps"][(mesh, fsdp)]["metrics"]
    for rank in world["ranks"][1:]:
        assert rank[arch]["steps"][(mesh, fsdp)]["metrics"] == got


@pytest.mark.parametrize("arch,mesh", [(a, m) for a, s in ARCHS.items()
                                       for m in s[3]])
def test_generate_matches_reference(world, arch, mesh):
    want = world["ref"][arch]["tokens"]
    for g, rank in enumerate(world["ranks"]):
        got = rank[arch]["generate"][mesh]
        rows = _data_rows(mesh, g)
        assert got.shape == (rows.stop - rows.start, PROMPT + NEW)
        np.testing.assert_array_equal(got, want[rows])


# ---------------------------------------------------------------------------
# the MoE's routing, the paged decode, the SSM cache, the vlm's gates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,mesh", [(a, m) for a in MOE_ARCHS
                                       for m in ARCHS[a][3]])
def test_moe_routing_is_the_one_device_layers(world, arch, mesh):
    """Every rank's ``moe_dropped`` and ``moe_frac_tokens`` equal the
    whole layer's on the same rows, in every MoE layer."""
    for rank in world["ranks"]:
        rec = rank[arch]["aux"][mesh]
        assert len(rec["got"]) == len(rec["want"]) == sum(
            _cfg(arch).moe_layer_mask())
        for (gf, gd), (wf, wd) in zip(rec["got"], rec["want"]):
            assert gd == wd
            np.testing.assert_array_equal(gf, wf)


def test_moe_paged_decode_matches_one_rank(world):
    for rank in world["ranks"]:
        rec = rank["qwen3-moe"]["paged"]
        np.testing.assert_allclose(rec["logits"], rec["want"],
                                   **MOE_TOL)
        for got, want in zip(rec["pages"], rec["want_pages"]):
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, **MOE_TOL)


@pytest.mark.parametrize("arch,mesh", [(a, m) for a in SSM_ARCHS
                                       for m in ARCHS[a][3]])
def test_ssm_cache_holds_this_ranks_heads(world, arch, mesh):
    from repro_torch.models.ssm import ssm_dims

    cfg = _cfg(arch)
    (dp, tp), _ = MESHES[mesh]
    d_in, H, P, G, N = ssm_dims(cfg)
    K = cfg.ssm_conv - 1
    want_ssm = {"conv_x": (B // dp, K, d_in // tp),
                "conv_bc": (B // dp, K, 2 * G * N),
                "state": (B // dp, H // tp, P, N)}
    for rank in world["ranks"]:
        layers = rank[arch]["cache"][mesh]
        kinds = cfg.layer_kinds()
        assert [lay for lay, k in zip(layers, kinds) if k != "attn"] == \
            [want_ssm] * sum(k != "attn" for k in kinds)


def test_vlm_cross_branch_runs_under_tp(world):
    """Closing the cross gates again moves the logits: the cross branch
    ran on every rank's heads."""
    for rank in world["ranks"]:
        assert rank["vlm"]["closed_gate_moves"] > 1e-3


def test_ssd_backward_is_finite_where_the_decay_overflows():
    """The chunked SSD's intra-chunk decay past the diagonal overflows when
    a chunk's summed dt * A passes ~88 (mamba2-130m's chunks of 256 at
    full size); masked before its exp, the values equal the sequential
    recurrence's and the gradients stay finite, where a mask after the exp
    backpropagates 0 * inf = NaN."""
    from repro_torch.models.ssm import ssd_chunked, ssd_reference

    g = torch.Generator().manual_seed(0)
    b, L, H, P, N = 1, 64, 2, 4, 8
    x = torch.randn((b, L, H, P), generator=g, requires_grad=True)
    dt = torch.full((b, L, H), 0.1, requires_grad=True)
    A = torch.tensor([-30.0, -1.0])
    B = torch.randn((b, L, 1, N), generator=g)
    C = torch.randn((b, L, 1, N), generator=g)
    y, h = ssd_chunked(x, dt, A, B, C, chunk=64)
    want_y, want_h = ssd_reference(x.detach(), dt.detach(), A, B, C)
    np.testing.assert_allclose(y.detach().numpy(), want_y.numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(h.detach().numpy(), want_h.numpy(),
                               rtol=1e-4, atol=1e-5)
    (y.square().sum() + h.sum()).backward()
    assert torch.isfinite(x.grad).all() and torch.isfinite(dt.grad).all()
