"""The port's sharding rules against the reference's, on stand-in meshes.

Every spec function of ``repro_torch.sharding`` is called beside its
``repro.sharding`` counterpart on the same stand-in mesh (an object with
``shape`` and ``axis_names``, all that the reference's rules read), at
the production shapes ``(16, 16)`` ``('data', 'model')`` and ``(2, 16,
16)`` ``('pod', 'data', 'model')`` and at small ones:

* ``rules_for`` with and without ``seq_shard`` and ``fsdp``;
* ``activation_spec`` for every name;
* ``param_specs`` (and with ``fsdp``) and ``opt_state_specs`` for every
  architecture of the catalog at full size: the reference's shapes from
  ``jax.eval_shape(model.init)``, the port's from ``model.init(device=
  "meta")``. A reference block leaf carries a leading super-block scan
  dimension that the port's per-layer list does not have: its spec's
  first entry must be None, and the rest is the port's. The one stated
  difference: where ``model`` does not divide the SSM heads the port
  keeps every SSM weight whole (:func:`_ssm_kept_whole`);
* ``zero1_spec`` with and without ``skip_first``;
* ``batch_specs``;
* ``cache_specs`` in both ``kv_fallback`` modes, with KV heads that do
  and do not divide ``tp`` and ``seq_shard`` with B = 1.

No gloo world: every case is a pure function of shapes.
"""
from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import sharding as jsh
from repro.models.model import build_model as jbuild_model
from repro_torch import configs
from repro_torch import sharding as sh
from repro_torch.comm.overlap import tree_flatten
from repro_torch.models import transformer
from repro_torch.models.model import build_model

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "ring4": ((4,), ("x",))}
PRODUCTION = ("16x16", "2x16x16")
ACTIVATIONS = ("residual", "logits", "ffn", "heads", "moe_buf", "moe_tokens",
               "other")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(name):
    shape, names = MESHES[name]
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)


def _spec(x):
    """A reference ``PartitionSpec`` or a port ``LeafSpec`` as a tuple."""
    return tuple(x.dims) if isinstance(x, sh.LeafSpec) else tuple(x)


def _ref_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rules_for(mesh, seq_shard, fsdp):
    m = _mesh(mesh)
    got = sh.rules_for(m, seq_shard=seq_shard, fsdp=fsdp)
    want = jsh.rules_for(m, seq_shard=seq_shard, fsdp=fsdp)
    assert (got.dp, got.tp, got.sp, got.fsdp, got.dp_spec) == \
        (want.dp, want.tp, want.sp, want.fsdp, want.dp_spec)


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", ACTIVATIONS)
def test_activation_spec(name, mesh, seq_shard):
    m = _mesh(mesh)
    got = sh.activation_spec(name, sh.rules_for(m, seq_shard=seq_shard))
    want = jsh.activation_spec(name, jsh.rules_for(m, seq_shard=seq_shard))
    assert _spec(got) == _spec(want)


# ---------------------------------------------------------------------------
# parameter and optimizer-state specs over the catalog at full size
# ---------------------------------------------------------------------------


_SHAPES = {}


def _shapes(arch):
    """(port meta weights, reference abstract weights) at full size."""
    if arch not in _SHAPES:
        cfg = configs.get_config(arch)
        jmodel = jbuild_model(jconfigs.get_config(arch))
        _SHAPES[arch] = (build_model(cfg).init(device="meta"),
                         jax.eval_shape(jmodel.init, jax.random.key(0)))
    return _SHAPES[arch]


def _ref_in_port_layout(cfg, tree):
    """The reference's spec tree in the port's layout: block leaf specs
    (stacked over super-blocks, or over layers for the encoder-decoder)
    without their scan entry, which must be None."""
    def drop(spec):
        s = _spec(spec)
        assert s[0] is None, f"the reference splits a scan dimension: {s}"
        return s[1:]

    def strip(node):
        if isinstance(node, dict):
            return {k: strip(v) for k, v in node.items()}
        return drop(node)

    def plain(node):
        if isinstance(node, dict):
            return {k: plain(v) for k, v in node.items()}
        return _spec(node)

    out = {k: plain(v) for k, v in tree.items()
           if k not in ("blocks", "enc_blocks", "dec_blocks")}
    if cfg.is_encoder_decoder:
        out["enc_blocks"] = [strip(tree["enc_blocks"])
                             for _ in range(cfg.num_encoder_layers)]
        out["dec_blocks"] = [strip(tree["dec_blocks"])
                             for _ in range(cfg.num_layers)]
    else:
        period = transformer.period_of(cfg)
        out["blocks"] = [strip(tree["blocks"][f"p{i % period}"])
                         for i in range(cfg.num_layers)]
    return out


def _ssm_kept_whole(cfg, m, want, params, spec_of):
    """The port's one stated difference in ``want`` (the reference's tree
    in the port's layout): where ``model`` does not divide the SSM heads
    (mamba2-130m's 24 on 16) every SSM weight stays whole, since the
    port's SSM layer splits whole heads only (the reference cuts ``d_in``
    inside a head); ``spec_of(shape)`` gives such a leaf's spec, FSDP's or
    ZeRO-1's dp split of the whole per-layer leaf by the reference's
    ``zero1_spec``."""
    from repro_torch.models.ssm import ssm_dims

    if not cfg.ssm_state or ssm_dims(cfg)[1] % m.shape["model"] == 0:
        return want
    for blk, pblk in zip(want["blocks"], params.tree()["blocks"]):
        if "ssm" in blk:
            blk["ssm"] = {k: spec_of(tuple(v.shape))
                          for k, v in pblk["ssm"].items()}
    return want


def _whole_then(rules, m):
    """``spec_of`` for :func:`_ssm_kept_whole`: a whole leaf, then the
    reference's dp split of it under ``rules`` (none without a dp split
    to make)."""
    def spec_of(shape):
        whole = jax.sharding.PartitionSpec(*(None,) * len(shape))
        return _spec(jsh.zero1_spec(whole, shape, rules, m)) \
            if rules is not None else _spec(whole)
    return spec_of


def _port_specs(tree):
    return [_spec(s) for s in tree_flatten(tree)[0]]


def _flat_tuples(tree):
    # tree_flatten walks into tuples: flatten the reference's spec tuples
    # as whole leaves instead
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, list):
            for v in node:
                walk(v)
        else:
            leaves.append(node)
    walk(tree)
    return leaves


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh", PRODUCTION)
@pytest.mark.parametrize("arch", configs.list_archs())
def test_param_specs(arch, mesh, fsdp):
    cfg = configs.get_config(arch)
    params, jparams = _shapes(arch)
    m = _mesh(mesh)
    got = _port_specs(sh.param_specs(params, sh.rules_for(m, fsdp=fsdp), m))
    want = _flat_tuples(_ssm_kept_whole(cfg, m, _ref_in_port_layout(
        cfg, jsh.param_specs(jparams, jsh.rules_for(m, fsdp=fsdp), m)),
        params, _whole_then(jsh.rules_for(m, fsdp=True) if fsdp else None,
                            m)))
    assert len(got) == len(want) == len(tree_flatten(params.tree())[0])
    assert got == want


@pytest.mark.parametrize("zero1", [True, False])
@pytest.mark.parametrize("mesh", PRODUCTION)
@pytest.mark.parametrize("arch", configs.list_archs())
def test_opt_state_specs(arch, mesh, zero1):
    cfg = configs.get_config(arch)
    params, jparams = _shapes(arch)
    m = _mesh(mesh)
    got = _port_specs(sh.opt_state_specs(params, sh.rules_for(m), m,
                                         zero1=zero1))
    want = _flat_tuples(_ssm_kept_whole(cfg, m, _ref_in_port_layout(
        cfg, jsh.opt_state_specs(jparams, jsh.rules_for(m), m,
                                 zero1=zero1)),
        params, _whole_then(jsh.rules_for(m) if zero1 else None, m)))
    assert got == want


ZERO1_CASES = [((None, "model", None), (4096, 32, 128)),
               ((None, None), (48, 4096)),
               (("model", None), (4096, 8192)),
               ((None,), (7,)),
               ((("pod", "data"), None), (64, 64)),
               ((None, None, None), (32, 16, 16))]


def _names_of(spec):
    return {a for e in spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))}


# every case on every mesh that has the axes its spec names
ZERO1_GRID = [(c, m) for c, (spec, _) in enumerate(ZERO1_CASES)
              for m in sorted(MESHES)
              if _names_of(spec) <= set(MESHES[m][1])]


@pytest.mark.parametrize("skip_first", [False, True])
@pytest.mark.parametrize("case,mesh", ZERO1_GRID)
def test_zero1_spec(case, mesh, skip_first):
    spec, shape = ZERO1_CASES[case]
    m = _mesh(mesh)
    got = sh.zero1_spec(sh.LeafSpec(spec), shape, sh.rules_for(m), m,
                        skip_first=skip_first)
    want = jsh.zero1_spec(jax.sharding.PartitionSpec(*spec), shape,
                          jsh.rules_for(m), m, skip_first=skip_first)
    assert _spec(got) == _spec(want)


# ---------------------------------------------------------------------------
# batch and cache specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("rows", [1, 4, 16, 48, 64])
def test_batch_specs(rows, mesh):
    m = _mesh(mesh)
    batch = {"tokens": jax.ShapeDtypeStruct((rows, 128), jnp.int32),
             "patch_embeds": jax.ShapeDtypeStruct((rows, 8, 32),
                                                  jnp.float32)}
    got = sh.batch_specs(batch, sh.rules_for(m), m)
    want = jsh.batch_specs(batch, jsh.rules_for(m), m)
    assert {k: _spec(v) for k, v in got.items()} == \
        {k: _spec(v) for k, v in want.items()}


def _cache(rows, kv, hd=128, seq=4096):
    s = jax.ShapeDtypeStruct
    return {"pos": s((), jnp.int32),
            "layers": {"p0": {"k": s((4, rows, seq, kv, hd), jnp.bfloat16),
                              "v": s((4, rows, seq, kv, hd), jnp.bfloat16)},
                       "p1": {"conv_x": s((4, rows, 3, 512), jnp.bfloat16),
                              "state": s((4, rows, 16, 64, 16),
                                         jnp.float32)}},
            "encoder_out": s((rows, 1500, 512), jnp.bfloat16),
            "other": s((4, rows), jnp.int32)}


@pytest.mark.parametrize("kv_fallback", ["hd", "seq"])
@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("kv", [2, 8, 32])
@pytest.mark.parametrize("rows", [1, 32])
@pytest.mark.parametrize("mesh", ("16x16", "2x16x16", "2x2"))
def test_cache_specs(mesh, rows, kv, seq_shard, kv_fallback):
    m = _mesh(mesh)
    cache = _cache(rows, kv)
    got = sh.cache_specs(cache, sh.rules_for(m), m, seq_shard=seq_shard,
                         kv_fallback=kv_fallback)
    want = jsh.cache_specs(cache, jsh.rules_for(m), m, seq_shard=seq_shard,
                           kv_fallback=kv_fallback)
    assert [_spec(s) for s in tree_flatten(got)[0]] == \
        [_spec(s) for s in _ref_leaves(want)]


# ---------------------------------------------------------------------------
# the port's own pieces: the cut, the shard callback
# ---------------------------------------------------------------------------


def test_cut_takes_row_major_blocks_over_a_tuple_of_axes():
    from repro_torch.launch.mesh import MeshAxis, ProcessMesh

    t = torch.arange(8 * 4).reshape(8, 4)
    spec = sh.LeafSpec((("pod", "data"), "model"))
    for pod in range(2):
        for data in range(2):
            for model in range(2):
                mesh = ProcessMesh(axes=(
                    MeshAxis("pod", 2, pod, (0, 4)),
                    MeshAxis("data", 2, data, (0, 2)),
                    MeshAxis("model", 2, model, (0, 1))))
                got = sh.cut_leaf(t, spec, mesh)
                r = pod * 2 + data
                assert torch.equal(got, t[2 * r:2 * r + 2,
                                          2 * model:2 * model + 2])


def test_meta_shapes_match_the_reference():
    """``model.init(device="meta")`` has the reference's full-size shapes
    (block leaves without the scan dimension): the spec tests above read
    them."""
    arch = "llama3.2-3b"
    cfg = configs.get_config(arch)
    params, jparams = _shapes(arch)
    got = [tuple(t.shape) for t in tree_flatten(params.tree())[0]]
    assert all(t.device.type == "meta"
               for t in tree_flatten(params.tree())[0])
    period = transformer.period_of(cfg)
    want = [tuple(jparams["embed"].shape), tuple(jparams["final_norm"].shape)]
    blocks = []
    for i in range(cfg.num_layers):
        blk = jparams["blocks"][f"p{i % period}"]
        blocks += [tuple(x.shape[1:]) for x in jax.tree.leaves(blk)]
    # tree order: blocks, embed, final_norm (dict keys sorted)
    assert got == blocks + want
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        configs.get_config(arch))
    assert np.prod(got[-2]) == cfg.padded_vocab() * cfg.d_model
