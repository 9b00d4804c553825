"""The meta-device dry run (``repro_torch.launch.dryrun``) and its readers
against the reference.

* Bytes: each cell's per-rank parameter, moment, cache and batch bytes
  equal the reference's specs (``repro.sharding``) applied to the same
  abstract shapes (``jax.eval_shape`` of the reference's init, input specs
  and cache), each ``PartitionSpec``'s shard shape on a stand-in mesh,
  2x2 and the production 16x16: the dense reduced configs, and full
  llama3.2-3b at 16x16 (meta costs nothing). The prefill and decode
  weights are held against the reference's specs without FSDP (the port's
  serving placement holds none; the record says ``fsdp: false``). Where
  the KV heads do not divide ``model`` the port's dense cache holds whole
  KV heads (ROADMAP A12, "How the port differs") where the reference
  splits the head dimension: there the bytes are held to that rule.
* FLOPs: a reduced forward's dry-run FLOPs equal ``FlopCounterMode`` of
  the real CPU forward, and on a (1, 2) mesh, which divides every width,
  twice rank 0's FLOPs equal them.
* Engine calls: the dry transport's ops (opcode, engine source, axis size,
  payload bytes, in order) equal what rank 0 of a real 2x2 gloo run of the
  same reduced GSPMD train step sends, seen by a spy on the engine's
  transport helpers. The file's one gloo world.
* Statuses: a MoE cell on a ``model`` axis wider than 1 is ``skipped``
  naming A15; a program that reads a tensor's value is ``failed`` naming
  the aten op; neither is ``ok``. ``report``, ``analyze``,
  ``resource_table`` and ``lm_step_bench``'s production roofline read the
  records; the CLI writes one.
"""
from __future__ import annotations

import json
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro import configs as jconfigs
from repro import sharding as jsh
from repro.models import model as jmodel
from repro_torch import sharding as sh
from repro_torch.comm import dry
from repro_torch.configs import RunConfig, get_config, list_archs, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import dry_mesh, spawn_mesh
from repro_torch.models.model import build_model

DENSE = [a for a in list_archs() if get_config(a).family == "dense"]
MESHES = ((2, 2), (16, 16))
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
META = torch.device("meta")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# bytes
# ---------------------------------------------------------------------------


def _stand_in(shape):
    return SimpleNamespace(shape=dict(zip(("data", "model"), shape)),
                           axis_names=("data", "model"))


def _shard_bytes(tree, specs, mesh, dtype_bytes=None) -> int:
    leaves = jax.tree.leaves(tree)
    specs = jax.tree.leaves(specs,
                            is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(leaves) == len(specs)
    total = 0
    for x, spec in zip(leaves, specs):
        if not x.shape:
            continue  # the cache's position: a host int in the port
        shape = list(x.shape)
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            n = math.prod(mesh.shape[a] for a in names)
            assert shape[d] % n == 0
            shape[d] //= n
        size = dtype_bytes or jnp.dtype(x.dtype).itemsize
        total += math.prod(shape) * size
    return total


def _reference_bytes(arch, cfg_fn, shape_name, mesh_shape):
    jcfg = cfg_fn(jconfigs.get_config(arch))
    shape = jconfigs.shape_for(shape_name)
    mesh = _stand_in(mesh_shape)
    model = jmodel.build_model(jcfg)
    params = jax.eval_shape(lambda: model.init(jax.random.key(0)))
    kind = shape.kind
    fsdp = kind == "train"
    rules = jsh.rules_for(mesh, fsdp=fsdp)
    p_specs = jsh.param_specs(params, rules, mesh)
    batch = jmodel.input_specs(jcfg, shape.seq_len, shape.global_batch, kind)
    out = {"batch": _shard_bytes(batch, jsh.batch_specs(batch, rules, mesh),
                                 mesh)}
    if kind == "train":
        out["params"] = _shard_bytes(params, p_specs, mesh)
        o_specs = jsh.opt_state_specs(params, rules, mesh, zero1=True)
        out["optimizer"] = 2 * _shard_bytes(params, o_specs, mesh, 4)
        out["cache"] = 0
    else:
        out["params"] = _shard_bytes(params, p_specs, mesh, 2)  # bf16
        out["optimizer"] = 0
        cache = jax.eval_shape(lambda: model.init_cache(
            shape.global_batch, shape.seq_len, jnp.bfloat16))
        c_specs = jsh.cache_specs(cache, rules, mesh,
                                  seq_shard=shape.global_batch == 1)
        out["cache"] = _shard_bytes(cache, c_specs, mesh)
    return out


def _port_bytes(cfg, shape_name, mesh_shape):
    cell = dryrun.build_cell(cfg, dryrun.shape_for(shape_name),
                             dry_mesh(mesh_shape))
    return {k: sum(t.numel() * t.element_size() for t in ts)
            for k, ts in cell.state.items()}


def _whole_kv_cache_bytes(cfg, shape_name, mesh_shape):
    """The port's dense cache where the KV heads do not divide ``model``:
    its rows of the batch, every position, whole KV heads (all of them,
    since the q heads do not divide ``model`` either), bf16."""
    shape = dryrun.shape_for(shape_name)
    data, model = mesh_shape
    assert cfg.num_kv_heads % model and cfg.num_heads % model
    rows = shape.global_batch // data if shape.global_batch % data == 0 \
        else shape.global_batch
    return (cfg.num_layers * 2 * rows * shape.seq_len * cfg.num_kv_heads
            * cfg.head_dim * 2)


CASES = [(a, s, m, True) for a in DENSE for s in SHAPES for m in MESHES] + \
    [("llama3.2-3b", s, (16, 16), False) for s in SHAPES]


@pytest.mark.parametrize("arch,shape_name,mesh_shape,is_reduced", CASES)
def test_state_bytes_equal_reference(arch, shape_name, mesh_shape,
                                     is_reduced):
    fn = reduced if is_reduced else (lambda c: c)
    jfn = jconfigs.reduced if is_reduced else (lambda c: c)
    cfg = fn(get_config(arch))
    got = _port_bytes(cfg, shape_name, mesh_shape)
    want = _reference_bytes(arch, jfn, shape_name, mesh_shape)
    if cfg.num_kv_heads % mesh_shape[1] and shape_name != "train_4k":
        want["cache"] = _whole_kv_cache_bytes(cfg, shape_name, mesh_shape)
    assert got == want


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------


def _forward_flops(cfg, batch_rows, seq):
    from torch.utils.flop_counter import FlopCounterMode

    model = build_model(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch_rows, seq)).astype(np.int32))
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model.apply(params, {"tokens": tokens})
    return fc.get_total_flops()


def _dry_forward(cfg, batch_rows, seq, mesh_shape):
    from repro_torch.train.serve import _shard_fn

    model = build_model(cfg)
    whole = model.init(device=META)
    mesh = dry_mesh(mesh_shape)
    shard = _shard_fn(mesh)
    params = type(whole)(whole.cfg, sh.cut(
        whole.tree(), sh.param_specs(whole, shard.rules, mesh), mesh,
        copy=False))
    tokens = torch.empty((batch_rows, seq), dtype=torch.int32, device=META)
    with torch.no_grad():
        prof = dryrun.profile(lambda: model.apply(params, {"tokens": tokens},
                                                  shard=shard))
    return prof.stats().flops, prof


def test_forward_flops_equal_real_run():
    cfg = reduced(get_config("llama3.2-3b"))
    want = _forward_flops(cfg, 2, 64)
    one, _ = _dry_forward(cfg, 2, 64, (1, 1))
    assert one == want > 0
    half, prof = _dry_forward(cfg, 2, 64, (1, 2))
    assert 2 * half == want
    assert {o.source for o in prof.comm} <= {"gspmd.tp", "gspmd.logits"}


# ---------------------------------------------------------------------------
# engine calls: the dry transport against a real 2x2 gloo run
# ---------------------------------------------------------------------------

SPY = {"_post": None, "_all_gather": "all-gather",
       "_all_to_all": "all-to-all", "_broadcast": "collective-broadcast",
       "_all_reduce": "all-reduce"}
SPY_B, SPY_S = 4, 16
SPY_RUN = RunConfig(remat="full", microbatches=1)


def _spy_cfg():
    return reduced(get_config("llama3.2-3b"), layers=2)


def _spy_rank(_ring):
    """Rank body: the reduced GSPMD train step (FSDP, ZeRO-1) on a real
    2x2 mesh, every transport helper logged as the dry transport logs."""
    from repro_torch.comm import engine
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        shard_state)

    def spy(name, fn):
        def wrapped(*a, **k):
            ax = a[1] if name != "_post" else a[0]
            if name == "_post":
                for t, _ in a[1]:
                    dry.record("collective-permute", ax,
                               t.numel() * t.element_size(),
                               engine._CALLSITE[0])
            else:
                x = torch.stack(a[0]) if name == "_all_to_all" else a[0]
                dry.record(SPY[name], ax, x.numel() * x.element_size(),
                           engine._CALLSITE[0])
            return fn(*a, **k)
        return wrapped

    for name in SPY:
        setattr(engine, name, spy(name, getattr(engine, name)))
    mesh = make_mesh((2, 2), ("data", "model"))
    cfg = _spy_cfg()
    model = build_model(cfg)
    state = shard_state(init_train_state(model, 0, device="cpu"), mesh,
                        zero1=True, fsdp=True)
    step = make_train_step(model, SPY_RUN, mesh, zero1=True, fsdp=True)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (SPY_B, SPY_S)).astype(np.int32))
    dry.reset()
    step(state, {"tokens": tokens})
    return [tuple(vars(o).values()) if hasattr(o, "__dict__") else
            (o.op, o.source, o.ranks, o.payload_bytes) for o in dry.ops()]


def test_dry_transport_equals_real_run():
    real = spawn_mesh(4, _spy_rank, axes=("x",), timeout=300)[0]
    cell = dryrun.build_train_cell(
        _spy_cfg(), ShapeConfig("spy", SPY_S, SPY_B, "train"),
        dry_mesh((2, 2)), SPY_RUN, fsdp=True)
    prof = dryrun.profile(cell.run)
    got = [(o.op, o.source, o.ranks, o.payload_bytes) for o in prof.comm]
    assert [tuple(r[:4]) for r in real] == got
    assert {"all-reduce", "all-gather"} <= {o[0] for o in got}
    assert {"gspmd.tp", "gspmd.fsdp", "gspmd.dp"} <= {o[1] for o in got}


# ---------------------------------------------------------------------------
# the kernel wrappers' meta path
# ---------------------------------------------------------------------------


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# (call on meta tensors, FLOPs, bytes): chip_smoke.py's bound formulas
META_CALLS = {
    "gemm_update": (lambda o: o.gemm_update(_meta(64, 32), _meta(64, 16),
                                            _meta(16, 32)),
                    2 * 64 * 32 * 16, 4 * (64 * 16 + 16 * 32 + 2 * 64 * 32)),
    "lu_factor_block": (lambda o: o.lu_factor_block(_meta(8, 8)),
                        sum((8 - k - 1) + 2 * (8 - k - 1) ** 2
                            for k in range(8)), 4 * 2 * 64),
    "trsm_lower_left": (lambda o: o.trsm_lower_left(_meta(8, 8),
                                                    _meta(8, 40)),
                        40 * 8 * 7, 4 * (64 + 2 * 8 * 40)),
    "trsm_upper_right": (lambda o: o.trsm_upper_right(_meta(8, 8),
                                                      _meta(40, 8)),
                         40 * 8 * 8, 4 * (64 + 2 * 40 * 8)),
    "transpose_add": (lambda o: o.transpose_add(_meta(16, 16),
                                                _meta(16, 16)),
                      256, 3 * 4 * 256),
    "stream_copy": (lambda o: o.stream_copy(_meta(256)), 0, 2 * 4 * 256),
    "stream_scale": (lambda o: o.stream_scale(_meta(256), 3.0), 256,
                     2 * 4 * 256),
    "stream_add": (lambda o: o.stream_add(_meta(256), _meta(256)), 256,
                   3 * 4 * 256),
    "stream_triad": (lambda o: o.stream_triad(_meta(256), _meta(256), 3.0),
                     512, 3 * 4 * 256),
    "matmul": (lambda o: o.matmul(_meta(32, 16), _meta(16, 8)),
               2 * 32 * 8 * 16, 4 * (32 * 16 + 16 * 8 + 32 * 8)),
    "flash_attention": (lambda o: o.flash_attention(
        _meta(2, 64, 4, 16, dtype=torch.bfloat16),
        _meta(2, 96, 2, 16, dtype=torch.bfloat16),
        _meta(2, 96, 2, 16, dtype=torch.bfloat16), q_offset=32),
        4 * 2 * 4 * 16 * sum(min(96, 32 + i + 1) for i in range(64)),
        2 * (2 * 2 * 64 * 4 * 16 + 2 * 2 * 96 * 2 * 16)),
    "ring_add_step": (lambda o: o.ring_add_step(_meta(4, 128),
                                                _meta(4, 128)),
                      512, 3 * 4 * 512),
}


@pytest.mark.parametrize("name", sorted(META_CALLS))
def test_kernel_meta_path_counts(name):
    from repro_torch.kernels import ops

    call, flops, nbytes = META_CALLS[name]
    before = ops.launch_counts()
    ops.reset_dry_counts()
    out = call(ops)
    assert out.device.type == "meta"
    assert ops.dry_counts() == {name: {"calls": 1, "flops": float(flops),
                                       "bytes": float(nbytes)}}
    assert ops.launch_counts() == before
    ops.reset_dry_counts()


def test_meta_calls_cover_every_kernel():
    from repro_torch.kernels import ops

    assert set(META_CALLS) == set(ops.KERNELS)


# ---------------------------------------------------------------------------
# statuses and readers
# ---------------------------------------------------------------------------


def test_moe_on_model_axis_is_skipped():
    rec = dryrun.cell_record("qwen3-moe-235b-a22b", "train_4k", "single",
                             cfg=reduced(get_config("qwen3-moe-235b-a22b")),
                             mesh_shape=(2, 2), verbose=False)
    assert rec["status"] == "skipped" and "A15" in rec["reason"]


def test_value_read_fails_naming_the_op(monkeypatch):
    def build(cfg, shape, mesh, **kw):
        x = torch.empty((3,), device=META)
        return dryrun.Cell(lambda: float(x.sum()), {"params": [x]},
                           torch.float32, False)
    monkeypatch.setattr(dryrun, "build_cell", build)
    rec = dryrun.cell_record("llama3.2-3b", "decode_32k", "single",
                             verbose=False)
    assert rec["status"] == "failed"
    assert "ValueRead" in rec["error"] and "_local_scalar_dense" in \
        rec["error"]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_torch")
    for arch, shape, mesh_shape in (("llama3.2-3b", "train_4k", (2, 2)),
                                    ("qwen3-moe-235b-a22b", "train_4k",
                                     (2, 2))):
        rec = dryrun.cell_record(arch, shape, "single",
                                 cfg=reduced(get_config(arch), layers=1),
                                 mesh_shape=mesh_shape, verbose=False)
        (d / f"{arch}__{shape}__single.json").write_text(json.dumps(rec))
    return d


def test_record_keys(records):
    rec = json.loads((records / "llama3.2-3b__train_4k__single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["fits"] and rec["links"] == \
        "loopback"
    # the reference's keys (launch/dryrun.py:220-239), and three more
    for key in ("arch", "shape", "mesh", "chips", "kind", "status",
                "lower_s", "compile_s", "memory_analysis",
                "flops_per_device", "hbm_bytes_per_device",
                "collective_operand_bytes", "collective_wire_bytes",
                "per_op_bytes", "collective_count", "unresolved_loops",
                "compute_s", "memory_s", "collective_s", "dominant",
                "model_flops", "useful_ratio", "step_s",
                "state_bytes_per_device", "peak_bytes_per_device"):
        assert key in rec, key
    assert rec["chips"] == 4 and rec["compute_dtype"] == \
        reduced(get_config("llama3.2-3b")).dtype
    assert rec["peak_bytes_per_device"] >= sum(
        rec["state_bytes_per_device"].values())
    assert rec["collective_wire_bytes"] == pytest.approx(
        sum(rec["wire_bytes_by_source"].values()))


def test_readers(records, capsys):
    from repro_torch.benchmarks import lm_step_bench, report, resource_table

    lines = report.main(records)
    assert any(line.startswith("| llama3.2-3b | train_4k") for line in lines)
    assert "1 cells ok; 1 skipped" in "\n".join(lines)
    assert [r["arch"] for r in resource_table.lm_rows(records)] == \
        ["llama3.2-3b"]
    prod = lm_step_bench.production_roofline_section(
        ["llama3.2-3b", "qwen3-moe-235b-a22b"], records)
    assert [r["arch"] for r in prod] == ["llama3.2-3b"]


def test_analyze_attributes_a_cell():
    from repro_torch.launch import analyze

    _, prof = _dry_forward(reduced(get_config("llama3.2-3b")), 2, 64, (1, 2))
    tops = analyze.attribute(prof, top=3)
    assert tops["flops"][0][0].startswith("aten.") and \
        tops["flops"][0][2] > 0
    assert sum(w for *_, w in analyze.attribute(prof, 99)["collective"]) \
        == pytest.approx(prof.stats().wire_bytes)
    assert "by engine source" in analyze.report(tops)


def test_resource_table_hpcc_rows():
    from repro_torch.benchmarks import resource_table

    hpcc = resource_table.dry_hpcc()
    assert set(hpcc) == {"b_eff/ici_direct", "b_eff/host_staged",
                         "ptrans/ici_direct", "ptrans/host_staged",
                         "hpl/ici_direct/chain", "hpl/ici_direct/native",
                         "hpl/host_staged/staged"}
    for name, t in hpcc.items():
        assert t["collective_wire_bytes"] > 0, name
    # rank 0 of the 16x16 torus: the diagonal block of every 16th of the
    # 96 iterations, a trailing update in each
    hpl = hpcc["hpl/ici_direct/native"]["kernels"]
    assert hpl["lu_factor_block"]["calls"] == 96 // 16
    assert hpl["gemm_update"]["calls"] == 96
    assert hpcc["ptrans/ici_direct"]["kernels"]["transpose_add"][
        "calls"] == 1


def test_cli_writes_a_record(tmp_path):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "llama3.2-3b", "--shape", "decode_32k",
                     "--mesh", "single", "--out", str(tmp_path)])
    assert e.value.code == 0
    rec = json.loads((tmp_path / "llama3.2-3b__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["chips"] == 256 and rec["fits"]
