"""The port's allreduce family against the JAX reference, on the CPU.

Bucket packing, the tree helpers, the int8 quantizers and the plain
``ring_add_step`` are held against ``repro.comm.overlap``,
``repro.comm.compression`` and ``repro.kernels.ring`` (the Pallas kernel in
interpret mode) on the same numpy inputs. The schedules run on a 4-rank
ring and on a 2x2 torus of gloo processes, each spawned once for this
module: on small integers in fp32 every schedule gives ``x.sum(0)`` bit for
bit (int8_ef on block-representable inputs), as in
``tests/dist/test_schedules.py`` and ``tests/dist/test_overlap.py``. On
seeded normal inputs the port is held against the reference itself, run
in a subprocess on four simulated devices (the in-process JAX stays on one
device): bit for bit for chain, chain_rooted, rs_ag and ring2d, which add
in the reference's order; within rtol 1e-5 for native and staged, whose
order is the library's (``tests/dist/test_schedules.py:219``); and within
``tests/dist/test_overlap.py:249-262``'s bound for int8_ef, because XLA
contracts the quantizer's ``x - q * scale`` into a fused multiply-add under
``jit`` (the eager reference quantizers equal the port's bit for bit).
"""
from __future__ import annotations

import os
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import autotune as jautotune
from repro.comm import compression as jcompression
from repro.comm import engine as jengine
from repro.comm import overlap as joverlap
from repro.comm import topology as jtopology
from repro.kernels import ring as jring
from repro_torch.benchmarks import overlap_bench
from repro_torch.comm import collectives, compression, engine, overlap
from repro_torch.comm.engine import CollectiveEngine
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref, ring
from repro_torch.launch.mesh import single_rank_mesh, spawn_mesh
from repro_torch.models import transformer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING = 4
SCHEDULES = ("chain", "chain_rooted", "int8_ef", "native", "ring2d", "rs_ag",
             "staged")
EXACT = tuple(s for s in SCHEDULES if s != "int8_ef")
REF_BITWISE = ("chain", "chain_rooted", "ring2d", "rs_ag")
REF_LIBRARY = ("native", "staged")
TORUS = ("rows", "cols")
# payloads: (8, 128) packs into 128-multiple chunks on a ring of 4 and of 2
# (the kernel's path); (3, 5) into ragged ones (the plain add)
FLOAT_PAYLOADS = {"main": (11, (8, 128)), "ragged": (12, (3, 5))}
BUCKETS = (1, 64, 1 << 30)
CHUNKS = (1, 3, 4)


def _ints(shape, seed=0):
    return np.random.default_rng(seed).integers(-8, 8, shape).astype(np.float32)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


# ---------------------------------------------------------------------------
# registry, packing and trees against the reference
# ---------------------------------------------------------------------------


def test_allreduce_schedules_equal_reference():
    assert engine.schedules_for("allreduce") == \
        jengine.schedules_for("allreduce") == SCHEDULES
    assert engine.known_schedules() == jengine.known_schedules()


@pytest.mark.parametrize("sizes,cap,want", [
    ((10, 10, 10), 100, [[0, 1], [2]]),
    ((10, 100, 10), 100, [[0], [1], [2]]),
    ((2, 2, 2), 1, [[0], [1], [2]]),
    ((2, 2, 2), 1 << 30, [[0, 1, 2]]),
    ((0, 10, 0, 10), 100, [[0, 1, 2, 3]]),
    ((), 100, []),
])
def test_pack_buckets_equals_reference(sizes, cap, want):
    """tests/test_overlap.py:21-35: greedy boundaries, giant and 0-byte
    leaves."""
    port = [torch.zeros(s) for s in sizes]
    refl = [jnp.zeros((s,), jnp.float32) for s in sizes]
    assert overlap.pack_buckets(port, cap) == joverlap.pack_buckets(refl, cap) \
        == want


def test_tree_bytes_and_order_equal_reference():
    import jax
    tree = {"b": torch.zeros(3), "a": {"z": torch.zeros(2, dtype=torch.int8),
                                       "y": [torch.ones(4), None]}}
    jtree = {"b": jnp.zeros(3), "a": {"z": jnp.zeros(2, jnp.int8),
                                      "y": [jnp.ones(4), None]}}
    assert overlap.tree_bytes(tree) == joverlap.tree_bytes(jtree) == 30
    leaves, spec = overlap.tree_flatten(tree)
    jleaves = jax.tree.leaves(jtree)
    assert [tuple(t.shape) for t in leaves] == [j.shape for j in jleaves]
    back = overlap.tree_unflatten(spec, leaves)
    assert back["a"]["y"][1] is None and back["b"] is tree["b"]


def test_layer_shapes_are_the_models():
    cfg = reduced(get_config("llama3.2-3b"), layers=1, d_model=64)
    layer = transformer._init_layer(torch.Generator().manual_seed(0), cfg,
                                    "cpu")
    got = overlap_bench.layer_shapes(cfg)
    assert transformer.tree_map(layer, lambda t: tuple(t.shape)) == got


# ---------------------------------------------------------------------------
# quantizers and ring_add_step against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,scale", [((1000,), 1.0), ((3, 256), 50.0),
                                         ((4097,), 1e-3), ((256,), 0.0)])
def test_quantizers_bitwise(shape, scale):
    x = _normal(len(shape) + int(scale * 10), shape) * scale
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for got, want in zip(compression.quantize(tx), jcompression.quantize(jx)):
        assert _bits(got.numpy()) == _bits(want)
    got_ef, want_ef = compression.quantize_ef(tx), jcompression.quantize_ef(jx)
    for got, want in zip(got_ef, want_ef):
        assert got.dtype == {1: torch.int8, 4: torch.float32}[
            np.asarray(want).itemsize]
        assert _bits(got.numpy()) == _bits(want)
    assert _bits(compression.dequantize(*got_ef[:2], shape, x.size).numpy()) \
        == _bits(jcompression.dequantize(*want_ef[:2], shape, x.size))
    assert _bits(compression.dequantize_ef(*got_ef, shape, x.size).numpy()) \
        == _bits(jcompression.dequantize_ef(*want_ef, shape, x.size))


def test_quantize_rounds_half_to_even():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5] + [0.0] * 250)
    q, scale = compression.quantize(x)
    assert float(scale[0]) == 1.0
    assert q[0, :6].tolist() == [127, 0, 2, 2, 0, -2]


HALF = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


@pytest.mark.parametrize("dtype", [torch.float32, *HALF])
@pytest.mark.parametrize("shape", [(4, 256), (100,)])
def test_fused_chunk_add_bitwise_vs_reference(dtype, shape):
    """tests/test_engine.py:212-222: (4, 256) takes the Pallas kernel in
    interpret mode, a ragged 100-element chunk the plain add."""
    a, b = _normal(1, shape), _normal(2, shape)
    jdt = {torch.float32: jnp.float32, **HALF}[dtype]
    want = jring.fused_chunk_add(jnp.asarray(a, jdt), jnp.asarray(b, jdt))
    ta, tb = torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype)
    got = ring.fused_chunk_add(ta, tb)
    assert got.dtype == dtype and tuple(got.shape) == shape
    assert _bits(got.float().numpy()) == _bits(np.asarray(want, np.float32))
    if shape == (4, 256):
        plain = ref.ring_add_step(ta.reshape(-1, 128), tb.reshape(-1, 128))
        assert torch.equal(plain.reshape(shape), got)


def test_ring_add_step_in_place_and_checks():
    a, b = torch.from_numpy(_normal(3, (6, 128))), \
        torch.from_numpy(_normal(4, (6, 128)))
    want = a + b
    ops.reset_launch_counts()
    acc = a.clone()
    assert ops.ring_add_step(acc, b, out=acc) is acc
    assert torch.equal(acc, want)
    flat = a.clone().reshape(-1)
    assert ring.fused_chunk_add(flat, b.reshape(-1), out=flat) is flat
    assert torch.equal(flat.reshape(6, 128), want)
    assert ops.launch_counts()["ring_add_step"] == 0  # plain version
    with pytest.raises(ValueError, match="rows, 128"):
        ops.ring_add_step(a.reshape(-1), b.reshape(-1))
    with pytest.raises(ValueError, match="is not"):
        ops.ring_add_step(a, b, out=torch.empty(6, 128, dtype=torch.bfloat16))


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to follow the dispatch
    without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("size", [0, 100, 256, 128 * 3 + 5])
def test_fused_chunk_add_on_card_launches_for_every_chunk(monkeypatch, size):
    """On the card the kernel takes any nonempty chunk, ragged or not; the
    reference's (rows, 128) rule holds only on the CPU."""
    calls = []

    def kernel(acc, recv, *, out=None):
        calls.append(tuple(acc.shape))
        return out

    monkeypatch.setattr(ring, "ring_add_step", kernel)
    monkeypatch.setattr(ref, "ring_add_step", None)  # never the plain one
    acc = torch.from_numpy(_normal(7, (size,))).as_subclass(_CudaTyped)
    ring.fused_chunk_add(acc, acc.clone(), out=acc)
    assert calls == ([(size,)] if size else [])


def test_roll_with_axis_and_axis_index():
    from repro.comm import collectives as jcollectives
    x = _normal(5, (5, 7))
    for shift in (-2, 0, 3):
        got = collectives.roll_with_axis(torch.from_numpy(x), shift, 1)
        want = jcollectives.roll_with_axis(jnp.asarray(x), shift, 1)
        assert _bits(got.numpy()) == _bits(want)
    assert collectives.axis_index("rows", mesh=single_rank_mesh()) == 0


def test_single_rank_compat_and_shims():
    mesh = single_rank_mesh(("x",))
    x = torch.arange(6.0)
    assert torch.equal(collectives.psum_schedule(x, "x", mesh=mesh), x)
    assert torch.equal(collectives.ring_shift(x, "x", mesh=mesh), x)
    assert torch.equal(collectives.all_to_all_tiles(
        x, "x", split_axis=0, concat_axis=0, mesh=mesh), x)
    with pytest.warns(DeprecationWarning, match="allreduce_tree"):
        out = overlap.bucketed_psum_tree({"a": x}, "x", 8, mesh=mesh)
    assert torch.equal(out["a"], x)
    red, err = compression.compressed_psum(x, "x", torch.zeros(6), mesh=mesh)
    assert torch.equal(red + err, x)
    with pytest.raises(ValueError, match="engine or the mesh"):
        compression.compressed_psum(x, "x", torch.zeros(6))
    assert overlap.tree_flatten(compression.init_error_tree(
        {"w": torch.ones(2, 3, dtype=torch.bfloat16)}))[0][0].dtype \
        == torch.float32


def test_engine_refuses_unknown_axes():
    """On a 1-rank ring the bucket is the reference's derived one (its
    floor, 256 KiB); unknown axes still raise KeyError."""
    eng = CollectiveEngine.for_mesh(single_rank_mesh(("x",)))
    assert eng.bucket_bytes_for("x") == jautotune.derive_bucket_bytes(
        (jtopology.AxisTopology("x", 1, "ring"),)) == 262144
    for call in (lambda: eng.allreduce(torch.zeros(3), "bogus"),
                 lambda: eng.allreduce_tree({"a": torch.zeros(3)}, "bogus"),
                 lambda: eng.bucket_bytes_for("bogus")):
        with pytest.raises(KeyError):
            call()
    with pytest.raises(KeyError):
        eng.all_to_all_tiles(torch.zeros(4), "bogus", split_axis=0,
                             concat_axis=0)
    x = torch.arange(16.0).reshape(4, 4)
    assert torch.equal(eng.pipelined("all_to_all_tiles", x, "x", nchunks=2,
                                     split_axis=1, tile_split_axis=0,
                                     tile_concat_axis=0), x)
    assert eng.schedule_for("all_to_all_tiles") == "native"


# ---------------------------------------------------------------------------
# the reference on four simulated devices, in a subprocess
# ---------------------------------------------------------------------------

_REFERENCE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.comm.compression import compressed_psum
from repro.comm.engine import CollectiveEngine, schedules_for
from repro.compat import make_mesh, shard_map

PAYLOADS = %(payloads)r


def normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def run(mesh, axis, spec, body, *xs):
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec,) * len(xs),
                           out_specs=spec, check_vma=False))
    return np.asarray(fn(*map(jnp.asarray, xs)))


ring = make_mesh((4,), ("x",))
torus = make_mesh((2, 2), ("rows", "cols"))
out = {}
for s in schedules_for("allreduce"):
    eng = CollectiveEngine.for_mesh(ring, schedule=s)
    for name, (seed, shape) in PAYLOADS.items():
        out["ring/%%s/%%s" %% (s, name)] = run(
            ring, "x", P("x"), lambda v: eng.allreduce(v[0], "x")[None],
            normal(seed, (4,) + shape))
    teng = CollectiveEngine.for_mesh(torus, schedule=s)
    seed, shape = PAYLOADS["main"]
    out["torus/%%s" %% s] = run(
        torus, ("rows", "cols"), P(("rows", "cols")),
        lambda v: teng.allreduce(v[0], ("rows", "cols"))[None],
        normal(seed, (4,) + shape))
eng = CollectiveEngine.for_mesh(ring, schedule="rs_ag")
for label, e in (("psum", None), ("rs_ag", eng)):
    def two_steps(a, b, e=e):
        r1, e1 = compressed_psum(a[0], "x", jnp.zeros_like(a[0]), engine=e)
        r2, e2 = compressed_psum(b[0], "x", e1, engine=e)
        return jnp.stack([r1, e1, r2, e2])[None]
    out["compressed/" + label] = run(ring, "x", P("x"), two_steps,
                                     normal(14, (4, 512)), normal(15, (4, 512)))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("allreduce_ref") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    script = _REFERENCE % {"payloads": FLOAT_PAYLOADS}
    proc = subprocess.run([sys.executable, "-c", script, str(path)],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


# ---------------------------------------------------------------------------
# a 4-rank gloo ring
# ---------------------------------------------------------------------------


def _odd_tree():
    """tests/dist/test_overlap.py:191-200: mixed dtypes, a 0-byte leaf, a
    one-element leaf and a leaf dwarfing the smaller bucket sizes."""
    rng = np.random.default_rng(0)
    return {"w": rng.integers(-8, 8, (RING, 7, 33)).astype(np.float32),
            "giant": rng.integers(-8, 8, (RING, 4096)).astype(np.float32),
            "bias": rng.integers(-8, 8, (RING, 5)).astype(np.float32),
            "ints": rng.integers(-8, 8, (RING, 11)).astype(np.int32),
            "empty": np.zeros((RING, 0), np.float32),
            "one": rng.integers(-8, 8, (RING, 1)).astype(np.float32)}


def _int8_representable():
    """tests/dist/test_overlap.py:230-246: one integer row on every rank
    with a 127 in every 256-element block of every 512-element ring
    chunk, so every hop's partial sum k*v has block scale exactly k."""
    row = np.random.default_rng(1).integers(-100, 100, (RING * 512,)) \
        .astype(np.float32)
    row[::256] = 127
    return np.broadcast_to(row, (RING, RING * 512)).copy()


# overlap_bench's rank body on small shapes: every leaf and every chunk of
# the one 32 MiB bucket (5120 elements, 1280 per hop) a multiple of 256
BENCH_SHAPES = {"attn": {"wq": (4, 256)}, "ln": (1024,),
                "mlp": {"w_in": (8, 2, 128), "w_out": (1024,)}}
BENCH_RUNS = [(s, "model", "int8_exact" if s == "int8_ef" else "ints")
              for s in SCHEDULES] + [
    ("rs_ag", m, "ints") for m in ("monolithic", "bucketed", "leafwise")] + [
    ("rs_ag", "model", "normal"), ("ring2d", "leafwise", "normal")]


def _ring_world(mesh):
    rank = mesh.index("x")
    out = {}
    x = torch.from_numpy(_ints((RING, 6, 128), seed=1)[rank])
    scalar = torch.from_numpy(_ints((RING, 1, 1), seed=3)[rank])
    ragged = torch.from_numpy(_ints((RING, 3, 5), seed=9)[rank])
    halves = {dt: x.to(dt) for dt in HALF}
    odd = {k: torch.from_numpy(v[rank]) for k, v in _odd_tree().items()}
    for s in SCHEDULES:
        eng = CollectiveEngine.for_mesh(mesh, schedule=s)
        out["ints", s] = eng.allreduce(x, "x").numpy()
        out["scalar", s] = eng.allreduce(scalar, "x").numpy()
        out["ragged", s] = eng.allreduce(ragged, "x").numpy()
        for dt, xh in halves.items():
            red = eng.allreduce(xh, "x")
            out["half", s, dt] = (red.dtype, red.float().numpy())
        for k in CHUNKS:
            out["pipe", s, k] = eng.pipelined("allreduce", x, "x",
                                              nchunks=k).numpy()
        for name, (seed, shape) in FLOAT_PAYLOADS.items():
            xf = torch.from_numpy(_normal(seed, (RING,) + shape)[rank])
            out["float", s, name] = eng.allreduce(xf, "x").numpy()
        if s in EXACT:
            for bb in BUCKETS:
                red = eng.allreduce_tree(odd, "x", bucket_bytes=bb)
                out["tree", s, bb] = {k: v.numpy() for k, v in red.items()}
    eng = CollectiveEngine.for_mesh(mesh, schedule="int8_ef")
    rep = torch.from_numpy(_int8_representable()[rank])
    out["int8_exact"] = eng.allreduce_tree({"g": rep}, "x",
                                           bucket_bytes=1 << 30)["g"].numpy()
    general = torch.from_numpy(np.random.default_rng(6).integers(
        -100, 100, (RING, 4096)).astype(np.float32)[rank])
    out["int8_general"] = eng.allreduce(general, "x").numpy()
    # compressed_psum, two steps, error carried: over the rs_ag ring and
    # over the mesh's native psum
    a = torch.from_numpy(_normal(14, (RING, 512))[rank])
    b = torch.from_numpy(_normal(15, (RING, 512))[rank])
    rs = CollectiveEngine.for_mesh(mesh, schedule="rs_ag")
    for label, kw in (("psum", {"mesh": mesh}), ("rs_ag", {"engine": rs})):
        r1, e1 = compression.compressed_psum(a, "x", torch.zeros(512), **kw)
        r2, e2 = compression.compressed_psum(b, "x", e1, **kw)
        out["compressed", label] = torch.stack([r1, e1, r2, e2]).numpy()
    out["compressed", "int8_remap"] = compression.compressed_psum(
        a, "x", torch.zeros(512), engine=rs, schedule="int8_ef")[0].numpy()
    # the compat layer and the deprecated shim
    out["psum_schedule"] = collectives.psum_schedule(
        x, "x", schedule="chain", mesh=mesh).numpy()
    out["ring_shift"] = collectives.ring_shift(x, "x", 1, mesh=mesh).numpy()
    out["ring_bcast"] = collectives.ring_bcast(x, "x", 2, mesh=mesh).numpy()
    out["exchange"] = [t.numpy() for t in collectives.ring_exchange_bidir(
        x, 2 * x, "x", mesh=mesh)]
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        shim = overlap.bucketed_psum_tree(odd, "x", 256, mesh=mesh)
    out["shim"] = ({k: v.numpy() for k, v in shim.items()},
                   sum(issubclass(w.category, DeprecationWarning) for w in rec))
    out["bench"] = overlap_bench.reduce_rank(mesh, BENCH_SHAPES, BENCH_RUNS,
                                             seed=5, device="cpu")
    return out


@pytest.fixture(scope="module")
def ring_results():
    return spawn_mesh(RING, _ring_world, axes=("x",), timeout=240)


@pytest.mark.parametrize("schedule", EXACT)
@pytest.mark.parametrize("payload", ["ints", "scalar", "ragged"])
def test_allreduce_exact_on_gloo_ring(ring_results, schedule, payload):
    """tests/dist/test_schedules.py:73-99."""
    seed, shape = {"ints": (1, (6, 128)), "scalar": (3, (1, 1)),
                   "ragged": (9, (3, 5))}[payload]
    want = _ints((RING,) + shape, seed=seed).sum(0)
    for res in ring_results:
        assert _bits(res[payload, schedule]) == _bits(want)


@pytest.mark.parametrize("schedule", EXACT)
@pytest.mark.parametrize("dtype", list(HALF))
def test_allreduce_half_dtypes_exact_on_gloo_ring(ring_results, schedule,
                                                  dtype):
    """bf16 and fp16 payloads, which the reference's ``_fused_add`` also
    reduces, keep their dtype and sum small integers exactly."""
    want = _ints((RING, 6, 128), seed=1).sum(0)
    for res in ring_results:
        got_dtype, got = res["half", schedule, dtype]
        assert got_dtype == dtype and _bits(got) == _bits(want)


@pytest.mark.parametrize("schedule", EXACT)
@pytest.mark.parametrize("nchunks", CHUNKS)
def test_pipelined_allreduce_equals_monolithic(ring_results, schedule,
                                               nchunks):
    for res in ring_results:
        assert _bits(res["pipe", schedule, nchunks]) == \
            _bits(res["ints", schedule])


@pytest.mark.parametrize("schedule", EXACT)
@pytest.mark.parametrize("bucket_bytes", BUCKETS)
def test_allreduce_tree_matches_leafwise_sums(ring_results, schedule,
                                              bucket_bytes):
    """tests/dist/test_overlap.py:217-227."""
    for res in ring_results:
        got = res["tree", schedule, bucket_bytes]
        for key, x in _odd_tree().items():
            want = x.sum(0, dtype=x.dtype)
            assert got[key].dtype == want.dtype and \
                _bits(got[key]) == _bits(want), key


def test_int8_ef_exact_and_close(ring_results):
    """tests/dist/test_overlap.py:230-262."""
    x = _int8_representable()
    g = np.random.default_rng(6).integers(-100, 100, (RING, 4096)) \
        .astype(np.float32)
    for res in ring_results:
        assert _bits(res["int8_exact"]) == _bits(x.sum(0))
        err = np.max(np.abs(res["int8_general"] - g.sum(0)))
        assert err <= 2.0 / 127.0 ** 2 * RING * np.max(np.abs(g)), err
    assert len({_bits(r["int8_general"]) for r in ring_results}) == 1


@pytest.mark.parametrize("schedule", REF_BITWISE)
@pytest.mark.parametrize("payload", list(FLOAT_PAYLOADS))
def test_ring_schedules_bitwise_vs_reference(ring_results, reference,
                                             schedule, payload):
    want = reference[f"ring/{schedule}/{payload}"]
    for rank, res in enumerate(ring_results):
        assert _bits(res["float", schedule, payload]) == _bits(want[rank])


@pytest.mark.parametrize("schedule", REF_LIBRARY)
@pytest.mark.parametrize("payload", list(FLOAT_PAYLOADS))
def test_library_schedules_close_to_reference(ring_results, reference,
                                              schedule, payload):
    want = reference[f"ring/{schedule}/{payload}"]
    for rank, res in enumerate(ring_results):
        np.testing.assert_allclose(res["float", schedule, payload],
                                   want[rank], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("payload", list(FLOAT_PAYLOADS))
def test_int8_ef_close_to_reference(ring_results, reference, payload):
    seed, shape = FLOAT_PAYLOADS[payload]
    x = _normal(seed, (RING,) + shape)
    bound = 2.0 / 127.0 ** 2 * RING * np.max(np.abs(x))
    want = reference[f"ring/int8_ef/{payload}"]
    for rank, res in enumerate(ring_results):
        got = res["float", "int8_ef", payload]
        assert np.max(np.abs(got - x.sum(0))) <= bound
        assert np.max(np.abs(got - want[rank])) <= bound
        assert _bits(got) == _bits(ring_results[0]["float", "int8_ef",
                                                    payload])


@pytest.mark.parametrize("label", ["psum", "rs_ag"])
def test_compressed_psum_two_steps_vs_reference(ring_results, reference,
                                                label):
    """tests/dist/test_overlap.py:296-324, carried over two steps: reduced
    and new_error after each step against the reference's, within the
    library tolerance (under ``jit`` XLA contracts ``target - q * scale``
    into a fused multiply-add, so the error state differs from the port's
    two roundings by an ulp); across ranks, and between the int8_ef remap
    and its rs_ag transport, bit for bit."""
    want = reference[f"compressed/{label}"]
    for rank, res in enumerate(ring_results):
        got = res["compressed", label]
        np.testing.assert_allclose(got, want[rank], rtol=1e-5, atol=1e-6)
        assert _bits(got[0::2]) == \
            _bits(ring_results[0]["compressed", label][0::2])
        assert _bits(res["compressed", "int8_remap"]) == \
            _bits(res["compressed", "rs_ag"][0])


def test_compat_layer_and_shim_on_gloo_ring(ring_results):
    x = _ints((RING, 6, 128), seed=1)
    odd = _odd_tree()
    for rank, res in enumerate(ring_results):
        assert _bits(res["psum_schedule"]) == _bits(x.sum(0))
        assert _bits(res["ring_shift"]) == _bits(x[(rank - 1) % RING])
        assert _bits(res["ring_bcast"]) == _bits(x[2])
        recv_l, recv_r = res["exchange"]
        assert _bits(recv_l) == _bits(x[(rank - 1) % RING])
        assert _bits(recv_r) == _bits(2 * x[(rank + 1) % RING])
        shim, warned = res["shim"]
        assert warned == 1
        for key, v in odd.items():
            assert _bits(shim[key]) == _bits(v.sum(0, dtype=v.dtype))


@pytest.mark.parametrize("run", range(len(BENCH_RUNS)))
def test_overlap_bench_rank_body(ring_results, run):
    """The benchmark's own checks hold on the CPU ring, its bucket modes
    make the buckets they name, and the plain add counts no launch."""
    schedule, mode, kind = BENCH_RUNS[run]
    recs = [res["bench"][run] for res in ring_results]
    for rec in recs:
        assert (rec["schedule"], rec["mode"], rec["kind"]) == BENCH_RUNS[run]
        assert rec.get("exact", True) and rec.get("replay_equal", True)
        assert rec["launches"] == {} and rec["staged_bytes"] == 0
        assert rec["bytes"] == 5120 * 4 and rec["seconds"] > 0
        assert rec["buckets"] == {"monolithic": 1, "model": 1,
                                  "bucketed": 4, "leafwise": 4}[mode]
    if kind == "normal":
        assert len({rec["digest"] for rec in recs}) == 1
        assert all(rec["replay_equal"] for rec in recs)
    else:
        assert all(rec["exact"] for rec in recs)


# ---------------------------------------------------------------------------
# a 2x2 gloo torus
# ---------------------------------------------------------------------------


def _torus_world(mesh):
    rank = mesh.rank
    x = torch.from_numpy(_ints((RING, 2, 64), seed=2)[rank])
    seed, shape = FLOAT_PAYLOADS["main"]
    xf = torch.from_numpy(_normal(seed, (RING,) + shape)[rank])
    out = {}
    for s in SCHEDULES:
        eng = CollectiveEngine.for_mesh(mesh, schedule=s)
        out["ints", s] = eng.allreduce(x, TORUS).numpy()
        out["rows", s] = eng.allreduce(x, "rows").numpy()
        out["float", s] = eng.allreduce(xf, TORUS).numpy()
        tree = eng.allreduce_tree({"g": x, "h": 2 * x}, TORUS, bucket_bytes=64)
        out["tree", s] = {k: v.numpy() for k, v in tree.items()}
    return out


@pytest.fixture(scope="module")
def torus_results():
    return spawn_mesh(RING, _torus_world, timeout=240)


@pytest.mark.parametrize("schedule", EXACT)
def test_allreduce_exact_on_gloo_torus(torus_results, schedule):
    """tests/dist/test_schedules.py:84-95: one flattened ring (chain,
    staged, native) or a pass per axis (the others) sum the same."""
    x = _ints((RING, 2, 64), seed=2)
    for rank, res in enumerate(torus_results):
        r, c = divmod(rank, 2)
        assert _bits(res["ints", schedule]) == _bits(x.sum(0))
        assert _bits(res["rows", schedule]) == _bits(x[c] + x[2 + c])
        assert _bits(res["tree", schedule]["g"]) == _bits(x.sum(0))
        assert _bits(res["tree", schedule]["h"]) == _bits(2 * x.sum(0))


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_torus_order_matches_reference(torus_results, reference, schedule):
    want = reference[f"torus/{schedule}"]
    for rank, res in enumerate(torus_results):
        if schedule in REF_BITWISE:
            assert _bits(res["float", schedule]) == _bits(want[rank])
        elif schedule in REF_LIBRARY:
            np.testing.assert_allclose(res["float", schedule], want[rank],
                                       rtol=1e-5, atol=1e-6)
        else:
            seed, shape = FLOAT_PAYLOADS["main"]
            x = _normal(seed, (RING,) + shape)
            bound = 2.0 / 127.0 ** 2 * RING * np.max(np.abs(x))
            assert np.max(np.abs(res["float", schedule] - want[rank])) <= bound
