"""The port's HPL kernels on the CPU, held against the JAX reference; and
the registry of every kernel of the port.

On a CPU tensor ``repro_torch.kernels.ops`` runs each kernel's plain version
(``repro_torch/kernels/ref.py``). Each case of ``tests/test_kernels.py`` for
the four HPL kernels feeds the same numpy inputs to the port and to two
reference oracles: the Pallas kernel in interpret mode (``pallas``) and the
pure-jnp oracle (``ref``). Tolerances are those of ``tests/test_kernels.py``:
the port sums in another order (and the reference's oracles use library
products and solves), so agreement is to fp32 rounding, not bitwise. The
CUDA kernels themselves need the card; ``chip_smoke.py`` holds them against
these plain versions there. The guards below check, for every kernel in
``ops.KERNELS`` (all twelve), that a CUDA tensor can only reach a kernel,
that a wrapper never computes on the CPU, and that the build fails loudly.
The other kernels' plain versions are held against the reference in
``tests/test_torch_ptrans.py``, ``tests/test_torch_legacy.py`` and
``tests/test_torch_attention.py``.
"""
from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.gemm import fit_block as jfit_block
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import attention as kattention
from repro_torch.kernels import gemm as kgemm
from repro_torch.kernels import lu as klu
from repro_torch.kernels import ring as kring
from repro_torch.kernels import stream as kstream
from repro_torch.kernels import transpose as ktranspose
from repro_torch.kernels.gemm import fit_block

ATOL = {torch.float32: 2e-4, torch.bfloat16: 8e-2}
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
ORACLES = ("pallas", "ref")


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _dominant(seed, n):
    a = _normal(seed, (n, n))
    a[np.arange(n), np.arange(n)] += n  # diagonally dominant (HPL-AI rule)
    return a


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("oracle", ORACLES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("alpha", [-1.0, 0.5])
def test_gemm_update(oracle, dtype, alpha):
    m, k, n = 128, 96, 64
    c, a, b = _normal(1, (m, n)), _normal(2, (m, k)), _normal(3, (k, n))
    jc, ja, jb = (jnp.asarray(x, JDTYPE[dtype]) for x in (c, a, b))
    if oracle == "pallas":
        want = jops.gemm_update(jc, ja, jb, alpha=alpha, bm=64, bn=32, bk=32)
    else:
        want = jref.gemm_update(jc, ja, jb, alpha=alpha)
    # jnp.asarray and torch.from_numpy both alias a float32 ``c``: read the
    # oracle's result out before the in-place update, and give the port a
    # buffer of its own, or the update can land in the oracle's input
    # before its asynchronous dispatch has read it
    want = np.array(want)
    tc = torch.from_numpy(c.copy()).to(dtype)
    out = ops.gemm_update(tc, torch.from_numpy(a).to(dtype),
                          torch.from_numpy(b).to(dtype), alpha=alpha,
                          bm=64, bn=32, bk=32)
    assert out is tc and out.dtype == dtype  # updated in place, as on the card
    np.testing.assert_allclose(_f32(out), _f32(want),
                               atol=ATOL[dtype] * k ** 0.5, rtol=1e-2)


@pytest.mark.parametrize("oracle", ORACLES)
@pytest.mark.parametrize("n", [16, 64, 128])
def test_lu_factor_block(oracle, n):
    a = _dominant(4, n)
    fn = jops.lu_factor_block if oracle == "pallas" else jref.lu_factor_block
    want = np.asarray(fn(jnp.asarray(a)))
    lu = ops.lu_factor_block(torch.from_numpy(a))
    np.testing.assert_allclose(lu.numpy(), want, rtol=1e-5, atol=1e-5)
    l, u = ref.unpack_lu(lu)  # L @ U must reconstruct A
    np.testing.assert_allclose((l @ u).numpy(), a, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("oracle", ORACLES)
@pytest.mark.parametrize("b_cols", [64, 192])
def test_trsm_lower_left(oracle, b_cols):
    n = 64
    lu = np.array(jops.lu_factor_block(jnp.asarray(_dominant(5, n))))
    rhs = _normal(6, (n, b_cols))
    if oracle == "pallas":
        want = jops.trsm_lower_left(jnp.asarray(lu), jnp.asarray(rhs), bn=64)
    else:
        want = jref.trsm_lower_left(jnp.asarray(lu), jnp.asarray(rhs))
    out = ops.trsm_lower_left(torch.from_numpy(lu), torch.from_numpy(rhs),
                              bn=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    l, _ = ref.unpack_lu(torch.from_numpy(lu))  # residual: L @ X == B
    np.testing.assert_allclose((l @ out).numpy(), rhs, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("oracle", ORACLES)
@pytest.mark.parametrize("b_rows", [64, 192])
def test_trsm_upper_right(oracle, b_rows):
    n = 64
    lu = np.array(jops.lu_factor_block(jnp.asarray(_dominant(7, n))))
    rhs = _normal(8, (b_rows, n))
    if oracle == "pallas":
        want = jops.trsm_upper_right(jnp.asarray(lu), jnp.asarray(rhs), bm=64)
    else:
        want = jref.trsm_upper_right(jnp.asarray(lu), jnp.asarray(rhs))
    out = ops.trsm_upper_right(torch.from_numpy(lu), torch.from_numpy(rhs),
                               bm=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    _, u = ref.unpack_lu(torch.from_numpy(lu))
    np.testing.assert_allclose((out @ u).numpy(), rhs, rtol=1e-3, atol=1e-3)


def test_fit_block():
    assert fit_block(256, 256) == 256
    assert fit_block(96, 64) == 48
    assert fit_block(100, 64) == 50
    for size in (64, 96, 100, 257):
        for pref in (16, 64, 256):
            b = fit_block(size, pref)
            assert size % b == 0 and b <= max(pref, 1)
            assert b == jfit_block(size, pref)


def test_gemm_update_strips_equal_full_update_bitwise():
    """The property HPL lookahead rests on: each output element sums over K
    in one fixed order, so the update of a row or column strip equals the
    full update restricted to it, bit for bit."""
    m, b = 96, 32
    c, l, u = (torch.from_numpy(_normal(s, shp)) for s, shp in
               ((9, (m, m)), (10, (m, b)), (11, (b, m))))
    full = ops.gemm_update(c.clone(), l, u)
    s = slice(32, 64)
    rows = ops.gemm_update(c[s, :].clone(), l[s, :], u)
    cols = ops.gemm_update(c[:, s].clone(), l, u[:, s])
    assert torch.equal(rows, full[s, :]) and torch.equal(cols, full[:, s])


# ---------------------------------------------------------------------------
# guards: a CUDA tensor reaches only the hand-written kernels
# ---------------------------------------------------------------------------


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to follow the dispatch in
    ``ops`` without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_typed(x):
    return torch.from_numpy(x).as_subclass(_CudaTyped)


# each kernel: its wrapper's module, and a call of its ops entry point on
# operands ``m`` (square) and ``v`` (a flat vector of 256)
MODULE = {"gemm_update": kgemm, "matmul": kgemm, "lu_factor_block": klu,
          "trsm_lower_left": klu, "trsm_upper_right": klu,
          "transpose_add": ktranspose, "stream_copy": kstream,
          "stream_scale": kstream, "stream_add": kstream,
          "stream_triad": kstream, "flash_attention": kattention,
          "ring_add_step": kring}
OPS_CALL = {
    "gemm_update": lambda m, v: ops.gemm_update(m, m, m),
    "lu_factor_block": lambda m, v: ops.lu_factor_block(m),
    "trsm_lower_left": lambda m, v: ops.trsm_lower_left(m, m),
    "trsm_upper_right": lambda m, v: ops.trsm_upper_right(m, m),
    "transpose_add": lambda m, v: ops.transpose_add(m, m),
    "stream_copy": lambda m, v: ops.stream_copy(v),
    "stream_scale": lambda m, v: ops.stream_scale(v, 3.0),
    "stream_add": lambda m, v: ops.stream_add(v, v),
    "stream_triad": lambda m, v: ops.stream_triad(v, v, 3.0),
    "matmul": lambda m, v: ops.matmul(m, m),
    "flash_attention": lambda m, v: ops.flash_attention(
        *(m.reshape(1, 32, 1, 32),) * 3),
    "ring_add_step": lambda m, v: ops.ring_add_step(v.reshape(2, 128),
                                                    v.reshape(2, 128)),
}
WRAPPER_CALL = {
    "gemm_update": lambda t: kgemm.gemm_update(t, t, t),
    "lu_factor_block": lambda t: klu.lu_factor_block(t),
    "trsm_lower_left": lambda t: klu.trsm_lower_left(t, t),
    "trsm_upper_right": lambda t: klu.trsm_upper_right(t, t),
    "transpose_add": lambda t: ktranspose.transpose_add(t, t),
    "stream_copy": lambda t: kstream.stream_copy(t),
    "stream_scale": lambda t: kstream.stream_scale(t, 3.0),
    "stream_add": lambda t: kstream.stream_add(t, t),
    "stream_triad": lambda t: kstream.stream_triad(t, t, 3.0),
    "matmul": lambda t: kgemm.matmul(t, t),
    "flash_attention": lambda t: kattention.flash_attention(
        *(t.reshape(1, 32, 1, 32),) * 3),
    "ring_add_step": lambda t: kring.ring_add_step(t, t),
}


def test_registry_covers_every_kernel():
    assert set(MODULE) == set(OPS_CALL) == set(WRAPPER_CALL) \
        == set(ops.KERNELS) == set(ops.launch_counts())
    assert len(ops.KERNELS) == 12
    assert set(ops.HPL_KERNELS) | set(ops.STREAM_KERNELS) \
        | set(ops.SERVE_KERNELS) | set(ops.ALLREDUCE_KERNELS) \
        | {"transpose_add", "matmul"} == set(ops.KERNELS)


@pytest.mark.parametrize("name", ops.KERNELS)
def test_cuda_tensor_never_reaches_plain_version(monkeypatch, name):
    calls = []

    def plain(*args, **kw):
        raise AssertionError(f"plain {name} called for a CUDA tensor")

    def kernel(*args, **kw):
        calls.append(name)
        return args[0]

    monkeypatch.setattr(ref, name, plain)
    monkeypatch.setattr(MODULE[name], name, kernel)
    OPS_CALL[name](_cuda_typed(_dominant(12, 32)),
                   _cuda_typed(_normal(13, (256,))))
    assert calls == [name]


def test_unknown_device_raises():
    # a device with neither a kernel nor a plain version (the meta device
    # now takes the dry run's counting path, below)
    class OnXpu:
        device = torch.device("xpu")
        shape = (8, 8)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.lu_factor_block(OnXpu())
    meta = torch.empty((8, 8), device="meta")
    before = ops.launch_counts()
    ops.reset_dry_counts()
    out = ops.lu_factor_block(meta)
    assert out.device.type == "meta" and out.shape == meta.shape
    assert ops.launch_counts() == before
    assert ops.dry_counts() == {"lu_factor_block": {
        "calls": 1, "flops": float(ops.lu_flops(8)), "bytes": 512.0}}
    ops.reset_dry_counts()


@pytest.mark.parametrize("name", ops.KERNELS)
def test_kernel_wrappers_reject_cpu_tensors(name):
    """A wrapper launches its kernel or raises: it never computes on the
    CPU itself."""
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA device"):
        WRAPPER_CALL[name](torch.zeros((32, 32)))
    assert ops.launch_counts() == before


def test_flash_bf16_refuses_what_tma_cannot_load():
    """A bf16 flash call whose operands TMA cannot load raises ValueError
    naming the rule, before any launch; it never takes another route."""
    before = ops.launch_counts()
    base = torch.zeros((1, 32, 2, 36), dtype=torch.bfloat16)
    odd = base[..., :32].as_subclass(_CudaTyped)  # head stride of 72 bytes
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        kattention.flash_attention(odd, odd, odd)
    flat = torch.zeros(1 + 32 * 2 * 32, dtype=torch.bfloat16)
    shifted = flat[1:].view(1, 32, 2, 32).as_subclass(_CudaTyped)
    with pytest.raises(ValueError, match="aligned address"):
        kattention.flash_attention(shifted, shifted, shifted)
    assert ops.launch_counts() == before


def _bf16_operands(case):
    """c, a, b of a bf16 update (M = 64, K = 32, N = 64) with one operand
    that TMA cannot address, on a device reported as CUDA."""
    def bf16(rows, cols, pad=0, skip=0):
        flat = torch.zeros(skip + rows * (cols + pad), dtype=torch.bfloat16)
        full = flat[skip:].view(rows, cols + pad)
        return full[:, :cols].as_subclass(_CudaTyped)
    c, a, b = bf16(64, 64), bf16(64, 32), bf16(32, 64)
    if case == "odd address":
        a = bf16(64, 32, skip=1)   # 2 bytes past a 16-byte boundary
    elif case == "odd lda":
        a = bf16(64, 32, pad=4)    # rows of 72 bytes
    elif case == "odd ldb":
        b = bf16(32, 64, pad=4)    # rows of 136 bytes
    elif case == "odd ldc":
        c = bf16(64, 64, pad=4)
    elif case == "odd C width":
        c, b = bf16(64, 60, pad=4), bf16(32, 60, pad=4)  # 120 bytes wide
    return c, a, b


@pytest.mark.parametrize("case, rule", [
    ("odd address", "aligned address"), ("odd lda", "row stride"),
    ("odd ldb", "row stride"), ("odd ldc", "row stride"),
    ("odd C width", "width")])
def test_gemm_update_bf16_refuses_what_tma_cannot_load(case, rule):
    """A bf16 update whose operands TMA cannot address raises ValueError
    naming the rule and the operand, before any launch; it never takes
    another route or the plain version."""
    c, a, b = _bf16_operands(case)
    name = {"odd address": "a", "odd lda": "a", "odd ldb": "b",
            "odd ldc": "c", "odd C width": "c"}[case]
    before = ops.launch_counts()
    with pytest.raises(ValueError, match=rule) as err:
        kgemm.gemm_update(c, a, b)
    assert f"moves {name} by TMA" in str(err.value)
    assert ops.launch_counts() == before


def test_gemm_update_routes_follow_the_dtype_and_reset():
    assert kgemm.ROUTES == {torch.float32: "simt_f32",
                            torch.bfloat16: "wgmma_bf16"}
    assert set(kgemm._ENTRY) == set(kgemm.ROUTES)
    kgemm.gemm_update.launches_by_route["wgmma_bf16"] += 3
    kgemm.gemm_update.launches_by_route["simt_f32"] += 1
    assert ops.launches_by_route()["gemm_update"] == {"simt_f32": 1,
                                                      "wgmma_bf16": 3}
    ops.reset_launch_counts()
    assert kgemm.gemm_update.launches_by_route == {
        "simt_f32": 0, "wgmma_bf16": 0}


def test_flash_routes_follow_the_dtype_and_reset():
    assert kattention.ROUTES == {torch.float32: "simt_f32",
                                 torch.bfloat16: "wgmma_bf16"}
    kattention.flash_attention.launches_by_route["wgmma_bf16"] += 3
    ops.reset_launch_counts()
    assert kattention.flash_attention.launches_by_route == {
        "simt_f32": 0, "wgmma_bf16": 0}


def test_plain_versions_count_no_launches():
    ops.reset_launch_counts()
    m = torch.from_numpy(_dominant(15, 32))
    v = torch.from_numpy(_normal(14, (256,)))
    for call in OPS_CALL.values():
        call(m.clone(), v)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_wrapper_entry_points_exist_in_sources():
    """Every C symbol a wrapper binds through ctypes is defined, with C
    linkage, in the CUDA sources (they compile only on the card)."""
    text = {p.stem: p.read_text() for p in _build.sources()}
    assert set(text) == {"gemm_update", "matmul", "lu", "stream",
                         "transpose_add", "flash_attention", "ring_add"}
    wanted = {"gemm_update": list(kgemm._ENTRY.values()),
              "matmul": list(kgemm._MATMUL_ENTRY.values()),
              "lu": ["repro_lu_factor_block_f32", "repro_trsm_lower_left_f32",
                     "repro_trsm_upper_right_f32"],
              "stream": list(kstream._ENTRY.values()),
              "transpose_add": list(ktranspose._ENTRY.values()),
              "flash_attention": list(kattention._ENTRY.values()),
              "ring_add": list(kring._ENTRY.values())}
    for stem, names in wanted.items():
        for name in names:
            assert re.search(rf'extern "C" int {name}\(', text[stem]), name
    lu_wrappers = open(klu.__file__).read()
    assert all(f'"{name}"' in lu_wrappers for name in wanted["lu"])
    for src in text.values():
        assert "use_fast_math" not in src
    assert "-use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    # each source names the TPU kernel it replaces and returns the launch
    # error to its wrapper
    for stem, src in text.items():
        assert re.search(r"[Rr]eplaces? the TPU kernel", src), stem
        assert "cudaGetLastError()" in src


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_source_hash_keys_the_build(monkeypatch, tmp_path):
    for src in _build.sources():
        (tmp_path / src.name).write_text(src.read_text())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before, dir_before = _build.source_hash(), _build.build_dir()
    (tmp_path / "lu.cu").write_text((tmp_path / "lu.cu").read_text() + "\n")
    assert _build.source_hash() != before
    assert _build.build_dir() != dir_before
