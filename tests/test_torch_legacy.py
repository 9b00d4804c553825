"""The port's STREAM and GEMM against the JAX reference, on the CPU.

The plain STREAM ops equal the reference's Pallas kernels in interpret mode
bit for bit in fp32: copy, scale and add round once per element on both
sides. Triad rounds the product and then the sum, as the reference's jnp
oracle does and as the port's CUDA kernel does; under interpret mode XLA's
CPU backend contracts the reference kernel's multiply-add into one fused
operation, so there triad agrees within ``tests/test_kernels.py``'s
tolerance and is bitwise against the oracle. ``matmul``'s plain version
agrees with the reference's kernel within ``tests/test_kernels.py``'s
tolerance (it sums in another order).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import gemm, stream
from repro_torch.kernels import ops, ref
from repro_torch.kernels import stream as kstream

ATOL = {torch.float32: 2e-4, torch.bfloat16: 8e-2}
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# sizes the reference takes: a multiple of 128, and of 2048 rows above that
SIZES = (128, 128 * 96, 128 * 4096)


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to follow a wrapper's checks
    without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(n):
    return _normal(1, (n,)), _normal(2, (n,))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("op", ["copy", "scale", "add"])
def test_stream_bitwise_vs_pallas(n, op):
    a, b = _pair(n)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.from_numpy(a), \
        torch.from_numpy(b)
    want, got = {
        "copy": lambda: (jops.stream_copy(ja), ops.stream_copy(ta)),
        "scale": lambda: (jops.stream_scale(ja, 3.0),
                          ops.stream_scale(ta, 3.0)),
        "add": lambda: (jops.stream_add(ja, jb), ops.stream_add(ta, tb)),
    }[op]()
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("n", SIZES)
def test_stream_triad(n):
    b, c = _pair(n)
    got = ops.stream_triad(torch.from_numpy(b), torch.from_numpy(c), 3.0)
    oracle = jref.stream_triad(jnp.asarray(b), jnp.asarray(c), 3.0)
    assert got.numpy().tobytes() == np.asarray(oracle).tobytes()
    assert got.numpy().tobytes() == (b + np.float32(3.0) * c).tobytes()
    pallas = jops.stream_triad(jnp.asarray(b), jnp.asarray(c), 3.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-5)


@pytest.mark.parametrize("op", ["copy", "scale", "add", "triad"])
def test_stream_bf16_equals_oracle(op):
    x, y = (jnp.asarray(v, jnp.bfloat16) for v in _pair(1024))
    tx, ty = (torch.from_numpy(v).bfloat16() for v in _pair(1024))
    want = {"copy": lambda: jref.stream_copy(x),
            "scale": lambda: jref.stream_scale(x, 3.0),
            "add": lambda: jref.stream_add(x, y),
            "triad": lambda: jref.stream_triad(x, y, 3.0)}[op]()
    got = {"copy": lambda: ops.stream_copy(tx),
           "scale": lambda: ops.stream_scale(tx, 3.0),
           "add": lambda: ops.stream_add(tx, ty),
           "triad": lambda: ops.stream_triad(tx, ty, 3.0)}[op]()
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("op", ["copy", "scale", "add", "triad"])
def test_stream_refuses_size_not_multiple_of_128(op):
    """Both routes raise where the reference asserts; the wrapper raises
    before it would build or launch anything."""
    calls = {"copy": lambda m, v: m.stream_copy(v),
             "scale": lambda m, v: m.stream_scale(v, 3.0),
             "add": lambda m, v: m.stream_add(v, v),
             "triad": lambda m, v: m.stream_triad(v, v, 3.0)}[op]
    with pytest.raises(ValueError, match="multiple of 128"):
        calls(ops, torch.zeros(100))
    with pytest.raises(ValueError, match="multiple of 128"):
        calls(kstream, torch.zeros(100).as_subclass(_CudaTyped))
    with pytest.raises(AssertionError):
        calls(jops, jnp.zeros(100))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (128, 64, 192),
                                   (256, 128, 128), (96, 48, 80)])
def test_matmul_vs_reference(dtype, m, k, n):
    a, b = _normal(3, (m, k)), _normal(4, (k, n))
    want = jops.matmul(jnp.asarray(a, JDTYPE[dtype]),
                       jnp.asarray(b, JDTYPE[dtype]), bm=32, bn=16, bk=16)
    got = ops.matmul(torch.from_numpy(a).to(dtype),
                     torch.from_numpy(b).to(dtype))
    assert got.dtype == dtype and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=ATOL[dtype] * k ** 0.5, rtol=1e-2)


def test_matmul_out_dtype_and_ragged():
    a, b = _normal(5, (37, 53)), _normal(6, (53, 29))
    got = ops.matmul(torch.from_numpy(a).bfloat16(),
                     torch.from_numpy(b).bfloat16(), out_dtype=torch.float32)
    want = jref.matmul(jnp.asarray(a, jnp.bfloat16),
                       jnp.asarray(b, jnp.bfloat16), out_dtype=jnp.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL[torch.float32] * 53 ** 0.5,
                               rtol=1e-2)
    # the plain version sums in gemm_update's order: the same bits as an
    # update of a zero C
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert torch.equal(ref.matmul(ta, tb),
                       ref.gemm_update(torch.zeros(37, 29), ta, tb,
                                       alpha=1.0))


def test_run_stream_cpu():
    res = stream.run_stream(elems_per_device=128 * 512, reps=1, device="cpu")
    assert res.error == 0.0 and res.metric > 0
    assert set(res.details["bandwidth"]) == {"copy", "scale", "add", "triad"}
    assert res.details["device"] == "cpu"


def test_run_stream_draws_distinct_operands():
    """The reference draws a and b from one key (a == b); the port does
    not, so a triad or add with swapped operands fails its check."""
    a, b = stream.make_inputs(1024, "cpu")
    assert not torch.equal(a, b)
    assert not torch.equal(ref.stream_triad(a, b, 3.0),
                           ref.stream_triad(b, a, 3.0))
    a2, _ = stream.make_inputs(1024, "cpu")
    assert torch.equal(a, a2)


def test_run_gemm_cpu():
    m = 96
    res = gemm.run_gemm(m=m, reps=1, device="cpu")
    assert res.error < ATOL[torch.float32] * m ** 0.5 and res.metric > 0
    assert res.details["m"] == m and res.details["device"] == "cpu"
