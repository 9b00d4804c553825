"""What the redesigned HPL panel kernels rest on, checked on the CPU.

The warp route of ``lu_factor_block`` factors an (n, n) block padded to
(64, 64) with an identity block, the lower solve pads the panel's rows with
zeros to 64 or 128, and the upper solve pads U with an identity block and
the panel's columns with zeros to 64 or 128: the plain versions show that
the top-left results of the padded problem equal the unpadded ones bit for
bit, and stay within the JAX reference's tolerances
(``tests/test_kernels.py``: rtol = atol = 1e-5 for the LU, 1e-4 for the
solves). The wrappers' choice of route and
launch geometry are plain Python, checked here with the kernel call
replaced by a recorder; the CUDA kernels themselves run in
``chip_smoke.py`` phase ``kernels``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import lu as klu
from repro_torch.kernels import ops, ref

PADS = [(16, 64), (48, 64), (64, 64), (16, 128), (48, 128), (64, 128)]


def _dominant(seed, n):
    a = np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)
    a[np.arange(n), np.arange(n)] += n  # diagonally dominant (HPL-AI rule)
    return a


def _pad_identity(a, np_):
    n = a.shape[0]
    out = np.eye(np_, dtype=np.float32)
    out[:n, :n] = a
    return out


def _pad_rows(b, np_):
    out = np.zeros((np_, b.shape[1]), np.float32)
    out[:b.shape[0]] = b
    return out


@pytest.mark.parametrize("n,np_", PADS)
def test_identity_padding_keeps_lu_bits(n, np_):
    a = _dominant(n, n)
    padded = ref.lu_factor_block(torch.from_numpy(_pad_identity(a, np_)))
    assert torch.equal(padded[:n, :n], ref.lu_factor_block(torch.from_numpy(a)))
    # the padding's own factors are the identity's
    assert torch.equal(padded[n:, n:], torch.eye(np_ - n))


@pytest.mark.parametrize("n,np_", PADS)
def test_zero_rows_keep_lower_solve_bits(n, np_):
    lu = ref.lu_factor_block(torch.from_numpy(_dominant(n + 1, n)))
    b = np.random.default_rng(n).standard_normal((n, 200)).astype(np.float32)
    lu_pad = torch.from_numpy(_pad_identity(lu.numpy(), np_))
    got = ref.trsm_lower_left(lu_pad, torch.from_numpy(_pad_rows(b, np_)))
    assert torch.equal(got[:n], ref.trsm_lower_left(lu, torch.from_numpy(b)))
    assert not got[n:].any()


def _pad_cols(b, np_):
    out = np.zeros((b.shape[0], np_), np.float32)
    out[:, :b.shape[1]] = b
    return out


@pytest.mark.parametrize("n,np_", PADS)
def test_zero_columns_keep_upper_solve_bits(n, np_):
    lu = ref.lu_factor_block(torch.from_numpy(_dominant(n + 5, n)))
    b = np.random.default_rng(n + 6).standard_normal((200, n)).astype(
        np.float32)
    lu_pad = torch.from_numpy(_pad_identity(lu.numpy(), np_))
    got = ref.trsm_upper_right(lu_pad, torch.from_numpy(_pad_cols(b, np_)))
    assert torch.equal(got[:, :n],
                       ref.trsm_upper_right(lu, torch.from_numpy(b)))
    assert not got[:, n:].any()


@pytest.mark.parametrize("oracle", ["pallas", "ref"])
@pytest.mark.parametrize("n,np_", PADS)
def test_padded_upper_solve_within_reference(oracle, n, np_):
    lu = np.array(jref.lu_factor_block(jnp.asarray(_dominant(n + 7, n))))
    b = np.random.default_rng(n + 8).standard_normal((128, n)).astype(
        np.float32)
    if oracle == "pallas":
        want = jops.trsm_upper_right(jnp.asarray(lu), jnp.asarray(b), bm=64)
    else:
        want = jref.trsm_upper_right(jnp.asarray(lu), jnp.asarray(b))
    got = ref.trsm_upper_right(torch.from_numpy(_pad_identity(lu, np_)),
                               torch.from_numpy(_pad_cols(b, np_)))[:, :n]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("oracle", ["pallas", "ref"])
@pytest.mark.parametrize("n", [16, 48, 64])
def test_padded_lu_within_reference(oracle, n):
    a = _dominant(n + 2, n)
    fn = jops.lu_factor_block if oracle == "pallas" else jref.lu_factor_block
    want = np.asarray(fn(jnp.asarray(a)))
    got = ref.lu_factor_block(torch.from_numpy(_pad_identity(a, 64)))[:n, :n]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("oracle", ["pallas", "ref"])
@pytest.mark.parametrize("n", [16, 48, 64])
def test_padded_lower_solve_within_reference(oracle, n):
    lu = np.array(jref.lu_factor_block(jnp.asarray(_dominant(n + 3, n))))
    b = np.random.default_rng(n + 4).standard_normal((n, 128)).astype(
        np.float32)
    if oracle == "pallas":
        want = jops.trsm_lower_left(jnp.asarray(lu), jnp.asarray(b), bn=64)
    else:
        want = jref.trsm_lower_left(jnp.asarray(lu), jnp.asarray(b))
    got = ref.trsm_lower_left(torch.from_numpy(_pad_identity(lu, 64)),
                              torch.from_numpy(_pad_rows(b, 64)))[:n]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("n,lu_route,trsm_route", [
    (1, "warp_regs", "regs64"), (48, "warp_regs", "regs64"),
    (64, "warp_regs", "regs64"), (65, "cta_smem", "regs128"),
    (128, "cta_smem", "regs128")])
def test_routes_by_block_size(n, lu_route, trsm_route):
    assert klu.lu_route(n) == lu_route
    assert klu.trsm_lower_route(n) == trsm_route


@pytest.mark.parametrize("route_of", [klu.lu_route, klu.trsm_lower_route])
def test_no_route_past_the_largest_block(route_of):
    with pytest.raises(ValueError, match="no route takes it"):
        route_of(129)


@pytest.mark.parametrize("n,route", [(1, "regs64"), (48, "regs64"),
                                     (64, "regs64"), (65, "regs128"),
                                     (128, "regs128")])
def test_upper_solve_route_by_block_size(n, route):
    assert klu.trsm_upper_route(n) == route
    assert klu.TRSM_UPPER_ROUTES == {"regs64": 64, "regs128": 128}


def test_no_upper_solve_route_past_the_largest_block():
    with pytest.raises(ValueError, match="no route takes it"):
        klu.trsm_upper_route(129)


@pytest.mark.parametrize("M,ctas,last", [(16384, 128, 128), (1009, 8, 113),
                                         (1, 1, 1), (127, 1, 127),
                                         (128, 1, 128), (129, 2, 1)])
def test_upper_solve_geometry_masks_the_last_cta(M, ctas, last):
    got, rows = klu.trsm_upper_geometry(M)
    assert (got, rows) == (ctas, klu.TRSM_UPPER_ROWS) and rows == 128
    # every CTA but the last is full; the last holds the rest, masked
    assert M - (got - 1) * rows == last and 0 < last <= rows


@pytest.mark.parametrize("N,ctas,last", [(16384, 128, 128), (1000, 8, 104),
                                         (1009, 8, 113), (1, 1, 1),
                                         (128, 1, 128), (129, 2, 1)])
def test_lower_solve_geometry_masks_the_last_cta(N, ctas, last):
    got, cols = klu.trsm_lower_geometry(N)
    assert (got, cols) == (ctas, klu.TRSM_LOWER_COLS) and cols == 128
    # every CTA but the last is full; the last holds the rest, masked, and
    # is never shrunk to a divisor of N
    assert N - (got - 1) * cols == last and 0 < last <= cols


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to follow a wrapper without
    a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.fixture
def recorder(monkeypatch):
    """Replace the C entry points by a recorder of their arguments."""
    calls = []

    def entry(name, argtypes):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    real_empty = torch.empty
    monkeypatch.setattr(klu, "_entry", entry)
    monkeypatch.setattr(klu, "_stream", lambda t: 0)
    monkeypatch.setattr(klu.torch, "empty", lambda shape, dtype, device:
                        real_empty(shape, dtype=dtype))
    ops.reset_launch_counts()
    yield calls
    ops.reset_launch_counts()


@pytest.mark.parametrize("n,route,index", [(64, "warp_regs", 0),
                                           (48, "warp_regs", 0),
                                           (65, "cta_smem", 1),
                                           (128, "cta_smem", 1)])
def test_lu_wrapper_launches_its_route(recorder, n, route, index):
    a = torch.from_numpy(_dominant(5, n)).as_subclass(_CudaTyped)
    klu.lu_factor_block(a)
    (name, args), = recorder
    assert name == "repro_lu_factor_block_f32" and args[3:5] == (n, index)
    assert klu.lu_factor_block.launches == 1
    assert ops.launches_by_route()["lu_factor_block"] == {
        r: int(r == route) for r in klu.LU_ROUTES}


@pytest.mark.parametrize("n,N,route,np_", [(64, 16384, "regs64", 64),
                                           (48, 1009, "regs64", 64),
                                           (128, 1000, "regs128", 128)])
def test_lower_solve_wrapper_launches_its_geometry(recorder, n, N, route,
                                                   np_):
    lu = torch.zeros((n, n)).as_subclass(_CudaTyped)
    b = torch.zeros((n, N + 3))[:, 3:].as_subclass(_CudaTyped)  # strided
    klu.trsm_lower_left(lu, b)
    (name, args), = recorder
    assert name == "repro_trsm_lower_left_f32"
    assert args[3] == N + 3  # b's row stride
    assert args[5:9] == (n, N, np_, klu.trsm_lower_geometry(N)[0])
    assert ops.launches_by_route()["trsm_lower_left"] == {
        r: int(r == route) for r in klu.TRSM_LOWER_ROUTES}


@pytest.mark.parametrize("n,M,route,np_", [(64, 16384, "regs64", 64),
                                           (48, 1009, "regs64", 64),
                                           (128, 1000, "regs128", 128),
                                           (65, 127, "regs128", 128)])
def test_upper_solve_wrapper_launches_its_geometry(recorder, n, M, route,
                                                   np_):
    lu = torch.zeros((n, n)).as_subclass(_CudaTyped)
    b = torch.zeros((M, n + 3))[:, 3:].as_subclass(_CudaTyped)  # strided
    klu.trsm_upper_right(lu, b, bm=7)  # the reference's bm: ignored
    (name, args), = recorder
    assert name == "repro_trsm_upper_right_f32"
    assert args[1] == n and args[3] == n + 3  # lu's and b's row strides
    assert args[5:9] == (n, M, np_, klu.trsm_upper_geometry(M)[0])
    assert klu.trsm_upper_right.launches == 1
    assert ops.launches_by_route()["trsm_upper_right"] == {
        r: int(r == route) for r in klu.TRSM_UPPER_ROUTES}


@pytest.mark.parametrize("bm", [7, 64, 256])
def test_ops_upper_solve_takes_the_references_bm(bm):
    lu = ref.lu_factor_block(torch.from_numpy(_dominant(11, 48)))
    b = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (1009, 48)).astype(np.float32))
    assert torch.equal(ops.trsm_upper_right(lu, b, bm=bm),
                       ref.trsm_upper_right(lu, b))


def test_upper_solve_counts_stay_on_cpu_and_reset():
    ops.reset_launch_counts()
    lu = ops.lu_factor_block(torch.from_numpy(_dominant(13, 48)))
    ops.trsm_upper_right(lu, torch.ones((1009, 48)))
    assert ops.launch_counts()["trsm_upper_right"] == 0
    with pytest.raises(ValueError, match="CUDA device"):
        klu.trsm_upper_right(lu, lu)
    klu.trsm_upper_right.launches_by_route["regs128"] += 3
    ops.reset_launch_counts()
    assert klu.trsm_upper_right.launches_by_route == {"regs64": 0,
                                                      "regs128": 0}


def test_counts_do_not_move_on_cpu_tensors():
    ops.reset_launch_counts()
    a = torch.from_numpy(_dominant(9, 48))
    lu = ops.lu_factor_block(a)
    ops.trsm_lower_left(lu, torch.ones((48, 1009)))
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}
    assert ops.launches_by_route() == {
        "gemm_update": {"simt_f32": 0, "wgmma_bf16": 0},
        "lu_factor_block": {"warp_regs": 0, "cta_smem": 0},
        "trsm_lower_left": {"regs64": 0, "regs128": 0},
        "trsm_upper_right": {"regs64": 0, "regs128": 0},
        "flash_attention": {"simt_f32": 0, "wgmma_bf16": 0}}
    for wrapper in (klu.lu_factor_block,
                    lambda t: klu.trsm_lower_left(t, t)):
        with pytest.raises(ValueError, match="CUDA device"):
            wrapper(a)
    assert sum(sum(r.values()) for r in ops.launches_by_route().values()) == 0


def test_reset_zeroes_the_counts_by_route():
    klu.lu_factor_block.launches_by_route["cta_smem"] += 2
    klu.trsm_lower_left.launches_by_route["regs64"] += 1
    ops.reset_launch_counts()
    assert klu.lu_factor_block.launches_by_route == {"warp_regs": 0,
                                                     "cta_smem": 0}
    assert klu.trsm_lower_left.launches_by_route == {"regs64": 0,
                                                     "regs128": 0}
