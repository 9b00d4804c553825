"""The yardstick: the reference against NumPy at tiny sizes, the controls
against the sound side, and the metrics' operation and byte arithmetic
against closed forms."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import hpcc_harness as hh
from conftest import BENCH

HPL = hh.reference("hpl_ref", BENCH)
PTRANS = hh.reference("ptrans_ref", BENCH)
ROOF = hh.load_module(BENCH / "metrics" / "hpl.update_roofline.py", "metric")


def numpy_lu(a: np.ndarray) -> np.ndarray:
    """Doolittle without pivoting, one column at a time, in float64."""
    w = a.astype(np.float64).copy()
    for k in range(w.shape[0] - 1):
        w[k + 1:, k] /= w[k, k]
        w[k + 1:, k + 1:] -= np.outer(w[k + 1:, k], w[k, k + 1:])
    return w


@pytest.mark.parametrize("n", [64, 192, 256])
def test_lu_against_numpy(n):
    a = HPL.make_matrix(n, 3, "cpu")
    got = HPL.lu_nopivot(a).numpy()
    want = numpy_lu(a.numpy())
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_matrix_rule_and_seed():
    a = HPL.make_matrix(128, 2 ** 33 + 1, "cpu")
    off = a - torch.diag(torch.diagonal(a))
    assert a.dtype == torch.float32
    assert float(off.abs().max()) <= 0.5
    assert float((torch.diagonal(a) - 128).abs().max()) <= 0.5
    assert torch.equal(a, HPL.make_matrix(128, 2 ** 33 + 1, "cpu"))
    assert not torch.equal(a, HPL.make_matrix(128, 2 ** 33 + 2, "cpu"))


def test_residual_against_numpy():
    n = 128
    a = HPL.make_matrix(n, 4, "cpu")
    lu = HPL.lu_nopivot(a).float()
    a64, lu64 = a.numpy().astype(np.float64), lu.numpy().astype(np.float64)
    b = a64.sum(1)
    low = np.tril(lu64, -1) + np.eye(n)
    x = np.linalg.solve(np.triu(lu64), np.linalg.solve(low, b))
    eps = np.finfo(np.float32).eps
    want = np.abs(a64 @ x - b).max() / (
        eps * (np.abs(a64).sum(1).max() * np.abs(x).max() + np.abs(b).max())
        * n)
    assert HPL.scaled_residual(a, lu) == pytest.approx(want, rel=1e-6)
    assert want < 1


def test_lu_gap():
    a = HPL.make_matrix(128, 5, "cpu")
    ref = HPL.lu_nopivot(a)
    assert HPL.lu_gap(ref.float().double(), ref) < 1e-7
    bad = ref.clone()
    bad[100, 3] *= 1.01
    assert HPL.lu_gap(bad, ref) > 1e-3


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      -3.0 - 2 ** -13], dtype=torch.float32)
    got = HPL.round_tf32(x)
    assert got.tolist() == [1.0, 1.0, 1.0 + 2 ** -10, -3.0]
    assert float((HPL.round_tf32(x) - x).abs().max()) <= 2 ** -11


def test_controls_fail_the_limits():
    """The TF32 control reads far above a sound float32 LU; the bfloat16
    PTRANS control is inexact where the port must be exact."""
    a = HPL.make_matrix(256, 6, "cpu")
    ref = HPL.lu_nopivot(a)
    sound = HPL.lu_gap(HPL.lu_nopivot(a, dtype=torch.float32), ref)
    control = HPL.lu_gap(HPL.lu_nopivot(a, dtype=torch.float32,
                                        tf32=True), ref)
    assert sound < 2e-6 < 1e-4 < control
    A, B = PTRANS.make_inputs(128, 7, "cpu")
    want = PTRANS.transpose_add(A, B)
    np.testing.assert_array_equal(want.numpy(), B.numpy() + A.numpy().T)
    assert PTRANS.c_gap(PTRANS.transpose_add_bf16(A, B), A, B) > 1e-3
    assert PTRANS.c_gap(want, A, B, rows=48) == 0
    bad = want.clone()
    bad[100, 7] = torch.nextafter(bad[100, 7], bad[100, 7] + 1)
    assert PTRANS.c_gap(bad, A, B, rows=48) > 0
    bad[120, 3] = float("nan")
    assert PTRANS.c_gap(bad, A, B, rows=48) != PTRANS.c_gap(bad, A, B, rows=48)


@pytest.mark.parametrize("n,b", [(128, 64), (256, 64), (256, 128)])
def test_blocked_lu_against_numpy(n, b):
    """The blocked float32 LU is an LU of A: within float32 rounding of the
    float64 one, with each element's last step exactly as written."""
    a = HPL.make_matrix(n, 8, "cpu")
    got = HPL.lu_blocked32(a, b)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.double().numpy(), numpy_lu(a.numpy()),
                               rtol=1e-5, atol=1e-7)
    # the first block row is the diagonal block's and U's panel: row 1 less
    # l_10 times row 0, in float32
    l10 = a[1, 0] / a[0, 0]
    assert torch.equal(got[1, 1:], a[1, 1:] - l10 * a[0, 1:])


def test_update_gap_sees_the_update_precision():
    """update_gap reads the blocked LU against itself as 0, a reordered
    float32 LU (the float64 one rounded) well under the TF32 update, and
    the TF32 and bfloat16 updates by their operands' rounding."""
    a = HPL.make_matrix(512, 9, "cpu")
    ref32 = HPL.lu_blocked32(a, 64)
    assert HPL.update_gap(ref32, ref32, a) == 0
    ref64 = HPL.lu_nopivot(a)
    rounded = HPL.update_gap(ref64.float(), ref32, a)
    tf32 = HPL.lu_blocked32(a, 64, operands="tf32")
    bf16 = HPL.lu_blocked32(a, 64, operands="bf16")
    assert rounded < 5e-5 < 1e-4 < HPL.update_gap(tf32, ref32, a) < 5e-4 \
        < 1e-3 < HPL.update_gap(bf16, ref32, a)


@pytest.mark.parametrize("n,b", [(256, 64), (512, 64), (640, 128)])
def test_update_bytes_closed_form(n, b):
    """The trailing updates' bytes and operations summed over iterations
    equal their closed forms: t runs over 0, b, ..., (n/b - 1) b."""
    nb = n // b
    s1 = b * (nb - 1) * nb // 2
    s2 = b * b * (nb - 1) * nb * (2 * nb - 1) // 6
    parts = ROOF.needed(n, b)
    assert sum(p[0] for p in parts) == 4 * (2 * s2 + 2 * b * s1)
    assert sum(p[1] for p in parts) == 2 * b * s2
    # memory-bound at b = 64 on the H100's figures: 8 n^3 / (3 b) bytes
    least = ROOF.least_seconds(n, b, 3.35e12, 67e12)
    assert least == pytest.approx(4 * (2 * s2 + 2 * b * s1) / 3.35e12,
                                  rel=1e-12 if b == 64 else 0.5)
