"""The plain reference of HPL under the HPL-AI rule, in torch alone.

It imports nothing of the port, and takes nothing the port made: the
benchmark hands it the same A as the port, and it reads the port's LU
factors only to judge them.

- :func:`make_matrix`: A of order n from the seed, on the device: entries
  uniform in [-0.5, 0.5), n added to the diagonal (diagonally dominant, so
  LU needs no pivoting); x = ones and b = A x are implied.
- :func:`lu_nopivot`: the packed L\\U of A without pivoting, recursively
  (halves; a 64-column base case of rank-1 updates), in float64. The panels
  are products with the inverses of the diagonal blocks' triangles, so
  every product the factorization needs is a matrix multiply; with
  ``tf32=True`` in float32 those multiplies run in TF32 (a control).
- :func:`lu_blocked32`: the packed L\\U in float32 by the right-looking
  blocked algorithm the configuration states (blocks of b), each element
  formed by the same sequence of rounded operations as HPL's: the diagonal
  block and both panel solves one rank-1 term at a time in ascending order,
  each trailing update one rank-b product rounded once into C. With
  ``operands`` the trailing updates read their operands rounded to TF32 or
  bfloat16 (the controls of the update).
- :func:`lu_gap`: the largest gap between two packed LUs, element by
  element, relative to the reference element's size plus the mean size of
  its part (L below the diagonal, U above it, U's diagonal).
- :func:`update_gap`: the gap between the sums of trailing updates that two
  packed LUs imply, D = A - the factors (a_ij - u_ij above the diagonal,
  a_ij - l_ij u_jj below it), as ||D - D_ref||_F / ||D_ref||_F.
- :func:`scaled_residual`: ||Ax - b||_inf / (eps (||A||_inf ||x||_inf +
  ||b||_inf) n), HPL's form, for the x that triangular solves with given
  factors give, in float64, with eps float32's machine epsilon, 2^-23
  (HPL's own takes float64's).
"""
from __future__ import annotations

import contextlib

import torch

EPS32 = float(torch.finfo(torch.float32).eps)
ROWS = 2048  # rows per block where a whole float64 copy is not needed


def make_matrix(n: int, seed: int, device) -> torch.Tensor:
    """A (n, n) float32 on ``device`` by the HPL-AI rule, from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    a = torch.rand((n, n), generator=g, device=device, dtype=torch.float32)
    a -= 0.5
    a.diagonal().add_(float(n))
    return a


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest even:
    what the tensor cores read of an operand."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


@contextlib.contextmanager
def _tf32_matmul(on: bool):
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def _mm(x: torch.Tensor, y: torch.Tensor, tf32) -> torch.Tensor:
    if not tf32:
        return x @ y
    if x.device.type == "cuda":
        with _tf32_matmul(True):
            return x @ y
    return round_tf32(x) @ round_tf32(y)


def _lu(w: torch.Tensor, tf32, base: int) -> None:
    n = w.shape[0]
    if n <= base:
        for j in range(n - 1):
            w[j + 1:, j] /= w[j, j]
            w[j + 1:, j + 1:].addr_(w[j + 1:, j], w[j, j + 1:], alpha=-1)
        return
    h = max(base, (n // 2) // base * base)
    _lu(w[:h, :h], tf32, base)
    eye = torch.eye(h, dtype=w.dtype, device=w.device)
    l_inv = torch.linalg.solve_triangular(w[:h, :h], eye, upper=False,
                                          unitriangular=True)
    u_inv = torch.linalg.solve_triangular(w[:h, :h], eye, upper=True)
    del eye
    w[:h, h:] = _mm(l_inv, w[:h, h:], tf32)
    del l_inv
    w[h:, :h] = _mm(w[h:, :h], u_inv, tf32)
    del u_inv
    w[h:, h:] -= _mm(w[h:, :h], w[:h, h:], tf32)
    _lu(w[h:, h:], tf32, base)


def lu_nopivot(a: torch.Tensor, *, dtype=torch.float64, tf32: bool = False,
               base: int = 64) -> torch.Tensor:
    """The packed L\\U (unit lower L) of ``a`` without pivoting, computed in
    ``dtype``; ``tf32`` runs every matrix multiply in TF32 (float32 only)."""
    if tf32 and dtype != torch.float32:
        raise ValueError("TF32 multiplies take float32")
    w = a.to(dtype=dtype, copy=True)
    _lu(w, tf32, base)
    return w


ROUND = {"tf32": round_tf32,
         "bf16": lambda x: x.bfloat16().float()}


def lu_blocked32(a: torch.Tensor, b: int, *,
                 operands: str = "") -> torch.Tensor:
    """The packed L\\U of ``a`` without pivoting, in float32, by blocks of
    ``b``: per block, the diagonal block's LU (the column divided by the
    pivot, then a rank-1 update of the rest), U's row panel (row j of the
    block subtracted from the rows below it, j ascending), L's column panel
    (column j divided by U's diagonal, then subtracted from the columns
    right of it, j ascending), and the trailing block less L's panel times
    U's, the product summed in float32 and rounded once into it, with its
    operands first rounded by ``ROUND[operands]`` where given."""
    n = a.shape[0]
    if n % b:
        raise ValueError(f"n = {n} is not a multiple of b = {b}")
    rnd = ROUND[operands] if operands else None
    w = a.to(torch.float32, copy=True)
    with _tf32_matmul(False):
        for k0 in range(0, n, b):
            k1 = k0 + b
            d = w[k0:k1, k0:k1]
            for j in range(b):
                d[j + 1:, j] /= d[j, j]
                d[j + 1:, j + 1:] -= d[j + 1:, j, None] * d[None, j, j + 1:]
            if k1 == n:
                break
            row = w[k0:k1, k1:]
            for j in range(b - 1):
                row[j + 1:] -= d[j + 1:, j, None] * row[None, j]
            col = w[k1:, k0:k1]
            for j in range(b):
                col[:, j] /= d[j, j]
                col[:, j + 1:] -= col[:, j, None] * d[None, j, j + 1:]
            x, y = (rnd(col), rnd(row)) if rnd else (col, row)
            w[k1:, k1:].addmm_(x, y, alpha=-1)
    return w


def _parts(r0: int, r1: int, n: int, device):
    i = torch.arange(r0, r1, device=device)[:, None]
    j = torch.arange(n, device=device)[None, :]
    return i > j, i < j, i == j


def lu_gap(lu: torch.Tensor, ref: torch.Tensor) -> float:
    """max |lu - ref| / (|ref| + m), m the mean |ref| over the element's
    part: L (below the diagonal), U (above it) or U's diagonal. In float64,
    by blocks of rows."""
    n = ref.shape[0]
    sums = torch.zeros(3, dtype=torch.float64, device=ref.device)
    for r0 in range(0, n, ROWS):
        r1 = min(n, r0 + ROWS)
        x = ref[r0:r1].abs().to(torch.float64)
        for k, mask in enumerate(_parts(r0, r1, n, ref.device)):
            sums[k] += (x * mask).sum()
    off = max(n * (n - 1) // 2, 1)
    means = sums / torch.tensor([off, off, n], dtype=torch.float64,
                                device=ref.device)
    gap = torch.zeros((), dtype=torch.float64, device=ref.device)
    for r0 in range(0, n, ROWS):
        r1 = min(n, r0 + ROWS)
        x = ref[r0:r1].to(torch.float64)
        scale = torch.zeros_like(x)
        for k, mask in enumerate(_parts(r0, r1, n, ref.device)):
            scale += mask * means[k]
        d = (lu[r0:r1].to(torch.float64) - x).abs() / (x.abs() + scale)
        gap = torch.maximum(gap, d.max())
    return float(gap)


def update_gap(lu: torch.Tensor, ref: torch.Tensor,
               a: torch.Tensor) -> float:
    """||D - D_ref||_F / ||D_ref||_F over the off-diagonal elements, D = A -
    the packed factors ``lu`` (a_ij - u_ij above the diagonal, a_ij - l_ij
    u_jj below it) and D_ref the same of ``ref``: the sum of the trailing
    updates each element took, in which a lower precision of the update
    shows at its full relative size. In float64, by blocks of rows."""
    n = ref.shape[0]
    u_lu = torch.diagonal(lu).to(torch.float64)
    u_ref = torch.diagonal(ref).to(torch.float64)
    num = torch.zeros((), dtype=torch.float64, device=ref.device)
    den = torch.zeros((), dtype=torch.float64, device=ref.device)
    for r0 in range(0, n, ROWS):
        r1 = min(n, r0 + ROWS)
        low, up, _ = _parts(r0, r1, n, ref.device)
        x = a[r0:r1].to(torch.float64)
        p = lu[r0:r1].to(torch.float64)
        q = ref[r0:r1].to(torch.float64)
        d_lu = torch.where(low, x - p * u_lu, x - p) * (low | up)
        d_ref = torch.where(low, x - q * u_ref, x - q) * (low | up)
        num += ((d_lu - d_ref) ** 2).sum()
        den += (d_ref ** 2).sum()
    return float((num / den).sqrt()) if float(den) > 0 else 0.0


def scaled_residual(a: torch.Tensor, lu: torch.Tensor) -> float:
    """HPL's scaled residual of the solve with the packed factors ``lu`` of
    ``a``, b = A ones, all in float64."""
    n = a.shape[0]
    b = torch.cat([a[r:r + ROWS].to(torch.float64).sum(1)
                   for r in range(0, n, ROWS)])
    lu64 = lu.to(torch.float64)
    y = torch.linalg.solve_triangular(lu64, b[:, None], upper=False,
                                      unitriangular=True)
    x = torch.linalg.solve_triangular(lu64, y, upper=True)[:, 0]
    del lu64, y
    r_inf = a_inf = 0.0
    for r in range(0, n, ROWS):
        blk = a[r:r + ROWS].to(torch.float64)
        r_inf = max(r_inf, float((blk @ x - b[r:r + ROWS]).abs().max()))
        a_inf = max(a_inf, float(blk.abs().sum(1).max()))
    x_inf, b_inf = float(x.abs().max()), float(b.abs().max())
    return r_inf / (EPS32 * (a_inf * x_inf + b_inf) * n)
