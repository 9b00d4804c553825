"""Plain PyTorch versions of the port's kernels.

Port of ``repro/kernels/ref.py``. They serve tensors that lie on the
CPU (:mod:`repro_torch.kernels.ops`), and ``chip_smoke.py`` holds each CUDA
kernel against them on the card.

Each one is written out of elementwise tensor ops in the order the CUDA
kernel sums, with no library product or solve: every output element is
formed by the same sequence of rounded operations whatever the shapes
around it are. So a lookahead strip update equals the full update
restricted to that strip bit for bit, on the CPU as on the card. The GEMM,
LU and solve kernels contract each multiply-add into one fused operation,
so kernel and plain version agree to rounding, not bitwise. The transpose-
add and STREAM kernels round once per operation, as these do, so they agree
bit for bit.
"""
from __future__ import annotations

import torch


def gemm_update(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                alpha: float = -1.0) -> torch.Tensor:
    """C + alpha * A @ B in fp32, cast to C's dtype; the product sums over
    K in ascending order, one rank-1 term at a time."""
    a32, b32 = a.float(), b.float()
    acc = torch.zeros(c.shape, dtype=torch.float32, device=c.device)
    for k in range(a.shape[1]):
        acc += a32[:, k, None] * b32[None, k, :]
    return (c.float() + alpha * acc).to(c.dtype)


def matmul(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """A @ B in fp32, cast to ``out_dtype`` (default A's dtype); the sums
    run over K in ascending order, one rank-1 term at a time, as in
    :func:`gemm_update`."""
    a32, b32 = a.float(), b.float()
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for k in range(a.shape[1]):
        acc += a32[:, k, None] * b32[None, k, :]
    return acc.to(out_dtype or a.dtype)


def transpose_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = B + A^T: one fp32 addition per element, cast to B's dtype."""
    return (b.float() + a.float().T).to(b.dtype)


def stream_copy(a: torch.Tensor) -> torch.Tensor:
    return a.clone()


def stream_scale(c: torch.Tensor, alpha: float) -> torch.Tensor:
    return (alpha * c.float()).to(c.dtype)


def stream_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() + b.float()).to(a.dtype)


def stream_triad(b: torch.Tensor, c: torch.Tensor,
                 alpha: float) -> torch.Tensor:
    """b + alpha * c: the product rounded, then the sum (no fused
    multiply-add, as in the kernel)."""
    return (b.float() + alpha * c.float()).to(b.dtype)


def lu_factor_block(a: torch.Tensor) -> torch.Tensor:
    """Packed L\\U (unit lower diag), no pivoting, in fp32 (Doolittle, one
    rank-1 update of the trailing block per step)."""
    a = a.float().clone()
    n = a.shape[0]
    for k in range(n):
        a[k + 1:, k] /= a[k, k]
        a[k + 1:, k + 1:] -= a[k + 1:, k, None] * a[None, k, k + 1:]
    return a


def unpack_lu(lu: torch.Tensor):
    l = torch.tril(lu, -1) + torch.eye(lu.shape[0], dtype=lu.dtype,
                                       device=lu.device)
    u = torch.triu(lu)
    return l, u


def trsm_lower_left(lu: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """X = L^{-1} B, L the unit-lower part of packed ``lu``: forward
    substitution, row k subtracted from the rows below it in turn."""
    l = lu.float()
    x = b.float().clone()
    for k in range(l.shape[0]):
        x[k + 1:] -= l[k + 1:, k, None] * x[None, k]
    return x.to(b.dtype)


def trsm_upper_right(lu: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """X = B U^{-1}, U the upper part of packed ``lu`` (non-unit diagonal):
    column j divided by U[j, j], then subtracted from the columns right of
    it in turn."""
    u = lu.float()
    x = b.float().clone()
    for j in range(u.shape[0]):
        x[:, j] /= u[j, j]
        x[:, j + 1:] -= x[:, j, None] * u[None, j, j + 1:]
    return x.to(b.dtype)
