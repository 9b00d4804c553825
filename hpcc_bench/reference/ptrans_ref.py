"""The plain reference of PTRANS, in torch alone: C = B + A^T.

It imports nothing of the port. The benchmark makes A and B from the seed
(:func:`make_inputs`) and hands the same to the port and to
:func:`transpose_add`. C takes one float32 addition per element, so the
port's C must equal the reference's bit for bit (``c_gap`` = 0).
The control, :func:`transpose_add_bf16`, adds in bfloat16.
"""
from __future__ import annotations

import torch


def make_inputs(n: int, seed: int, device):
    """A and B, (n, n) float32 standard normal on ``device``, from
    ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    a = torch.randn((n, n), generator=g, device=device, dtype=torch.float32)
    b = torch.randn((n, n), generator=g, device=device, dtype=torch.float32)
    return a, b


def transpose_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return b + a.T


def transpose_add_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control: C computed in bfloat16, returned in float32."""
    return (b.bfloat16() + a.T.bfloat16()).float()


def c_gap(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
          rows: int = 2048) -> float:
    """max |C - (B + A^T)|, by blocks of rows (no whole copy of C); NaN
    where C holds one."""
    gap = torch.zeros((), dtype=torch.float32, device=c.device)
    for r0 in range(0, b.shape[0], rows):
        r1 = min(b.shape[0], r0 + rows)
        want = transpose_add(a[:, r0:r1], b[r0:r1])
        gap = torch.maximum(gap, (c[r0:r1] - want).abs().max())
    return float(gap)
