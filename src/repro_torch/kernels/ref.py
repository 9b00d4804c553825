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
add, STREAM and ring-add kernels round once per operation, as these do, so
they agree bit for bit.

The attention versions are the exception: ``attention`` is the dense
oracle, and ``flash_attention`` follows the flash kernel's online softmax
block by block but forms each block's products with fp32 ``matmul`` (TF32
must be off on the card), so it agrees with the kernel to fp32 rounding.
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


def ring_add_step(acc: torch.Tensor, recv: torch.Tensor) -> torch.Tensor:
    """One ring hop's accumulate: acc + recv in fp32, cast to acc's dtype."""
    return (acc.float() + recv.float()).to(acc.dtype)


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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Dense softmax attention with GQA, all in fp32 (port of the reference's
    oracle, ``repro/kernels/ref.py:61-74``). q: (B, Sq, H, hd); k, v:
    (B, Skv, KV, hd); masked scores are -inf."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).float() * (hd ** -0.5)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        mask = torch.arange(Skv, device=q.device)[None, :] <= qpos[:, None]
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


FLASH_MASKED = -1e30


def fit_blocks(Sq: int, Skv: int, bq: int, bk: int):
    """The reference's flash block contract (``attention.py:76-78``):
    ``min(bq, Sq)`` and ``min(bk, Skv)``, which must divide Sq and Skv."""
    bq, bk = min(bq, Sq), min(bk, Skv)
    if bq <= 0 or bk <= 0 or Sq % bq or Skv % bk:
        raise ValueError(f"blocks bq={bq}, bk={bk} do not divide "
                         f"Sq={Sq}, Skv={Skv}")
    return bq, bk


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0, bq: int = 512,
                    bk: int = 512) -> torch.Tensor:
    """The flash kernel's function, over the reference's (bq, bk) blocks:
    q cast to fp32, then scaled by hd^-1/2; per q block an online softmax
    over the kv blocks in order, kv blocks wholly above the causal diagonal
    skipped, masked scores -1e30, output acc / max(l, 1e-30) in q's dtype.
    ``min(bq, Sq)`` and ``min(bk, Skv)`` must divide Sq and Skv."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    bq, bk = fit_blocks(Sq, Skv, bq, bk)
    G = H // KV
    heads = torch.arange(H, device=q.device) // G  # q head -> kv head
    qf = (q.float() * (hd ** -0.5)).transpose(1, 2)   # (B, H, Sq, hd)
    kf = k.float()[:, :, heads].transpose(1, 2)       # (B, H, Skv, hd)
    vf = v.float()[:, :, heads].transpose(1, 2)
    out = torch.empty((B, H, Sq, hd), dtype=torch.float32, device=q.device)
    for i in range(Sq // bq):
        qi = qf[:, :, i * bq:(i + 1) * bq]
        acc = torch.zeros((B, H, bq, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, H, bq, 1), FLASH_MASKED, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        qpos = q_offset + i * bq + torch.arange(bq, device=q.device)
        for j in range(Skv // bk):
            if causal and j * bk > q_offset + i * bq + bq - 1:
                continue
            s = qi @ kf[:, :, j * bk:(j + 1) * bk].transpose(-1, -2)
            if causal:
                kpos = j * bk + torch.arange(bk, device=q.device)
                s = s.masked_fill(kpos[None, :] > qpos[:, None],
                                  FLASH_MASKED)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            m = m_new
            acc = acc * alpha + p @ vf[:, :, j * bk:(j + 1) * bk]
        out[:, :, i * bq:(i + 1) * bq] = acc / l.clamp_min(1e-30)
    return out.transpose(1, 2).to(q.dtype)
