"""HPL's diagonal-block LU and panel solves on the card.

Port of ``repro/kernels/lu.py``. The kernels are in ``csrc/lu.cu``:
``lu_factor_block`` replaces the TPU kernel
``repro/kernels/lu.py:lu_factor_block``, ``trsm_lower_left`` replaces
``:trsm_lower_left`` (HPL's Top panel) and ``trsm_upper_right`` replaces
``:trsm_upper_right`` (the Left panel). The note in ``lu.cu`` says what
bounds them on an H100 (latency: chains of b dependent steps) and how the
design answers. Their plain versions are in :mod:`repro_torch.kernels.ref`.

All three take fp32 CUDA tensors. The block size ``n`` is at most
:data:`MAX_BLOCK`: one CTA keeps the (n, n) block in shared memory, and
larger blocks need a global-memory path (ROADMAP B2).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemm import check_cuda, fit_block, row_stride

MAX_BLOCK = 128   # (n, n) fp32 block + a 256-wide slab fit in shared memory
MAX_SLAB = 256    # threads per CTA of the panel solves

_VP, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _entry(name: str, argtypes):
    fn = getattr(_build.load("lu"), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_block(lu: torch.Tensor, name: str) -> int:
    n = lu.shape[0]
    if lu.dim() != 2 or lu.shape[1] != n:
        raise ValueError(f"{name} must be square, got {tuple(lu.shape)}")
    if n > MAX_BLOCK:
        raise ValueError(f"block size {n} > {MAX_BLOCK}: the shared-memory "
                         "kernels take at most that (ROADMAP B2)")
    if lu.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {lu.dtype}")
    return n


def lu_factor_block(a: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: packed L\\U (unit lower diagonal) of the (n, n)
    block ``a``, unpivoted, as a new contiguous tensor."""
    check_cuda(("a", a))
    n = _check_block(a, "a")
    out = torch.empty((n, n), dtype=torch.float32, device=a.device)
    fn = _entry("repro_lu_factor_block_f32", [_VP, _I64, _VP, _INT, _VP])
    _build.check(fn(a.data_ptr(), row_stride(a, "a"), out.data_ptr(), n,
                    _stream(a)), "lu_factor_block")
    lu_factor_block.launches += 1
    return out


def trsm_lower_left(lu: torch.Tensor, b: torch.Tensor, *,
                    bn: int = 256) -> torch.Tensor:
    """Launch the kernel: X = L^{-1} B for packed ``lu`` (n, n) and panel
    ``b`` (n, N), one CTA per ``fit_block(N, bn)`` columns."""
    check_cuda(("lu", lu), ("b", b))
    n = _check_block(lu, "lu")
    if b.dim() != 2 or b.shape[0] != n or b.dtype != torch.float32:
        raise ValueError(f"b must be float32 ({n}, N), got "
                         f"{b.dtype} {tuple(b.shape)}")
    N = b.shape[1]
    out = torch.empty((n, N), dtype=torch.float32, device=b.device)
    slab = fit_block(N, min(bn, MAX_SLAB)) if N else 1
    fn = _entry("repro_trsm_lower_left_f32",
                [_VP, _I64, _VP, _I64, _VP, _INT, _INT, _INT, _VP])
    _build.check(fn(lu.data_ptr(), row_stride(lu, "lu"), b.data_ptr(),
                    row_stride(b, "b"), out.data_ptr(), n, N, slab,
                    _stream(b)), "trsm_lower_left")
    trsm_lower_left.launches += 1
    return out


def trsm_upper_right(lu: torch.Tensor, b: torch.Tensor, *,
                     bm: int = 256) -> torch.Tensor:
    """Launch the kernel: X = B U^{-1} for packed ``lu`` (n, n) and panel
    ``b`` (M, n), one CTA per ``fit_block(M, bm)`` rows."""
    check_cuda(("lu", lu), ("b", b))
    n = _check_block(lu, "lu")
    if b.dim() != 2 or b.shape[1] != n or b.dtype != torch.float32:
        raise ValueError(f"b must be float32 (M, {n}), got "
                         f"{b.dtype} {tuple(b.shape)}")
    M = b.shape[0]
    out = torch.empty((M, n), dtype=torch.float32, device=b.device)
    slab = fit_block(M, min(bm, MAX_SLAB)) if M else 1
    fn = _entry("repro_trsm_upper_right_f32",
                [_VP, _I64, _VP, _I64, _VP, _INT, _INT, _INT, _VP])
    _build.check(fn(lu.data_ptr(), row_stride(lu, "lu"), b.data_ptr(),
                    row_stride(b, "b"), out.data_ptr(), n, M, slab,
                    _stream(b)), "trsm_upper_right")
    trsm_upper_right.launches += 1
    return out


lu_factor_block.launches = 0
trsm_lower_left.launches = 0
trsm_upper_right.launches = 0
