"""``transpose_add``: C = B + A^T on the card, PTRANS's local compute.

Port of ``repro/kernels/transpose.py:25``. The kernel is
``csrc/transpose_add.cu``: it replaces the TPU kernel
``repro/kernels/transpose.py:transpose_add``; its note there says what bounds
it on an H100 (device memory: 3 * itemsize bytes per element) and how its
design answers. Its plain version is
:func:`repro_torch.kernels.ref.transpose_add`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemm import check_cuda, row_stride

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]
_ENTRY = {torch.float32: "repro_transpose_add_f32",
          torch.bfloat16: "repro_transpose_add_bf16"}


def transpose_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: a new contiguous C (N, M) = B + A^T.

    ``a`` (M, N) and ``b`` (N, M) are fp32 or bf16 CUDA tensors of one
    dtype, each row-major with any row stride (a column strip of a larger
    matrix is passed as it is). Any M and N."""
    check_cuda(("a", a), ("b", b))
    if a.dim() != 2 or b.dim() != 2 or tuple(b.shape) != (a.shape[1],
                                                           a.shape[0]):
        raise ValueError(f"shapes a{tuple(a.shape)} b{tuple(b.shape)}: "
                         "b must be a's transpose shape")
    if a.dtype != b.dtype or b.dtype not in _ENTRY:
        raise TypeError(f"transpose_add takes one dtype of {list(_ENTRY)}, "
                        f"got {a.dtype}, {b.dtype}")
    M, N = a.shape
    out = torch.empty((N, M), dtype=b.dtype, device=b.device)
    fn = getattr(_build.load("transpose_add"), _ENTRY[b.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    _build.check(fn(a.data_ptr(), row_stride(a, "a"), b.data_ptr(),
                    row_stride(b, "b"), out.data_ptr(), max(M, 1), M, N,
                    torch.cuda.current_stream(b.device).cuda_stream),
                 "transpose_add")
    transpose_add.launches += 1
    return out


transpose_add.launches = 0
