"""STREAM's copy, scale, add and triad on the card.

Port of ``repro/kernels/stream.py`` (``_run`` ``:43``, ``stream_copy`` ..
``stream_triad`` ``:61-76``). The kernels are ``csrc/stream.cu``: they
replace the TPU kernel ``repro/kernels/stream.py:_run``; the note there says
what bounds them on an H100 (device memory) and how the design answers.
Their plain versions are in :mod:`repro_torch.kernels.ref`.

The grid is sized here, by :func:`stream_geometry`: one CTA per
:data:`CTA_VECTORS` 16-byte vectors, one per thread.

Operands are fp32 or bf16 CUDA tensors of one dtype and one size, which
must be a multiple of :data:`LANES` (the reference asserts the same,
``kernels/stream.py:21``), so both packages take the same inputs. They are
read as flat arrays: each must be contiguous. The math is fp32, one
rounding per operation, cast back once: the results equal the plain
versions bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemm import check_cuda

LANES = 128
_OPS = {"copy": 0, "scale": 1, "add": 2, "triad": 3}
_ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_float, ctypes.c_int64, ctypes.c_void_p]
_ENTRY = {torch.float32: "repro_stream_f32",
          torch.bfloat16: "repro_stream_bf16"}
CTA_VECTORS = 256  # 16-byte vectors per CTA (csrc/stream.cu: THREADS)


def stream_geometry(nvec: int, tile: int) -> int:
    """CTAs for ``nvec`` 16-byte vectors, one CTA per ``tile`` of them, the
    last one partial where ``tile`` does not divide ``nvec``."""
    if nvec <= 0 or tile <= 0:
        raise ValueError(f"no geometry for {nvec} vectors in tiles of {tile}")
    return -(-nvec // tile)


def check_size(x: torch.Tensor) -> None:
    """Raise where the reference asserts: a size not a multiple of 128."""
    if x.numel() % LANES:
        raise ValueError(f"STREAM operands hold a multiple of {LANES} "
                         f"elements, got shape {tuple(x.shape)}")


def _run(op: str, x: torch.Tensor, y: torch.Tensor,
         alpha: float) -> torch.Tensor:
    check_cuda(("x", x), ("y", y))
    check_size(x)
    if x.shape != y.shape or x.dtype != y.dtype or x.dtype not in _ENTRY:
        raise ValueError(f"operands of one shape and one dtype of "
                         f"{list(_ENTRY)}, got {x.dtype}{tuple(x.shape)}, "
                         f"{y.dtype}{tuple(y.shape)}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("STREAM operands must be contiguous")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    ctas = stream_geometry(x.numel() * x.element_size() // 16, CTA_VECTORS)
    fn = getattr(_build.load("stream"), _ENTRY[x.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    _build.check(fn(_OPS[op], x.data_ptr(), y.data_ptr(), out.data_ptr(),
                    x.numel(), float(alpha), ctas,
                    torch.cuda.current_stream(x.device).cuda_stream),
                 f"stream_{op}")
    return out


def stream_copy(a: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: a new tensor holding ``a``."""
    out = _run("copy", a, a, 0.0)
    stream_copy.launches += 1
    return out


def stream_scale(c: torch.Tensor, alpha: float) -> torch.Tensor:
    """Launch the kernel: alpha * c."""
    out = _run("scale", c, c, alpha)
    stream_scale.launches += 1
    return out


def stream_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: a + b."""
    out = _run("add", a, b, 0.0)
    stream_add.launches += 1
    return out


def stream_triad(b: torch.Tensor, c: torch.Tensor,
                 alpha: float) -> torch.Tensor:
    """Launch the kernel: b + alpha * c."""
    out = _run("triad", b, c, alpha)
    stream_triad.launches += 1
    return out


stream_copy.launches = 0
stream_scale.launches = 0
stream_add.launches = 0
stream_triad.launches = 0
