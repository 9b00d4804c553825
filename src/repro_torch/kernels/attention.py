"""``flash_attention``: causal or full GQA attention on the card, the LM's
prefill attention.

Port of ``repro/kernels/attention.py:69``. The kernel is
``csrc/flash_attention.cu``: it replaces the TPU kernel
``repro/kernels/attention.py:flash_attention``; its note there says what
bounds it on an H100 (fp32 operations) and how its design answers. Its plain
version is :func:`repro_torch.kernels.ref.flash_attention`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemm import check_cuda

HEAD_DIMS = (32, 64, 128)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                          ctypes.c_void_p]
_ENTRY = {torch.float32: "repro_flash_attention_f32",
          torch.bfloat16: "repro_flash_attention_bf16"}


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 q_offset: int = 0):
    """(B, Sq, H, hd, Skv, KV) of a valid call; raises on any other."""
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"q must be (B, Sq, H, hd) and k, v one shape "
                         f"(B, Skv, KV, hd); got q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"q{tuple(q.shape)} and k{tuple(k.shape)} do not "
                         "match (batch, head_dim, H a multiple of KV)")
    if min(B, Sq, Skv, H) == 0:
        raise ValueError(f"empty attention: q{tuple(q.shape)} "
                         f"k{tuple(k.shape)}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    return B, Sq, H, hd, Skv, KV


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Launch the kernel: a new contiguous (B, Sq, H, hd) output in q's
    dtype.

    ``q`` (B, Sq, H, hd) and ``k``, ``v`` (B, Skv, KV, hd) are fp32 or bf16
    CUDA tensors of one dtype, each with unit stride on hd and any other
    strides; hd is 32, 64 or 128; H a multiple of KV; any Sq and Skv."""
    check_cuda(("q", q), ("k", k), ("v", v))
    B, Sq, H, hd, Skv, KV = check_shapes(q, k, v, q_offset=q_offset)
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention takes one dtype of {list(_ENTRY)}, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention's kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs unit stride on head_dim, got "
                             f"strides {t.stride()}")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, out)
                                      for s in t.stride()[:3]))
    fn = getattr(_build.load("flash_attention"), _ENTRY[q.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    strides, B, H, KV, Sq, Skv, hd, int(bool(causal)),
                    int(q_offset), float(hd ** -0.5),
                    torch.cuda.current_stream(q.device).cuda_stream),
                 "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
