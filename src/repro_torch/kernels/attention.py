"""``flash_attention``: causal or full GQA attention on the card, the LM's
prefill attention.

Port of ``repro/kernels/attention.py:69``. The kernels are in
``csrc/flash_attention.cu``; they replace the TPU kernel
``repro/kernels/attention.py:flash_attention`` and compute its function: q,
k and v cast to fp32, S, P, m, l and the accumulator in fp32, masked scores
-1e30, ``acc / max(l, 1e-30)`` rounded once to q's dtype. What bounds them
on an H100 is operations: 51.5 GFLOP at the serving prefill, 0.77 ms on the
fp32 pipes, 0.052 ms on the bf16 tensor cores. The dtype alone picks the
route:

- ``wgmma_bf16`` (bf16, the serving path): Hopper's tensor cores, fed by
  TMA through a 3-stage K/V ring; persistent CTAs, one per SM, walk the
  (batch * head, 128 q rows) items with a producer warpgroup and two
  consumer warpgroups that overlap the softmax of one key tile with the
  products of the last. S = Q K^T runs on
  the bf16 operands with fp32 sums (a bf16 product is exact in fp32) and
  is scaled in fp32 afterwards. P stays fp32 for the softmax and is split
  for P V into ``P_hi = bf16(P)`` and ``P_lo = bf16(P - P_hi)``: ``acc +=
  P_hi V + P_lo V`` errs by about 2^-17 |P| per term, so it is the product
  of the fp32 P, not of a bf16 P (which would be another function). The
  split costs 1.5x the function's tensor-core work.
- ``simt_f32`` (fp32): a SIMT kernel on the fp32 pipes (fp32 operands
  cannot enter the bf16 tensor cores without changing the function, and
  TF32 would round them), bounded by those pipes. One CTA per (batch *
  head, 128 q rows): a producer warpgroup keeps the q tile and the K and V
  tiles of 64 keys in flight by ``cp.async`` through a 3-slot ring guarded
  by mbarriers, while eight consumer warps, each owning 16 q rows, sum 8 x
  4 blocks of S and 8 rows of acc per thread from float4 shared reads,
  with no CTA-wide barrier between tiles; a warp skips a key tile that
  lies wholly past its rows.

A bf16 call that TMA cannot load raises ``ValueError`` naming the
constraint; it never goes to the other route or to the plain version,
:func:`repro_torch.kernels.ref.flash_attention`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemm import TMA_ALIGN, check_cuda

HEAD_DIMS = (32, 64, 128)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                          ctypes.c_void_p]
_ENTRY = {torch.float32: "repro_flash_attention_f32",
          torch.bfloat16: "repro_flash_attention_bf16"}
ROUTES = {torch.float32: "simt_f32", torch.bfloat16: "wgmma_bf16"}


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


def check_tma(name: str, t: torch.Tensor) -> None:
    """Raise unless TMA can load ``t``: a 16-byte aligned address, and
    (batch, seq, head) strides that are positive multiples of 16 bytes
    (a dim of size 1 is never stepped, so its stride is free)."""
    size = t.element_size()
    if t.data_ptr() % TMA_ALIGN:
        raise ValueError(f"flash_attention's bf16 kernel loads {name} by TMA, "
                         f"which needs a {TMA_ALIGN}-byte aligned address; "
                         f"got {name}.data_ptr() % {TMA_ALIGN} = "
                         f"{t.data_ptr() % TMA_ALIGN}")
    for dim in range(3):
        st = t.stride(dim) * size
        if t.shape[dim] > 1 and (st <= 0 or st % TMA_ALIGN):
            raise ValueError(f"flash_attention's bf16 kernel loads {name} by "
                             f"TMA, which needs its (batch, seq, head) strides "
                             f"to be positive multiples of {TMA_ALIGN} bytes; "
                             f"got strides {t.stride()} ({st} bytes on dim "
                             f"{dim})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Launch the kernel of q's dtype: a new contiguous (B, Sq, H, hd)
    output in that dtype.

    ``q`` (B, Sq, H, hd) and ``k``, ``v`` (B, Skv, KV, hd) are fp32 or bf16
    CUDA tensors of one dtype, each with unit stride on hd and any other
    strides (bf16: as TMA allows, see :func:`check_tma`); hd is 32, 64 or
    128; H a multiple of KV; any Sq and Skv."""
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
        if q.dtype == torch.bfloat16:
            check_tma(name, t)
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
    flash_attention.launches_by_route[ROUTES[q.dtype]] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES.values(), 0)
