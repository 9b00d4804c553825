"""The fused local step of the ring reduce-scatter / all-gather allreduce.

Port of ``repro/kernels/ring.py`` (``ring_add_step`` ``:27``,
``fused_chunk_add`` ``:46``). The bandwidth-optimal ring allreduce (the
engine's ``rs_ag``) moves one 1/n-sized chunk per hop: the reduce-scatter
half adds the received chunk into the local accumulator. The kernel is
``csrc/ring_add.cu``: it replaces the TPU kernel
``repro/kernels/ring.py:ring_add_step``; the note there says what bounds it
on an H100 (device memory) and how its design answers. Its plain version
is :func:`repro_torch.kernels.ref.ring_add_step`.

``fused_chunk_add`` is the shape-tolerant entry the engine calls per hop.
On the card every nonempty chunk goes through the kernel, which takes a
flat chunk of any length. On the CPU it keeps the reference's rule: a chunk
whose size is 0 or not a multiple of :data:`LANES` takes the plain add (the
reference's ``acc + recv``; the rule exists only because Pallas lays a
chunk out in (rows, 128) lanes), and every other chunk the plain
``ring_add_step``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemm import check_cuda

LANES = 128
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_void_p]
_ENTRY = {torch.float32: "repro_ring_add_f32",
          torch.bfloat16: "repro_ring_add_bf16",
          torch.float16: "repro_ring_add_f16"}


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype):
    # bound once: the engine calls the kernel once per hop, and at the chunk
    # sizes the L2 holds the host's time per call is what bounds the rate
    fn = getattr(_build.load("ring_add"), _ENTRY[dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def check_operands(acc: torch.Tensor, recv: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> None:
    """Raise where the reference asserts: two (rows, 128) chunks of one
    shape (and an ``out`` of their shape and dtype)."""
    if acc.shape != recv.shape or acc.dim() != 2 or acc.shape[1] != LANES:
        raise ValueError(f"ring_add_step takes two (rows, {LANES}) chunks "
                         f"of one shape, got {tuple(acc.shape)}, "
                         f"{tuple(recv.shape)}")
    _check_out(acc, out)


def _check_out(acc: torch.Tensor, out: Optional[torch.Tensor]) -> None:
    if out is not None and (out.shape != acc.shape or out.dtype != acc.dtype):
        raise ValueError(f"out {out.dtype}{tuple(out.shape)} is not "
                         f"{acc.dtype}{tuple(acc.shape)}")


def ring_add_step(acc: torch.Tensor, recv: torch.Tensor, *,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel: acc + recv in fp32, cast to acc's dtype, into
    ``out`` (a new tensor when None; ``out`` may be ``acc`` itself).

    ``acc`` and ``recv`` are nonempty contiguous CUDA tensors of one shape
    and one dtype of fp32, bf16 and fp16; the kernel reads them flat."""
    named = [("acc", acc), ("recv", recv)] + ([("out", out)] if out is not
                                                 None else [])
    check_cuda(*named)
    if acc.shape != recv.shape or acc.numel() == 0:
        raise ValueError(f"ring_add_step takes two nonempty chunks of one "
                         f"shape, got {tuple(acc.shape)}, {tuple(recv.shape)}")
    _check_out(acc, out)
    if acc.dtype != recv.dtype or acc.dtype not in _ENTRY:
        raise TypeError(f"ring_add_step takes one dtype of {list(_ENTRY)}, "
                        f"got {acc.dtype}, {recv.dtype}")
    if not all(t.is_contiguous() for _, t in named):
        raise ValueError("ring_add_step operands must be contiguous")
    if out is None:
        out = torch.empty_like(acc)
    _build.check(_entry(acc.dtype)(
        acc.data_ptr(), recv.data_ptr(), out.data_ptr(), acc.numel(),
        torch.cuda.current_stream(acc.device).cuda_stream), "ring_add_step")
    ring_add_step.launches += 1
    return out


ring_add_step.launches = 0


def fused_chunk_add(acc: torch.Tensor, recv: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused accumulate for one ring hop: acc + recv, into ``out`` when it
    is given (it may be ``acc``). On the card a nonempty chunk of any length
    launches the kernel; on the CPU a chunk that cannot be laid out as
    (rows, 128) lanes takes the plain add, as in the reference."""
    from repro_torch.kernels import ops  # ops imports this module

    n = acc.numel()
    if n == 0:
        return torch.add(acc, recv, out=out)
    if ops._on_card(acc):
        return ring_add_step(acc, recv, out=out)
    if n % LANES:
        return torch.add(acc, recv, out=out)
    res = ops.ring_add_step(
        acc.reshape(-1, LANES), recv.reshape(-1, LANES),
        out=None if out is None else out.view(-1, LANES))
    return res.view(acc.shape) if out is None else out
