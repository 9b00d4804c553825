"""Public kernel entry points, with the reference's names and keywords.

Port of ``repro/kernels/ops.py:35-60``. The tensor's device picks the
implementation, in place of the reference's ``_interp`` flag (``ops.py:25``):
a CUDA tensor goes to the hand-written kernel and a CPU tensor to the plain
version in :mod:`repro_torch.kernels.ref`. Any other device raises. There
is no fallback: a kernel that fails to build or launch raises.

``gemm_update`` updates ``c`` in place on both routes and returns it (the
reference donates ``c`` and aliases the output to it). The block-size
keywords (``bm``/``bn``/``bk``, ``block``) are accepted for the reference's
signatures and ignored on the card: the CUDA tiles are compiled in, and
``gemm_update``'s wrapper picks one of them by C's shape
(``kernels/gemm.py:gemm_geometry``). No result depends on the tiling. The STREAM ops raise for a size that is not a multiple of
128 on both routes, as the reference asserts.

``flash_attention`` keeps the reference's ``bq``/``bk`` contract on both
routes (``min(bq, Sq)`` and ``min(bk, Skv)`` must divide Sq and Skv); the
CPU route computes over those blocks, the CUDA kernels over their own fixed
tiles, which does not change the result beyond fp32 rounding. On the card
the dtype picks the kernel (bf16: tensor cores, fp32: SIMT), and the
wrapper counts launches per route beside ``launches``.

``lu_factor_block``, ``trsm_lower_left`` and ``trsm_upper_right`` pick
their CUDA route by the block size (``kernels/lu.py``) and count launches
per route too; :func:`launches_by_route` gathers every kernel's counts by
route. ``trsm_lower_left`` accepts the reference's ``bn`` and
``trsm_upper_right`` its ``bm``, and both ignore them on the card, where the
kernel's CTA width (height) is fixed and the last CTA is masked.

``ring_add_step`` keeps the reference's (rows, 128) assert on both routes
and takes an optional ``out`` (which may be ``acc``), so the engine can
accumulate into its chunk stack in place.

Twelve kernels: the four HPL kernels, ``transpose_add`` (PTRANS), the four
STREAM ops, ``matmul`` (GEMM), ``flash_attention`` (LM prefill) and
``ring_add_step`` (the allreduce family's per-hop add).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import attention as _attention
from repro_torch.kernels import gemm as _gemm
from repro_torch.kernels import lu as _lu
from repro_torch.kernels import ref
from repro_torch.kernels import ring as _ring
from repro_torch.kernels import stream as _stream
from repro_torch.kernels import transpose as _transpose
from repro_torch.kernels.gemm import fit_block  # noqa: F401  (public)

KERNELS = ("gemm_update", "lu_factor_block", "trsm_lower_left",
           "trsm_upper_right", "transpose_add", "stream_copy",
           "stream_scale", "stream_add", "stream_triad", "matmul",
           "flash_attention", "ring_add_step")
# the kernels each benchmark's main path launches
HPL_KERNELS = KERNELS[:4]
STREAM_KERNELS = KERNELS[5:9]
SERVE_KERNELS = ("flash_attention",)
ALLREDUCE_KERNELS = ("ring_add_step",)


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def gemm_update(c, a, b, *, alpha=-1.0, bm=256, bn=256, bk=256):
    if _on_card(c):
        return _gemm.gemm_update(c, a, b, alpha=alpha)
    return c.copy_(ref.gemm_update(c, a, b, alpha=alpha))


def lu_factor_block(a):
    if _on_card(a):
        return _lu.lu_factor_block(a)
    return ref.lu_factor_block(a)


def trsm_lower_left(lu, b, *, bn=256):
    if _on_card(b):
        return _lu.trsm_lower_left(lu, b)
    return ref.trsm_lower_left(lu, b)


def trsm_upper_right(lu, b, *, bm=256):
    if _on_card(b):
        return _lu.trsm_upper_right(lu, b, bm=bm)
    return ref.trsm_upper_right(lu, b)


def matmul(a, b, *, bm=256, bn=256, bk=256, out_dtype=None):
    if _on_card(a):
        return _gemm.matmul(a, b, out_dtype=out_dtype)
    return ref.matmul(a, b, out_dtype=out_dtype)


def transpose_add(a, b, *, block=256):
    if _on_card(b):
        return _transpose.transpose_add(a, b)
    return ref.transpose_add(a, b)


def stream_copy(a):
    if _on_card(a):
        return _stream.stream_copy(a)
    _stream.check_size(a)
    return ref.stream_copy(a)


def stream_scale(c, alpha):
    if _on_card(c):
        return _stream.stream_scale(c, alpha)
    _stream.check_size(c)
    return ref.stream_scale(c, alpha)


def stream_add(a, b):
    if _on_card(a):
        return _stream.stream_add(a, b)
    _stream.check_size(a)
    return ref.stream_add(a, b)


def stream_triad(b, c, alpha):
    if _on_card(b):
        return _stream.stream_triad(b, c, alpha)
    _stream.check_size(b)
    return ref.stream_triad(b, c, alpha)


def flash_attention(q, k, v, *, causal=True, q_offset=0, bq=512, bk=512):
    _, Sq, _, _, Skv, _ = _attention.check_shapes(q, k, v, q_offset=q_offset)
    ref.fit_blocks(Sq, Skv, bq, bk)
    if _on_card(q):
        return _attention.flash_attention(q, k, v, causal=causal,
                                          q_offset=q_offset)
    return ref.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                               bq=bq, bk=bk)


def ring_add_step(acc, recv, *, out=None):
    _ring.check_operands(acc, recv, out)
    if _on_card(acc):
        return _ring.ring_add_step(acc, recv, out=out)
    res = ref.ring_add_step(acc, recv)
    return res if out is None else out.copy_(res)


def _wrappers():
    return {"gemm_update": _gemm.gemm_update,
            "lu_factor_block": _lu.lu_factor_block,
            "trsm_lower_left": _lu.trsm_lower_left,
            "trsm_upper_right": _lu.trsm_upper_right,
            "transpose_add": _transpose.transpose_add,
            "stream_copy": _stream.stream_copy,
            "stream_scale": _stream.stream_scale,
            "stream_add": _stream.stream_add,
            "stream_triad": _stream.stream_triad,
            "matmul": _gemm.matmul,
            "flash_attention": _attention.flash_attention,
            "ring_add_step": _ring.ring_add_step}


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel (plain-version calls not counted)."""
    return {name: w.launches for name, w in _wrappers().items()}


def launches_by_route() -> Dict[str, Dict[str, int]]:
    """Kernel launches so far by route, for the kernels that have routes
    (``flash_attention``, ``lu_factor_block``, ``trsm_lower_left``,
    ``trsm_upper_right``)."""
    return {name: dict(w.launches_by_route) for name, w in _wrappers().items()
            if hasattr(w, "launches_by_route")}


def reset_launch_counts() -> None:
    """Zero every wrapper's count, and the counts by route."""
    for w in _wrappers().values():
        w.launches = 0
        if hasattr(w, "launches_by_route"):
            w.launches_by_route = dict.fromkeys(w.launches_by_route, 0)
