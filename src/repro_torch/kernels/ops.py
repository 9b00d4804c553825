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

On a meta tensor (the dry run, :mod:`repro_torch.launch.dryrun`) a
wrapper launches nothing: it adds one call and its kernel's own operation
and byte counts (the formulas behind ``PERF.md`` §6's bounds: each
operand read once, each output written once) to :func:`dry_counts`, and
returns an empty output of the kernel's shape. That path exists only for
the meta device; it never touches the launch counts.

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


_DRY: Dict[str, Dict[str, float]] = {}


def _meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


def _dry(name: str, flops: float, nbytes: float, out):
    d = _DRY.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
    d["calls"] += 1
    d["flops"] += float(flops)
    d["bytes"] += float(nbytes)
    return out


def dry_counts() -> Dict[str, Dict[str, float]]:
    """Per kernel, the calls made on meta tensors since the last
    :func:`reset_dry_counts`, with their operations and bytes."""
    return {k: dict(v) for k, v in _DRY.items()}


def reset_dry_counts() -> None:
    _DRY.clear()


def _nb(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def lu_flops(b: int) -> int:
    """Operations of the unpivoted LU of a (b, b) block: per step k the
    (b-k-1) divisions and 2 (b-k-1)^2 multiply-adds."""
    return b * (b - 1) // 2 + (b - 1) * b * (2 * b - 1) // 3


def flash_pairs(Sq: int, Skv: int, causal: bool, q_offset: int = 0) -> int:
    """(query, key) pairs the mask keeps: sum of min(Skv, q_offset+i+1)."""
    if not causal:
        return Sq * Skv
    t = min(max(Skv - q_offset, 0), Sq)
    return t * q_offset + t * (t + 1) // 2 + (Sq - t) * Skv


def gemm_update(c, a, b, *, alpha=-1.0, bm=256, bn=256, bk=256):
    if _meta(c):
        return _dry("gemm_update", 2 * c.numel() * a.shape[1],
                    _nb(a, b) + 2 * _nb(c), c)
    if _on_card(c):
        return _gemm.gemm_update(c, a, b, alpha=alpha)
    return c.copy_(ref.gemm_update(c, a, b, alpha=alpha))


def lu_factor_block(a):
    if _meta(a):
        return _dry("lu_factor_block", lu_flops(a.shape[0]), 2 * _nb(a),
                    torch.empty_like(a))
    if _on_card(a):
        return _lu.lu_factor_block(a)
    return ref.lu_factor_block(a)


def trsm_lower_left(lu, b, *, bn=256):
    if _meta(b):
        return _dry("trsm_lower_left", b.numel() * (lu.shape[0] - 1),
                    _nb(lu) + 2 * _nb(b), torch.empty_like(b))
    if _on_card(b):
        return _lu.trsm_lower_left(lu, b)
    return ref.trsm_lower_left(lu, b)


def trsm_upper_right(lu, b, *, bm=256):
    if _meta(b):
        return _dry("trsm_upper_right", b.numel() * lu.shape[0],
                    _nb(lu) + 2 * _nb(b), torch.empty_like(b))
    if _on_card(b):
        return _lu.trsm_upper_right(lu, b, bm=bm)
    return ref.trsm_upper_right(lu, b)


def matmul(a, b, *, bm=256, bn=256, bk=256, out_dtype=None):
    if _meta(a):
        out = torch.empty((a.shape[0], b.shape[1]),
                          dtype=out_dtype or a.dtype, device=a.device)
        return _dry("matmul", 2 * out.numel() * a.shape[1], _nb(a, b, out),
                    out)
    if _on_card(a):
        return _gemm.matmul(a, b, out_dtype=out_dtype)
    return ref.matmul(a, b, out_dtype=out_dtype)


def transpose_add(a, b, *, block=256):
    if _meta(b):
        return _dry("transpose_add", b.numel(), 3 * _nb(b),
                    torch.empty_like(b))
    if _on_card(b):
        return _transpose.transpose_add(a, b)
    return ref.transpose_add(a, b)


def stream_copy(a):
    if _meta(a):
        return _dry("stream_copy", 0, 2 * _nb(a), torch.empty_like(a))
    if _on_card(a):
        return _stream.stream_copy(a)
    _stream.check_size(a)
    return ref.stream_copy(a)


def stream_scale(c, alpha):
    if _meta(c):
        return _dry("stream_scale", c.numel(), 2 * _nb(c),
                    torch.empty_like(c))
    if _on_card(c):
        return _stream.stream_scale(c, alpha)
    _stream.check_size(c)
    return ref.stream_scale(c, alpha)


def stream_add(a, b):
    if _meta(a):
        return _dry("stream_add", a.numel(), 3 * _nb(a),
                    torch.empty_like(a))
    if _on_card(a):
        return _stream.stream_add(a, b)
    _stream.check_size(a)
    return ref.stream_add(a, b)


def stream_triad(b, c, alpha):
    if _meta(b):
        return _dry("stream_triad", 2 * b.numel(), 3 * _nb(b),
                    torch.empty_like(b))
    if _on_card(b):
        return _stream.stream_triad(b, c, alpha)
    _stream.check_size(b)
    return ref.stream_triad(b, c, alpha)


def flash_attention(q, k, v, *, causal=True, q_offset=0, bq=512, bk=512):
    _, Sq, _, _, Skv, _ = _attention.check_shapes(q, k, v, q_offset=q_offset)
    ref.fit_blocks(Sq, Skv, bq, bk)
    if _meta(q):
        B, _, H, hd = q.shape
        return _dry("flash_attention",
                    4 * B * H * hd * flash_pairs(Sq, Skv, causal, q_offset),
                    2 * _nb(q) + _nb(k, v), torch.empty_like(q))
    if _on_card(q):
        return _attention.flash_attention(q, k, v, causal=causal,
                                          q_offset=q_offset)
    return ref.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                               bq=bq, bk=bk)


def ring_add_step(acc, recv, *, out=None):
    _ring.check_operands(acc, recv, out)
    if _meta(acc):
        return dry_ring_add_step(acc, out)
    if _on_card(acc):
        return _ring.ring_add_step(acc, recv, out=out)
    res = ref.ring_add_step(acc, recv)
    return res if out is None else out.copy_(res)


def dry_ring_add_step(acc, out=None):
    """``ring_add_step``'s meta path, for a chunk of any shape (the card
    route of ``kernels/ring.py::fused_chunk_add``)."""
    return _dry("ring_add_step", acc.numel(), 3 * _nb(acc),
                torch.empty_like(acc) if out is None else out)


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
