"""``gemm_update`` (C <- C + alpha * A @ B, in place on C) and ``matmul``
(C = A @ B) on the card.

Port of ``repro/kernels/gemm.py`` (``fit_block`` ``:24``, ``matmul``
``:45``, ``gemm_update`` ``:82-111``). ``gemm_update`` is
``csrc/gemm_update.cu``: it replaces the TPU kernel
``repro/kernels/gemm.py:gemm_update``, and the dtype alone picks its route:

- ``simt_f32`` (fp32, HPL's path): bounded on an H100 by device memory at
  HPL's shapes (K = 64: C in and out once), with the fp32 FMA bound close
  behind. Its design streams C into shared memory while the FMAs run, one
  CTA per tile and two to an SM; the tile shape and the grid are chosen
  here, per shape, by :func:`gemm_geometry`. Each output sums its products
  in ascending k, one fused multiply-add each, from 0.
- ``wgmma_bf16`` (bf16): bounded by bytes alone (0.322 ms for C 16384^2;
  its products take 0.035 ms on the bf16 tensor cores). Persistent CTAs,
  one per SM (:func:`gemm_geometry_bf16`), walk the 128 x 128 tiles of C:
  a producer warp keeps TMA loads of C, A and B in flight, two consumer
  warpgroups sum on the tensor cores (wgmma, fp32 sums of exact products)
  and write ``bf16(fmaf(alpha, sum, c))`` back by TMA store, one tile's
  epilogue overlapping the next tiles' loads. Each output sums in the
  tensor core's order within each 16-deep step of K, the steps in
  ascending order, whatever the tile's position, so a strip updated alone
  keeps the full update's bits. TMA moves every operand, so a call whose
  operands it cannot address raises ``ValueError`` naming the rule
  (:func:`check_tma`) before any launch; it never goes to the other route
  or to the plain version.

``matmul`` is ``csrc/matmul.cu``: it replaces ``repro/kernels/gemm.py:matmul``
and is bounded by fp32 operations (2 * 8192^3 FLOP at the GEMM phase's
shape, 16.4 ms at 67 TFLOP/s; TF32 tensor cores would round the operands).
Its design answers with a main loop of its own: a 3-stage ``cp.async``
ring of 32-deep K slices that overlaps the global loads with the FMAs, and
128 x 256 block tiles of 8 x 16 sums per thread fed by float4 shared reads
with double-buffered register fragments, so that shared-memory loads stay
below the FMA rate. It keeps the fp32 route's order of sums, so
``matmul(a, b)`` equals ``gemm_update(0, a, b, alpha=1)`` in fp32 bit for
bit. The notes in the sources say more. Their plain versions are
:func:`repro_torch.kernels.ref.gemm_update` and ``ref.matmul``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int64,
             ctypes.c_void_p]
_ENTRY = {torch.float32: "repro_gemm_update_f32",
          torch.bfloat16: "repro_gemm_update_bf16"}
ROUTES = {torch.float32: "simt_f32", torch.bfloat16: "wgmma_bf16"}
TMA_ALIGN = 16  # bytes: TMA's rule for an address, a row stride, a width
_MATMUL_ARGTYPES = _ARGTYPES[:9] + [ctypes.c_void_p]
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MATMUL_ENTRY = {(ti, to): f"repro_matmul_{si}_{so}"
                 for ti, si in _SUFFIX.items() for to, so in _SUFFIX.items()}
# gemm_update's tile shapes, rows x columns of C per CTA of four warps, in
# the order of the C entry points' ``tile`` (csrc/gemm_update.cu: launch):
# 8 x 16 sums a thread, then two of 8 x 8 for strips and small matrices
TILES = ((128, 128), (64, 128), (128, 64))
# the bf16 route's one tile shape (csrc/gemm_update.cu: tc::BM, tc::BN)
TILE_BF16 = (128, 128)


def gemm_geometry(M: int, N: int, sms: int) -> tuple:
    """``(tile, ctas)`` for an update of an (M, N) C on a card of ``sms``
    SMs: the index in :data:`TILES` of the tile shape, and the grid, one
    CTA per tile.

    A row strip of at most 64 rows takes 64 x 128 tiles and a column strip
    of at most 64 columns 128 x 64 (HPL's lookahead launches both, 64 x m
    and m x 64), so that no tile leaves half its lanes idle; so does a C
    with fewer 128 x 128 tiles than the card has SMs, which then spreads
    over twice as many CTAs, each with half the chain of multiply-adds a
    thread. Every other C takes 128 x 128. The order of sums per output
    does not depend on the tile, so every choice keeps the bits."""
    if M <= 0 or N <= 0 or sms <= 0:
        raise ValueError(f"no geometry for C ({M}, {N}) on {sms} SMs")
    if M <= 64:
        tile = 1
    elif N <= 64 or -(-M // 128) * -(-N // 128) < sms:
        tile = 2
    else:
        tile = 0
    bm, bn = TILES[tile]
    return tile, -(-M // bm) * -(-N // bn)


def gemm_geometry_bf16(M: int, N: int, sms: int) -> tuple:
    """``(0, ctas)`` for a bf16 update of an (M, N) C on a card of ``sms``
    SMs: the one tile shape :data:`TILE_BF16`, and one persistent CTA per
    SM, or per tile where C has fewer tiles. CTA x takes tiles x, x +
    ctas, ... in row-major order over the tile grid. Every shape, strips
    included, runs the same instruction on the same slices of K, so its
    bits do not depend on the choice."""
    if M <= 0 or N <= 0 or sms <= 0:
        raise ValueError(f"no geometry for C ({M}, {N}) on {sms} SMs")
    bm, bn = TILE_BF16
    return 0, min(-(-M // bm) * -(-N // bn), sms)


def fit_block(size: int, pref: int) -> int:
    """Largest divisor of ``size`` that is <= pref (block shapes must tile)."""
    b = min(pref, size)
    while size % b:
        b -= 1
    return b


def row_stride(t: torch.Tensor, name: str) -> int:
    """The leading dimension of a row-major 2-D view (unit column stride);
    raises for any other layout, which the caller must copy first."""
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name} needs unit column stride, got strides "
                         f"{t.stride()}; pass a contiguous copy")
    return max(t.stride(0), t.shape[1], 1)


def check_tma(name: str, t: torch.Tensor, ld: int) -> None:
    """Raise unless TMA can address the row-major 2-D ``t`` of row stride
    ``ld``: a 16-byte aligned address, and a row stride and a width in
    bytes that are multiples of 16 (at a ragged right edge TMA's stores
    write the whole 16-byte run, past the matrix). An operand with no
    element is never moved and passes."""
    if t.numel() == 0:
        return
    size = t.element_size()
    rule = f"gemm_update's bf16 kernel moves {name} by TMA, which needs"
    if t.data_ptr() % TMA_ALIGN:
        raise ValueError(f"{rule} a {TMA_ALIGN}-byte aligned address; got "
                         f"{name}.data_ptr() % {TMA_ALIGN} = "
                         f"{t.data_ptr() % TMA_ALIGN}")
    if ld * size % TMA_ALIGN:
        raise ValueError(f"{rule} its row stride to be a multiple of "
                         f"{TMA_ALIGN} bytes; got {ld} elements ({ld * size} "
                         "bytes)")
    if t.shape[1] * size % TMA_ALIGN:
        raise ValueError(f"{rule} its width to be a multiple of {TMA_ALIGN} "
                         f"bytes; got {t.shape[1]} columns "
                         f"({t.shape[1] * size} bytes)")


def check_cuda(*named) -> None:
    dev = named[0][1].device
    for name, t in named:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must lie on the CUDA device {dev}, "
                             f"got {t.device}")


def _chain(a: torch.Tensor, b: torch.Tensor):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"shapes a{tuple(a.shape)} b{tuple(b.shape)} do "
                         "not chain")
    return a.shape[0], a.shape[1], b.shape[1]


def gemm_update(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                alpha: float = -1.0) -> torch.Tensor:
    """Launch the kernel of c's dtype: ``c += alpha * a @ b`` in place;
    returns ``c``.

    ``a`` (M, K), ``b`` (K, N) and ``c`` (M, N) are fp32 or bf16 CUDA
    tensors of one dtype, each row-major with any row stride (bf16: as TMA
    allows, see :func:`check_tma`). Launches are counted in ``launches``
    and, by route, in ``launches_by_route``: ``simt_f32`` (fp32) and
    ``wgmma_bf16`` (bf16)."""
    check_cuda(("c", c), ("a", a), ("b", b))
    M, K, N = _chain(a, b)
    if tuple(c.shape) != (M, N):
        raise ValueError(f"shapes c{tuple(c.shape)} a{tuple(a.shape)} "
                         f"b{tuple(b.shape)} do not chain")
    if not (c.dtype == a.dtype == b.dtype) or c.dtype not in _ENTRY:
        raise TypeError(f"gemm_update takes one dtype of {list(_ENTRY)}, got "
                        f"{c.dtype}, {a.dtype}, {b.dtype}")
    lda, ldb, ldc = row_stride(a, "a"), row_stride(b, "b"), row_stride(c, "c")
    route = ROUTES[c.dtype]
    if route == "wgmma_bf16":
        for name, t, ld in (("c", c, ldc), ("a", a, lda), ("b", b, ldb)):
            check_tma(name, t, ld)
    if M == 0 or N == 0:  # nothing to update: no launch
        return c
    sms = torch.cuda.get_device_properties(c.device).multi_processor_count
    tile, ctas = (gemm_geometry_bf16 if route == "wgmma_bf16"
                  else gemm_geometry)(M, N, sms)
    fn = getattr(_build.load("gemm_update"), _ENTRY[c.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    _build.check(fn(a.data_ptr(), lda, b.data_ptr(), ldb, c.data_ptr(), ldc,
                    M, N, K, float(alpha), tile, ctas,
                    torch.cuda.current_stream(c.device).cuda_stream),
                 "gemm_update")
    gemm_update.launches += 1
    gemm_update.launches_by_route[route] += 1
    return c


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           out_dtype=None) -> torch.Tensor:
    """Launch the kernel: a new contiguous C (M, N) = A @ B, fp32 sums cast
    to ``out_dtype`` (default ``a``'s dtype).

    ``a`` (M, K) and ``b`` (K, N) are fp32 or bf16 CUDA tensors of one
    dtype, each row-major with any row stride; any M, N and K."""
    check_cuda(("a", a), ("b", b))
    M, K, N = _chain(a, b)
    out_dtype = out_dtype or a.dtype
    if a.dtype != b.dtype or (a.dtype, out_dtype) not in _MATMUL_ENTRY:
        raise TypeError(f"matmul takes inputs of one dtype of "
                        f"{list(_SUFFIX)} and such an out_dtype, got "
                        f"{a.dtype}, {b.dtype} -> {out_dtype}")
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    fn = getattr(_build.load("matmul"), _MATMUL_ENTRY[a.dtype, out_dtype])
    fn.argtypes, fn.restype = _MATMUL_ARGTYPES, ctypes.c_int
    _build.check(fn(a.data_ptr(), row_stride(a, "a"), b.data_ptr(),
                    row_stride(b, "b"), out.data_ptr(), max(N, 1), M, N, K,
                    torch.cuda.current_stream(a.device).cuda_stream),
                 "matmul")
    matmul.launches += 1
    return out


gemm_update.launches = 0
gemm_update.launches_by_route = dict.fromkeys(ROUTES.values(), 0)
matmul.launches = 0
