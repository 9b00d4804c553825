"""HPL's diagonal-block LU and panel solves on the card.

Port of ``repro/kernels/lu.py``. The kernels are in ``csrc/lu.cu``. Each is
bound by latency on an H100, not by bytes or FLOPs: a chain of b dependent
steps (b = 64 at HPL). For each:

- ``lu_factor_block`` replaces the TPU kernel
  ``repro/kernels/lu.py:lu_factor_block`` (``_lu_block_kernel``). Route
  ``warp_regs`` (n <= 64, all of HPL's calls): one warp keeps the block,
  padded to 64 x 64 with an identity block, in registers and runs the 64
  steps with shuffles and no CTA barrier, each lane dividing its own rows
  (the rows shift left a position a step, so the steps loop with constant
  register indices). Route ``cta_smem`` (64 < n <= 128): one CTA, the block in
  shared memory, two barriers a step (the kernel of the first port).
- ``trsm_lower_left`` replaces ``:trsm_lower_left``
  (``_trsm_lower_kernel``), HPL's Top panel. One column per thread in
  registers, padded to 64 rows (route ``regs64``) or 128 (``regs128``),
  solved right-looking with 63 - k independent FMAs per step; every load
  of the column is issued before the first FMA; 128 columns per CTA, so
  HPL's 16384 columns make 128 CTAs, one per SM, the last CTA masked
  where 128 does not divide N.
- ``trsm_upper_right`` replaces ``:trsm_upper_right``
  (``_trsm_upper_kernel``), HPL's Left panel, the lower solve's mirror
  image: one row per thread in registers, padded to 64 columns (route
  ``regs64``) or 128 (``regs128``), solved right-looking, each step's
  quotient an IEEE division (a zero dividend's signed zero without ``/``,
  whose slow path it would take); each thread loads its own row of the
  strided panel, every load in flight at once; 128 rows per CTA, so HPL's
  16384 rows make 128 CTAs, the last CTA masked where 128 does not divide
  M.

Each element sees the same operations in the same order on every route, so
the routes agree bit for bit. Their plain versions are in
:mod:`repro_torch.kernels.ref`.

All three take fp32 CUDA tensors. The block size ``n`` is at most
:data:`MAX_BLOCK`. The wrappers count their launches, and their launches by
route (``launches_by_route``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemm import check_cuda, row_stride

MAX_BLOCK = 128   # the largest block any route takes
# route -> the largest block it takes; the order is the order of choice
LU_ROUTES = {"warp_regs": 64, "cta_smem": 128}
TRSM_LOWER_ROUTES = {"regs64": 64, "regs128": 128}  # route -> padded rows
TRSM_LOWER_COLS = 128  # columns per CTA (csrc/lu.cu: TRSM_COLS)
TRSM_UPPER_ROUTES = {"regs64": 64, "regs128": 128}  # route -> padded columns
TRSM_UPPER_ROWS = 128  # rows per CTA (csrc/lu.cu: UPPER_ROWS)

_VP, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _entry(name: str, argtypes):
    fn = getattr(_build.load("lu"), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_size(n: int) -> None:
    if n > MAX_BLOCK:
        raise ValueError(f"block size {n} > {MAX_BLOCK}: no route takes it "
                         "(ROADMAP B2)")


def _route(routes, n: int) -> str:
    _check_size(n)
    return next(r for r, most in routes.items() if n <= most)


def lu_route(n: int) -> str:
    """The route ``lu_factor_block`` takes for an (n, n) block."""
    return _route(LU_ROUTES, n)


def trsm_lower_route(n: int) -> str:
    """The route ``trsm_lower_left`` takes for an (n, n) block."""
    return _route(TRSM_LOWER_ROUTES, n)


def trsm_lower_geometry(N: int):
    """(CTAs, columns per CTA) of ``trsm_lower_left`` on an (n, N) panel:
    enough CTAs of :data:`TRSM_LOWER_COLS` columns to cover N, the last one
    masked where they do not divide it."""
    return -(-N // TRSM_LOWER_COLS), TRSM_LOWER_COLS


def trsm_upper_route(n: int) -> str:
    """The route ``trsm_upper_right`` takes for an (n, n) block."""
    return _route(TRSM_UPPER_ROUTES, n)


def trsm_upper_geometry(M: int):
    """(CTAs, rows per CTA) of ``trsm_upper_right`` on an (M, n) panel:
    enough CTAs of :data:`TRSM_UPPER_ROWS` rows to cover M, the last one
    masked where they do not divide it."""
    return -(-M // TRSM_UPPER_ROWS), TRSM_UPPER_ROWS


def _check_block(lu: torch.Tensor, name: str) -> int:
    n = lu.shape[0]
    if lu.dim() != 2 or lu.shape[1] != n:
        raise ValueError(f"{name} must be square, got {tuple(lu.shape)}")
    _check_size(n)
    if lu.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {lu.dtype}")
    return n


def lu_factor_block(a: torch.Tensor) -> torch.Tensor:
    """Launch the kernel of :func:`lu_route`'s route: packed L\\U (unit
    lower diagonal) of the (n, n) block ``a``, unpivoted, as a new
    contiguous tensor."""
    check_cuda(("a", a))
    n = _check_block(a, "a")
    route = lu_route(n)
    out = torch.empty((n, n), dtype=torch.float32, device=a.device)
    if n == 0:
        return out
    fn = _entry("repro_lu_factor_block_f32", [_VP, _I64, _VP, _INT, _INT, _VP])
    _build.check(fn(a.data_ptr(), row_stride(a, "a"), out.data_ptr(), n,
                    list(LU_ROUTES).index(route), _stream(a)),
                 "lu_factor_block")
    lu_factor_block.launches += 1
    lu_factor_block.launches_by_route[route] += 1
    return out


def trsm_lower_left(lu: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel of :func:`trsm_lower_route`'s route: X = L^{-1} B
    for packed ``lu`` (n, n) and panel ``b`` (n, N), any N, in
    :func:`trsm_lower_geometry`'s CTAs."""
    check_cuda(("lu", lu), ("b", b))
    n = _check_block(lu, "lu")
    if b.dim() != 2 or b.shape[0] != n or b.dtype != torch.float32:
        raise ValueError(f"b must be float32 ({n}, N), got "
                         f"{b.dtype} {tuple(b.shape)}")
    route = trsm_lower_route(n)
    N = b.shape[1]
    out = torch.empty((n, N), dtype=torch.float32, device=b.device)
    if n == 0 or N == 0:
        return out
    fn = _entry("repro_trsm_lower_left_f32",
                [_VP, _I64, _VP, _I64, _VP, _INT, _INT, _INT, _INT, _VP])
    _build.check(fn(lu.data_ptr(), row_stride(lu, "lu"), b.data_ptr(),
                    row_stride(b, "b"), out.data_ptr(), n, N,
                    TRSM_LOWER_ROUTES[route], trsm_lower_geometry(N)[0],
                    _stream(b)), "trsm_lower_left")
    trsm_lower_left.launches += 1
    trsm_lower_left.launches_by_route[route] += 1
    return out


def trsm_upper_right(lu: torch.Tensor, b: torch.Tensor, *,
                     bm: int = 256) -> torch.Tensor:
    """Launch the kernel of :func:`trsm_upper_route`'s route: X = B U^{-1}
    for packed ``lu`` (n, n) and panel ``b`` (M, n), any M, in
    :func:`trsm_upper_geometry`'s CTAs. ``bm``, the reference's row block,
    is accepted and ignored: the kernel's CTA height is fixed and its last
    CTA masked."""
    check_cuda(("lu", lu), ("b", b))
    n = _check_block(lu, "lu")
    if b.dim() != 2 or b.shape[1] != n or b.dtype != torch.float32:
        raise ValueError(f"b must be float32 (M, {n}), got "
                         f"{b.dtype} {tuple(b.shape)}")
    route = trsm_upper_route(n)
    M = b.shape[0]
    out = torch.empty((M, n), dtype=torch.float32, device=b.device)
    if n == 0 or M == 0:
        return out
    fn = _entry("repro_trsm_upper_right_f32",
                [_VP, _I64, _VP, _I64, _VP, _INT, _INT, _INT, _INT, _VP])
    _build.check(fn(lu.data_ptr(), row_stride(lu, "lu"), b.data_ptr(),
                    row_stride(b, "b"), out.data_ptr(), n, M,
                    TRSM_UPPER_ROUTES[route], trsm_upper_geometry(M)[0],
                    _stream(b)), "trsm_upper_right")
    trsm_upper_right.launches += 1
    trsm_upper_right.launches_by_route[route] += 1
    return out


lu_factor_block.launches = 0
lu_factor_block.launches_by_route = dict.fromkeys(LU_ROUTES, 0)
trsm_lower_left.launches = 0
trsm_lower_left.launches_by_route = dict.fromkeys(TRSM_LOWER_ROUTES, 0)
trsm_upper_right.launches = 0
trsm_upper_right.launches_by_route = dict.fromkeys(TRSM_UPPER_ROUTES, 0)
