"""``gemm_update``'s launch geometry and output-bit pins, checked on the CPU.

The kernel in ``csrc/gemm_update.cu`` takes its tile shape and its grid
from the host: :func:`repro_torch.kernels.gemm.gemm_geometry`, plain
Python, picks one of :data:`~repro_torch.kernels.gemm.TILES` per shape and
one CTA per tile. Here the geometry is held to the kernel's mapping (CTA x
takes tile x, row-major over the tile grid: every output tile exactly
once), the wrapper is followed to the C call with the library replaced by
a recorder,
and ``chip_smoke.py``'s golden calls, whose output bits ``GEMM_BITS`` pins
on the card, are run through the plain version at a reduced size. The
kernel itself runs in ``chip_smoke.py`` phase ``kernels``.
"""
from __future__ import annotations

import ctypes
import importlib
import re
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import gemm as kgemm

REPO = Path(__file__).resolve().parents[1]
SMS = 132  # an H100 SXM
SIZES = (1, 37, 64, 127, 128, 129, 16384)
HPL_STRIPS = {"row strip": (64, 16384), "column strip": (16384, 64)}
TRAILING = (12288, 8192, 4096, 1024)  # views of a 16384^2 matrix


def _chip_smoke():
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    return importlib.import_module("chip_smoke")


def _walk(M, N, tile, ctas):
    """The output tiles, as (row0, col0), that the kernel's CTAs take: CTA
    x takes tile x, row-major over the tile grid (csrc/gemm_update.cu)."""
    bm, bn = kgemm.TILES[tile]
    tiles_n = -(-N // bn)
    return [((x // tiles_n) * bm, (x % tiles_n) * bn) for x in range(ctas)]


def _covers_once(M, N, tile, ctas):
    """Every output element lies in exactly one visited tile, and every
    visited tile holds at least one output element."""
    bm, bn = kgemm.TILES[tile]
    seen = np.zeros((M, N), np.int32)
    origins = _walk(M, N, tile, ctas)
    for r0, c0 in origins:
        if r0 >= M or c0 >= N:
            return False
        seen[r0:r0 + bm, c0:c0 + bn] += 1
    return len(set(origins)) == len(origins) and bool((seen == 1).all())


@pytest.mark.parametrize("n", SIZES[:-1])
@pytest.mark.parametrize("m", SIZES[:-1])
def test_gemm_geometry_visits_every_tile_once(m, n):
    tile, ctas = kgemm.gemm_geometry(m, n, SMS)
    bm, bn = kgemm.TILES[tile]
    assert 0 < ctas == -(-m // bm) * -(-n // bn)
    assert _covers_once(m, n, tile, ctas)


@pytest.mark.parametrize("size", SIZES)
def test_gemm_geometry_square(size):
    tile, ctas = kgemm.gemm_geometry(size, size, SMS)
    # strips of at most 64 rows and C of fewer 128^2 tiles than SMs take
    # the 8 x 8 tiles
    assert tile == (1 if size <= 64 else 2 if size <= 1408 else 0)
    bm, bn = kgemm.TILES[tile]
    ntiles = -(-size // bm) * -(-size // bn)
    assert 0 < ctas <= ntiles
    assert len(_walk(size, size, tile, ctas)) == ntiles
    if size == 16384:  # HPL's update: 128 x 128 tiles, one CTA each
        assert (kgemm.TILES[tile], ctas) == ((128, 128), 16384)


@pytest.mark.parametrize("label", HPL_STRIPS)
def test_gemm_geometry_hpl_strips_fill_their_tiles(label):
    """HPL's lookahead strips take the tile whose short side is 64, so no
    tile row or column lies past the strip, and spread over 128 CTAs."""
    M, N = HPL_STRIPS[label]
    tile, ctas = kgemm.gemm_geometry(M, N, SMS)
    bm, bn = kgemm.TILES[tile]
    assert min(bm, bn) == 64 and M % bm == 0 and N % bn == 0
    assert ctas == M * N // (bm * bn) == 128
    assert _covers_once(M, N, tile, ctas)


@pytest.mark.parametrize("t", TRAILING)
def test_gemm_geometry_trailing_shapes(t):
    """Trailing views take 128 x 128 tiles, but for 1024^2 (64 of them on
    132 SMs), which takes twice as many 128 x 64 ones."""
    tile, ctas = kgemm.gemm_geometry(t, t, SMS)
    if t == 1024:
        assert kgemm.TILES[tile] == (128, 64) and ctas == 128
    else:
        assert kgemm.TILES[tile] == (128, 128) and ctas == (t // 128) ** 2
    assert _covers_once(t, t, tile, ctas)


@pytest.mark.parametrize("sms", [1, 64, 132, 264])
def test_gemm_geometry_spreads_small_c_over_the_sms(sms):
    """A C with fewer 128 x 128 tiles than SMs takes 128 x 64 tiles."""
    tile, ctas = kgemm.gemm_geometry(1024, 1024, sms)
    assert kgemm.TILES[tile] == ((128, 64) if 64 < sms else (128, 128))
    assert _covers_once(1024, 1024, tile, ctas)


@pytest.mark.parametrize("tile", range(len(kgemm.TILES)))
@pytest.mark.parametrize("shape", [(1000, 777), (64, 16384), (16384, 64)])
def test_every_tile_shape_covers_any_c(tile, shape):
    """Each tile shape, with one CTA per tile, covers any C exactly once,
    ragged edges included, so the host may pick any of them."""
    M, N = shape
    bm, bn = kgemm.TILES[tile]
    assert _covers_once(M, N, tile, -(-M // bm) * -(-N // bn))


@pytest.mark.parametrize("shape", [(0, 16384), (16384, 0), (0, 0)])
def test_gemm_geometry_refuses_an_empty_grid(shape):
    with pytest.raises(ValueError, match="no geometry"):
        kgemm.gemm_geometry(*shape, SMS)


def _walk_bf16(M, N, ctas):
    """The tiles, as (row0, col0), that the bf16 kernel's persistent CTAs
    take: CTA x takes tiles x, x + ctas, ..., row-major over the tile grid
    (csrc/gemm_update.cu: gemm_update_bf16_kernel)."""
    bm, bn = kgemm.TILE_BF16
    tiles_n, tiles = -(-N // bn), -(-M // bm) * -(-N // bn)
    return [(w // tiles_n * bm, w % tiles_n * bn)
            for x in range(ctas) for w in range(x, tiles, ctas)]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("m", SIZES)
def test_gemm_geometry_bf16_visits_every_tile_once(m, n):
    """One persistent CTA per SM, or per tile where C has fewer; the walk
    takes every tile of C exactly once, and no tile past it."""
    tile, ctas = kgemm.gemm_geometry_bf16(m, n, SMS)
    bm, bn = kgemm.TILE_BF16
    tiles = -(-m // bm) * -(-n // bn)
    assert tile == 0 and 0 < ctas == min(tiles, SMS)
    origins = _walk_bf16(m, n, ctas)
    assert len(origins) == len(set(origins)) == tiles
    assert set(origins) == {(r, c) for r in range(0, m, bm)
                            for c in range(0, n, bn)}


@pytest.mark.parametrize("label", HPL_STRIPS)
def test_gemm_geometry_bf16_strips_keep_the_full_updates_tiles(label):
    """HPL's strips run on the full update's tile: a strip's 64 rows
    (columns) fill one consumer warpgroup's half (one 64-column block) of
    a tile, so each output meets the same m64n128k16 steps on the same
    slices of K as in the full update, and the strip spreads over 128
    CTAs."""
    M, N = HPL_STRIPS[label]
    tile, ctas = kgemm.gemm_geometry_bf16(M, N, SMS)
    assert tile == kgemm.gemm_geometry_bf16(16384, 16384, SMS)[0] == 0
    assert M % 64 == 0 and N % 64 == 0 and ctas == 128
    assert len(_walk_bf16(M, N, ctas)) == M * N // (64 * 16384) * 128


@pytest.mark.parametrize("sms", [1, 64, 132, 264])
@pytest.mark.parametrize("size", [1024, 16384])
def test_gemm_geometry_bf16_takes_one_cta_per_sm(sms, size):
    tile, ctas = kgemm.gemm_geometry_bf16(size, size, sms)
    assert ctas == min((size // 128) ** 2, sms)


@pytest.mark.parametrize("shape", [(0, 16384), (16384, 0), (0, 0)])
def test_gemm_geometry_bf16_refuses_an_empty_grid(shape):
    with pytest.raises(ValueError, match="no geometry"):
        kgemm.gemm_geometry_bf16(*shape, SMS)


# ---------------------------------------------------------------------------
# the wrapper, followed to the C call
# ---------------------------------------------------------------------------


class _CudaTyped(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to follow a wrapper without
    a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class _Fn:
    """A C entry point that records its arguments."""

    def __init__(self, name, calls, result=0):
        self.name, self.calls, self.result = name, calls, result

    def __call__(self, *args):
        self.calls.append((self.name, args))
        return self.result


@pytest.fixture
def recorder(monkeypatch):
    """The gemm library, the card's stream and its SM count, replaced."""
    calls = []
    lib = SimpleNamespace(**{name: _Fn(name, calls)
                             for name in kgemm._ENTRY.values()})
    monkeypatch.setattr(kgemm._build, "load", lambda stem: lib)
    monkeypatch.setattr(kgemm.torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(kgemm.torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(multi_processor_count=SMS))
    ops.reset_launch_counts()
    yield calls
    ops.reset_launch_counts()


def _cuda(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype).as_subclass(_CudaTyped)


@pytest.mark.parametrize("case", ["hpl", "row strip", "column strip",
                                  "trailing 4096", "bf16 ragged"])
def test_gemm_wrapper_launches_its_geometry(recorder, case):
    n = 1024  # the shapes' layout at a size the CPU holds without cost
    full, l, u = _cuda(n, n), _cuda(n, 64), _cuda(64, n)
    c, a, b = {
        "hpl": (full, l, u),
        "row strip": (_cuda(64, n), l[64:128], u),
        "column strip": (_cuda(n, 64), l, u[:, 64:128]),
        "trailing 4096": (full[n // 4:, n // 4:], l[n // 4:], u[:, n // 4:]),
        # ragged M, N and K on the bf16 route, whose operands TMA must
        # address: row strides and widths in whole 16-byte runs
        "bf16 ragged": (_cuda(300, 512, dtype=torch.bfloat16)[:, 64:392],
                        _cuda(300, 48, dtype=torch.bfloat16)[:, :40],
                        _cuda(40, 328, dtype=torch.bfloat16))}[case]
    assert kgemm.gemm_update(c, a, b) is c
    (name, args), = recorder
    M, K, N = a.shape[0], a.shape[1], b.shape[1]
    assert name == kgemm._ENTRY[c.dtype]
    assert args[1::2][:3] == (a.stride(0), b.stride(0), c.stride(0))
    assert args[6:10] == (M, N, K, -1.0)
    geometry = (kgemm.gemm_geometry_bf16 if c.dtype == torch.bfloat16
                else kgemm.gemm_geometry)
    assert args[10:12] == geometry(M, N, SMS)
    assert ops.launch_counts()["gemm_update"] == 1
    route = kgemm.ROUTES[c.dtype]
    assert ops.launches_by_route()["gemm_update"] == {
        r: int(r == route) for r in ("simt_f32", "wgmma_bf16")}


@pytest.mark.parametrize("shape", [(0, 64, 64), (64, 64, 0)])
def test_gemm_wrapper_launches_nothing_for_an_empty_c(recorder, shape):
    M, K, N = shape
    c = _cuda(M, N)
    assert kgemm.gemm_update(c, _cuda(M, K), _cuda(K, N)) is c
    assert recorder == [] and ops.launch_counts()["gemm_update"] == 0


def test_gemm_wrapper_raises_on_a_refused_launch(recorder):
    lib = kgemm._build.load("gemm_update")
    lib.repro_gemm_update_f32.result = 1  # cudaErrorInvalidValue
    with pytest.raises(RuntimeError, match="gemm_update: CUDA error 1"):
        kgemm.gemm_update(_cuda(64, 64), _cuda(64, 64), _cuda(64, 64))
    assert ops.launch_counts()["gemm_update"] == 0


def test_gemm_entry_points_take_the_geometry():
    """The C symbols the wrapper binds take the tile and the grid after
    alpha, as ``_ARGTYPES`` passes them, and the source lists the tile
    shapes in :data:`TILES`' order."""
    src = (_build.CSRC / "gemm_update.cu").read_text()
    for name in kgemm._ENTRY.values():
        assert re.search(rf'extern "C" int {name}\([^)]*float alpha, int '
                         r'tile,\s*int64_t ctas,\s*void\* stream\)', src), name
    assert kgemm._ARGTYPES[9:12] == [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_int64]
    for tile, (bm, bn) in enumerate(kgemm.TILES):
        # launch_shape<WM, WN, GN>: WM x WN warps of 32 x 32 GN outputs
        wm, wn, gn = map(int, re.search(
            rf"case {tile}:\s*return launch_shape<(\d+), (\d+), (\d+)>",
            src).groups())
        assert (32 * wm, 32 * gn * wn, wm * wn) == (bm, bn, 4), (tile, bm, bn)
    # the bf16 kernel's one tile, as gemm_geometry_bf16 assumes it
    tc = src[src.index("namespace tc {"):]
    bm, bn = (int(re.search(rf"constexpr int {k} = (\d+);", tc).group(1))
              for k in ("BM", "BN"))
    assert (bm, bn) == kgemm.TILE_BF16


# ---------------------------------------------------------------------------
# GEMM_BITS: the golden calls, through the plain version
# ---------------------------------------------------------------------------


# what each golden call must pass: C's shape and row stride, K, alpha and
# dtype, with C (n, n) standing for HPL's 16384^2
GOLDEN = {"hpl16384": lambda n: ((n, n), n, 64, -1.0, torch.float32),
          "row_strip": lambda n: ((64, n), n, 64, -1.0, torch.float32),
          "col_strip": lambda n: ((n, 64), 64, 64, -1.0, torch.float32),
          "trailing8192": lambda n: ((n // 2, n // 2), n, 64, -1.0,
                                     torch.float32),
          "ragged37": lambda n: ((300, 333), 512, 37, 0.5, torch.float32),
          "bf16_16384": lambda n: ((n, n), n, 64, -1.0, torch.bfloat16)}


@pytest.fixture
def golden_on_cpu(monkeypatch):
    """``chip_smoke.gemm_golden_calls`` on the CPU at n = 256: ``.cuda()``
    keeps the tensor where it is, and the kernel's stand-in records each
    call and runs the plain version through ``ops``."""
    cs = _chip_smoke()
    n = 256
    monkeypatch.setattr(cs, "N_MAIN", n)
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self, *a, **k: self)
    seen = []

    def gemm_update(c, a, b, *, alpha=-1.0):
        seen.append((c.clone(), a, b, alpha))
        return ops.gemm_update(c, a, b, alpha=alpha)

    calls = cs.gemm_golden_calls(torch, SimpleNamespace(
        gemm_update=gemm_update))
    return cs, n, calls, seen


def test_gemm_golden_calls_match_gemm_bits(golden_on_cpu):
    cs, _, calls, _ = golden_on_cpu
    assert list(calls) == list(cs.GEMM_BITS) == list(GOLDEN)
    assert all(re.fullmatch(r"[0-9a-f]{16}", h)
               for h in cs.GEMM_BITS.values())


@pytest.mark.parametrize("label", GOLDEN)
def test_gemm_golden_call_through_the_plain_version(golden_on_cpu, label):
    cs, n, calls, seen = golden_on_cpu
    ops.reset_launch_counts()
    out = calls[label]()
    (c_before, a, b, alpha), = seen
    shape, ldc, k, want_alpha, dtype = GOLDEN[label](n)
    assert tuple(out.shape) == shape and out.dtype == dtype
    assert out.stride() == (ldc, 1) and a.shape[1] == b.shape[0] == k
    assert alpha == want_alpha
    want = ref.gemm_update(c_before, a, b, alpha=alpha)
    assert torch.equal(out, want) and torch.isfinite(out.float()).all()
    assert ops.launch_counts()["gemm_update"] == 0  # the plain route
    assert len(cs.bits_sha(out)) == 16
