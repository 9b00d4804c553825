"""STREAM's launch geometry, checked on the CPU.

The vector kernel in ``csrc/stream.cu`` takes its grid from the host:
:func:`repro_torch.kernels.stream.stream_geometry`, plain Python, gives one
CTA per tile of :data:`~repro_torch.kernels.stream.CTA_VECTORS` 16-byte
vectors, the last one masked. The C entry point refuses a grid that leaves
a vector uncovered or a CTA empty; here the function is held to the same
rule, and the wrapper is followed to the C call with the library replaced
by a recorder. The kernels themselves run in ``chip_smoke.py`` phase
``kernels``.
"""
from __future__ import annotations

import ctypes
import re
from types import SimpleNamespace

import pytest
import torch

from repro_torch.kernels import _build, ops
from repro_torch.kernels import stream as kstream

TILE = kstream.CTA_VECTORS


def _covers(nvec, tile, ctas):
    """The C entry point's rule: every vector covered, no CTA empty."""
    return ctas * tile >= nvec > (ctas - 1) * tile


@pytest.mark.parametrize("nvec,ctas", [
    (1 << 26, 262_144),  # 2^28 fp32: 262,144 full tiles
    (1 << 17, 512),      # 2^20 bf16
    (32, 1),             # 128 fp32, the smallest size: one partial tile
    (131_168, 513)])     # 128 x 4099 fp32: a partial last tile
def test_stream_geometry_is_one_cta_per_tile(nvec, ctas):
    assert TILE == 256
    assert kstream.stream_geometry(nvec, TILE) == ctas
    assert _covers(nvec, TILE, ctas)


@pytest.mark.parametrize("tile", [256, 1024, 2048])
@pytest.mark.parametrize("size", ["one", "tile-1", "tile", "tile+1",
                                  "many+3", "2^26+17"])
def test_stream_geometry_covers_every_size(tile, size):
    nvec = {"one": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
            "many+3": 5 * tile * 1056 + 3, "2^26+17": (1 << 26) + 17}[size]
    ctas = kstream.stream_geometry(nvec, tile)
    assert ctas == -(-nvec // tile) and _covers(nvec, tile, ctas)


@pytest.mark.parametrize("args", [(0, TILE), (32, 0)])
def test_stream_geometry_refuses_an_empty_grid(args):
    with pytest.raises(ValueError, match="no geometry"):
        kstream.stream_geometry(*args)


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
    """The stream library and the card's stream, replaced by recorders."""
    calls = []
    lib = SimpleNamespace(**{name: _Fn(name, calls) for name in (
        "repro_stream_f32", "repro_stream_bf16")})
    monkeypatch.setattr(kstream._build, "load", lambda stem: lib)
    monkeypatch.setattr(kstream.torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=0))
    ops.reset_launch_counts()
    yield calls
    ops.reset_launch_counts()


@pytest.mark.parametrize("op,dtype,n", [
    ("copy", torch.float32, 1 << 16), ("scale", torch.float32, 128 * 4099),
    ("add", torch.bfloat16, 1 << 16), ("triad", torch.bfloat16, 128)])
def test_stream_wrapper_launches_its_geometry(recorder, op, dtype, n):
    x = torch.zeros(n, dtype=dtype).as_subclass(_CudaTyped)
    y = torch.ones(n, dtype=dtype).as_subclass(_CudaTyped)
    wrapper = getattr(kstream, f"stream_{op}")
    args = {"copy": (x,), "scale": (x, 3.0), "add": (x, y),
            "triad": (x, y, 3.0)}[op]
    wrapper(*args)
    (name, launch), = recorder
    assert name == kstream._ENTRY[dtype]
    assert launch[0] == kstream._OPS[op] and launch[4] == n
    nvec = n * x.element_size() // 16
    assert launch[6] == kstream.stream_geometry(nvec, TILE) \
        == -(-nvec // TILE)
    assert ops.launch_counts()[f"stream_{op}"] == 1


def test_stream_wrapper_raises_on_a_refused_launch(recorder):
    lib = kstream._build.load("stream")
    lib.repro_stream_f32.result = 1  # cudaErrorInvalidValue
    x = torch.zeros(256).as_subclass(_CudaTyped)
    with pytest.raises(RuntimeError, match="stream_copy: CUDA error 1"):
        kstream.stream_copy(x)
    assert ops.launch_counts()["stream_copy"] == 0


def test_stream_geometry_entry_points_exist_in_the_source():
    """The C symbols the wrapper binds are defined, with C linkage, in
    ``csrc/stream.cu``, which takes the wrapper's grid, checks it, and
    holds as many vectors per CTA as the wrapper assumes."""
    src = (_build.CSRC / "stream.cu").read_text()
    for name in kstream._ENTRY.values():
        assert re.search(rf'extern "C" int {name}\([^)]*float alpha,\s*'
                         r'int64_t ctas, void\* stream\)', src), name
    assert f"constexpr int THREADS = {TILE};" in src
    assert len(kstream._ARGTYPES) == 8
    assert kstream._ARGTYPES[6] == ctypes.c_int64
