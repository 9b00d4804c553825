"""Build and load the CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded through ``ctypes``. The build runs
at first use, from the sources in this checkout, into
``build/repro_torch_kernels/<hash>/`` at the root of the checkout; the hash
covers the sources and the flags, so an edited source builds anew. All
sources compile in parallel, one ``nvcc`` each. A failed build raises.
Fast math stays off: the LU's pivot division and the solves' divisions
must be IEEE.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def build() -> Dict[str, Path]:
    """Compile every source that has no library in :func:`build_dir` yet;
    return ``{stem: path of its .so}``. The compiler's report (registers,
    shared memory, spills) is kept beside each library as ``<stem>.log``."""
    out = build_dir()
    libs = {src.stem: out / f"{src.stem}.so" for src in sources()}
    todo = [src for src in sources() if not libs[src.stem].exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        tmp = out / f"{src.stem}.so.tmp{os.getpid()}"
        log = open(out / f"{src.stem}.log", "w")
        procs.append((src, tmp, log, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, libs[src.stem])
        else:
            failed.append(f"{src.name} (nvcc exit {rc}):\n"
                          + (out / f"{src.stem}.log").read_text()[-4000:])
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return libs


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first
    use)."""
    with _lock:
        if stem not in _libs:
            _libs[stem] = ctypes.CDLL(str(build()[stem]))
        return _libs[stem]


def check(err: int, what: str) -> None:
    """Raise for a non-zero ``cudaError_t`` returned by a C entry point."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
