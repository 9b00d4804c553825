"""What the examples share: ``--device`` and ``--ranks``, and running a
body on one process or on a gloo world.

The reference's examples run on 8 placeholder devices: a ring of 8 and a
2x2 torus. Here ``--ranks 1`` (the default) runs one process on the card
(a ring of one and a 1x1 torus), and ``--ranks 4`` spawns four gloo
processes that share the card (a ring of 4 and a 2x2 torus); rank 0's
result is returned.
"""
from __future__ import annotations

import argparse
import math

import torch

# seconds a world of --ranks processes may take
TIMEOUT = 1800.0


def add_args(ap: argparse.ArgumentParser, ranks: int = 1) -> None:
    ap.add_argument("--device", default="cuda",
                    help="where to run (default: the card)")
    ap.add_argument("--ranks", type=int, default=ranks,
                    help="processes: 1, or 4 gloo processes sharing the "
                         "device (a ring of 4 and a 2x2 torus)")


def check_device(device: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to "
                         "run on the CPU")
    return device


def meshes():
    """(ring, torus) over this process's world: axis ``'x'`` over every
    rank, and the square torus ``('rows', 'cols')`` (1x1 on one
    process)."""
    from repro_torch.launch.mesh import (make_ring_mesh, make_torus_mesh,
                                         single_rank_mesh, world)

    _, size = world()
    if size == 1:
        return single_rank_mesh(("x",)), single_rank_mesh()
    return make_ring_mesh("x"), make_torus_mesh(math.isqrt(size))


def _entry(_ring, fn, device, args):
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
    return fn(device, *args)


def run(fn, ranks: int, device, *args):
    """``fn(device, *args)`` on this process (``ranks`` 1), or on every
    process of a gloo world of ``ranks`` (a square number); rank 0's
    result. ``fn`` must be a module-level function."""
    if ranks == 1:
        return fn(str(device), *args)
    if math.isqrt(ranks) ** 2 != ranks:
        raise SystemExit(f"--ranks {ranks}: the torus needs a square number "
                         "of processes")
    from repro_torch.launch.mesh import spawn_mesh

    return spawn_mesh(ranks, _entry, fn, str(device), args, axes=("x",),
                      timeout=TIMEOUT)[0]


# each benchmark's own gate on its ``error`` (tests/test_hpl_single.py,
# the STREAM / RandomAccess / b_eff exactness, FFT < 1e-5, GEMM within
# 16 fp32 eps of torch.matmul on N(0, 1/m) inputs: chip_smoke phase gemm)
GATES = {"b_eff": (0.0, "errors 0"), "ptrans": (0.0, "error 0"),
         "hpl": (1.0, "residual < 1"), "hpl_single": (1.0, "residual < 1"),
         "stream": (0.0, "error 0"), "randomaccess": (0.0, "error 0"),
         "fft": (1e-5, "error < 1e-5"),
         "gemm": (16 * torch.finfo(torch.float32).eps,
                  "error <= 16 fp32 eps")}


def gate_ok(name: str, err: float) -> bool:
    """Whether a row's error passes its benchmark's gate (a strict bound
    for residuals and FFT, equality for the exact ones)."""
    limit = GATES[name][0]
    if name in ("hpl", "hpl_single", "fft"):
        return err < limit
    return err <= limit
