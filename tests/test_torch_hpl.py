"""The port's HPL against the JAX reference, on the CPU.

The same numpy system goes through ``repro.core`` and ``repro_torch.core``.
Problem generation and the block-cyclic layout must agree bit for bit; the
factorization agrees with ``repro.core.hpl_blocked.lu_blocked`` within the
tolerances of ``tests/test_hpl_single.py`` (the port's plain kernels round
in another order than XLA). Within the port, lookahead equals eager bit for
bit and every bcast schedule gives the same bits: on the 1x1 grid here and
on a 2x2 torus of gloo processes, spawned once for this module.

A guard walks the port's sources: nothing there or in ``chip_smoke.py``
imports ``jax`` or ``repro``.
"""
from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import autotune as jautotune
from repro.comm import topology as jtopology
from repro.comm import types as jtypes
from repro.compat import make_mesh
from repro.core import hpl as jhpl
from repro.core import models as jmodels
from repro.core import ptrans as jptrans
from repro.core.hpl_blocked import lu_blocked as jax_lu_blocked
from repro_torch.comm.types import H100_80GB
from repro_torch.core import hpl, models, ptrans
from repro_torch.core.hpl_blocked import lu_blocked, run_hpl_single
from repro_torch.kernels import ops
from repro_torch.launch.mesh import single_rank_mesh, spawn_mesh

REPO = Path(__file__).resolve().parents[1]
CASES = [(64, 32), (128, 32), (128, 64), (192, 64)]
# tests/test_hpl_single.py: LU against LU (block-size invariance) and the
# reconstruction L @ U against A
LU_TOL = dict(rtol=1e-4, atol=1e-4)
RECON_TOL = dict(rtol=1e-4, atol=1e-3)
BCAST = ("chain", "chain_rooted", "native", "ring2d", "staged")
DEPTHS = (0, 1, 2)
TORUS_N, TORUS_B = 128, 32


@pytest.fixture(scope="module")
def jax_lu():
    """The reference's 1x1 factorization, computed once per (n, b)."""
    cache = {}

    def get(n, b):
        if (n, b) not in cache:
            a, _, _ = jhpl.generate_system(n)
            cache[n, b] = np.asarray(jax_lu_blocked(jnp.asarray(a), b))
        return cache[n, b]
    return get


def _port_lu(n, b, lookahead=0):
    a, _, _ = hpl.generate_system(n)
    fact = hpl.make_factorize(single_rank_mesh(), pg=1, nb=n // b, b=b,
                              lookahead=lookahead)
    return fact(torch.from_numpy(a))


# ---------------------------------------------------------------------------
# host side: generation, layout, models, validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [64, 192, 256])
def test_generate_system_bitwise(n):
    for port, ref in zip(hpl.generate_system(n), jhpl.generate_system(n)):
        assert port.dtype == ref.dtype and port.tobytes() == ref.tobytes()


@pytest.mark.parametrize("pg,b", [(1, 32), (2, 32), (2, 16), (3, 16)])
def test_distribute_cyclic_bitwise(pg, b):
    a, _, _ = hpl.generate_system(192)
    port = ptrans.distribute_cyclic(a, pg, b)
    assert port.tobytes() == jptrans.distribute_cyclic(a, pg, b).tobytes()
    back = ptrans.undistribute_cyclic(port, pg, b)
    assert back.tobytes() == jptrans.undistribute_cyclic(port, pg, b).tobytes()
    assert back.tobytes() == a.tobytes()


def test_models_equal_reference():
    for n in (1, 64, 4096, 16384):
        assert models.hpl_flops(n) == jmodels.hpl_flops(n)
    curve = {1024: 10.0, 2048: 25.0, 4096: 40.0}
    assert models.hpl_strong_scaling_model(curve, 8192, [1, 4, 16]) == \
        jmodels.hpl_strong_scaling_model(curve, 8192, [1, 4, 16])


def test_solve_and_residual_match_reference(jax_lu):
    n = 128
    a, x_true, b_vec = hpl.generate_system(n)
    lu = jax_lu(n, 32)
    x = hpl.solve_from_lu(lu, b_vec)
    np.testing.assert_allclose(x, jhpl.solve_from_lu(lu, b_vec), rtol=1e-6,
                               atol=1e-6)
    assert hpl.normalized_residual(a, x, b_vec) == \
        jhpl.normalized_residual(a, x, b_vec)


# ---------------------------------------------------------------------------
# the 1x1 factorization against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,b", CASES)
def test_lu_blocked_matches_reference(jax_lu, n, b):
    a, _, _ = hpl.generate_system(n)
    lu = lu_blocked(torch.from_numpy(a), b).numpy()
    np.testing.assert_allclose(lu, jax_lu(n, b), **LU_TOL)
    l = np.tril(lu, -1) + np.eye(n, dtype=np.float32)
    np.testing.assert_allclose(l @ np.triu(lu), a, **RECON_TOL)


@pytest.mark.parametrize("n,b", CASES[1:3])
def test_from_reference_stack_factors_to_same_result(n, b):
    """A stack distributed by the reference and placed on its 1x1 mesh
    loads through ``from_reference``, factors, and comes back through
    ``to_reference`` in the reference's layout."""
    import jax

    a, _, _ = jhpl.generate_system(n)
    mesh = make_mesh((1, 1), ("rows", "cols"))
    jfact = jhpl.make_factorize(mesh, pg=1, nb=n // b, b=b)
    stack = jax.device_put(jptrans.distribute_cyclic(a, 1, b))
    want = np.asarray(jfact(stack))
    local = hpl.from_reference(np.asarray(stack), "cpu")
    fact = hpl.make_factorize(single_rank_mesh(), pg=1, nb=n // b, b=b)
    got = hpl.to_reference(fact(local))
    assert got.shape == want.shape == (1, n, n)
    np.testing.assert_allclose(got, want, **LU_TOL)
    assert torch.equal(torch.from_numpy(got[0]), _port_lu(n, b))


@pytest.mark.parametrize("n,b", [(128, 32), (256, 64)])
def test_hpl_end_to_end_residual(n, b):
    a, x_true, b_vec = hpl.generate_system(n)
    x = hpl.solve_from_lu(_port_lu(n, b).numpy(), b_vec)
    np.testing.assert_allclose(x, x_true, atol=1e-3)
    assert hpl.normalized_residual(a, x, b_vec) < 1.0


def test_block_size_invariance():
    np.testing.assert_allclose(_port_lu(128, 32).numpy(),
                               _port_lu(128, 64).numpy(), **LU_TOL)


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 9])
def test_lookahead_equals_eager_bitwise(depth):
    """Depth 9 > nb = 4 clamps to the iteration count, as in the
    reference."""
    eager = _port_lu(128, 32)
    assert torch.equal(_port_lu(128, 32, lookahead=depth), eager)


def test_lookahead_depth_normalization():
    for arg in (False, None, True, 0, 1, 3):
        assert hpl.lookahead_depth(arg) == jhpl.lookahead_depth(arg)
    with pytest.raises(ValueError):
        hpl.lookahead_depth(-1)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _reference_details(n, b):
    mesh = make_mesh((1, 1), ("rows", "cols"))
    return jhpl.run_hpl(mesh, n=n, b=b, reps=1).details


@pytest.mark.parametrize("lookahead", [False, 2])
def test_run_hpl_cpu(lookahead):
    res = hpl.run_hpl(n=128, b=32, reps=1, device="cpu", lookahead=lookahead)
    assert res.error < 1.0 and res.metric > 0
    want = _reference_details(128, 32)
    assert set(res.details) == set(want) | {"device", "launches"}
    for key in ("schedule", "schedule_block", "schedule_panel", "comm",
                "bcast_bytes", "block_bytes"):
        assert res.details[key] == want[key]
    assert res.details["lookahead_depth"] == (2 if lookahead else 0)
    assert res.details["device"] == "cpu"
    # on the CPU every kernel runs as its plain version: no launches
    assert res.details["launches"] == {k: 0 for k in ops.KERNELS}
    json.dumps(res.details)


def test_run_hpl_single_cpu():
    res = run_hpl_single(n=128, b=64, reps=1, device="cpu")
    assert res.error < 1.0 and res.details["schedule"] == "local"


def test_entry_points_without_card_raise(monkeypatch):
    """With no card and no ``device="cpu"`` the entry points raise; they
    never quietly run on the CPU."""
    from repro_torch.benchmarks import (beff_bandwidth, hpl_matrix_sweep,
                                        hpl_profile, legacy_suite,
                                        ptrans_scaling)
    from repro_torch.core.beff import run_beff
    from repro_torch.core.gemm import run_gemm
    from repro_torch.core.stream import run_stream

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (lambda: hpl.run_hpl(n=64, b=32),
                  lambda: run_hpl_single(n=64, b=32),
                  lambda: hpl_matrix_sweep.main(quick=True),
                  lambda: hpl_profile.main(n=64, b=32),
                  lambda: ptrans.run_ptrans(n=64, b=32),
                  lambda: run_beff(max_log=2),
                  lambda: run_stream(elems_per_device=128),
                  lambda: run_gemm(m=8),
                  lambda: ptrans_scaling.main(quick=True),
                  lambda: beff_bandwidth.main(quick=True),
                  lambda: legacy_suite.main(quick=True)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()


def test_run_hpl_rejects_auto_lookahead_and_bad_tiling():
    """``lookahead="auto"`` runs at the depth the reference's
    ``choose_hpl_depth`` gives on the port's hardware constants, equal bit
    for bit to that integer depth; a bad tiling still raises."""
    n, b = 128, 32
    res = hpl.run_hpl(n=n, b=b, reps=1, device="cpu", lookahead="auto")
    jaxes = (jtopology.AxisTopology("rows", 1, "torus_row"),
             jtopology.AxisTopology("cols", 1, "torus_col"))
    want = jautotune.choose_hpl_depth(
        b=b, m=n, axes=jaxes, model=jautotune.CostModel(
            hw=jtypes.HardwareModel(**dataclasses.asdict(H100_80GB))))
    assert res.details["lookahead_depth"] == want == 1
    assert res.details["lookahead"] and res.error < 1.0
    a = torch.from_numpy(hpl.generate_system(n)[0])
    mesh = single_rank_mesh()
    auto = hpl.make_factorize(mesh, pg=1, nb=n // b, b=b, lookahead="auto")
    fixed = hpl.make_factorize(mesh, pg=1, nb=n // b, b=b, lookahead=want)
    assert auto(a).numpy().tobytes() == fixed(a).numpy().tobytes()
    with pytest.raises(ValueError):
        hpl.run_hpl(n=100, b=32, device="cpu")


# ---------------------------------------------------------------------------
# a 2x2 torus of gloo processes
# ---------------------------------------------------------------------------


def _torus_world(mesh):
    """Runs on every rank: HPL for each schedule, eager and lookahead."""
    from repro_torch.comm.engine import CollectiveEngine

    n, b = TORUS_N, TORUS_B
    a, _, _ = hpl.generate_system(n)
    local = hpl.from_reference(ptrans.distribute_cyclic(a, 2, b), "cpu")
    out = {}
    for schedule in BCAST:
        eng = CollectiveEngine.for_mesh(mesh, schedule=schedule)
        for depth in DEPTHS:
            fact = hpl.make_factorize(mesh, pg=2, nb=n // b, b=b,
                                      engine=eng, lookahead=depth)
            out[schedule, depth] = hpl.to_reference(fact(local))
    res = hpl.run_hpl(mesh, n=n, b=b, reps=1, device="cpu",
                      schedule="ring2d", lookahead=1)
    out["run_hpl"] = (res.error, res.details["schedule"], res.details["grid"])
    return out if mesh.rank == 0 else None


@pytest.fixture(scope="module")
def torus_results():
    return spawn_mesh(4, _torus_world, timeout=240)[0]


@pytest.mark.parametrize("schedule", BCAST)
@pytest.mark.parametrize("depth", DEPTHS)
def test_torus_hpl_matches_reference(torus_results, jax_lu, schedule, depth):
    lu = ptrans.undistribute_cyclic(torus_results[schedule, depth], 2,
                                    TORUS_B)
    np.testing.assert_allclose(lu, jax_lu(TORUS_N, TORUS_B), **LU_TOL)


@pytest.mark.parametrize("schedule", BCAST)
@pytest.mark.parametrize("depth", DEPTHS)
def test_torus_schedules_and_lookahead_agree_bitwise(torus_results, schedule,
                                                     depth):
    """Every schedule at every depth gives the bits of chain in eager mode,
    which also equal the 1x1 factorization of the same matrix."""
    got = torus_results[schedule, depth]
    assert got.tobytes() == torus_results["chain", 0].tobytes()
    lu = ptrans.undistribute_cyclic(got, 2, TORUS_B)
    assert lu.tobytes() == _port_lu(TORUS_N, TORUS_B).numpy().tobytes()


def test_torus_run_hpl(torus_results):
    err, schedule, grid = torus_results["run_hpl"]
    assert err < 1.0 and schedule == "ring2d" and grid == 2


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_repro(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {name}"
