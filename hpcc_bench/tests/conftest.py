"""Fixtures of the benchmark's own tests (run on the CPU, by hand:
``python -m pytest hpcc_bench/tests`` from the root of the checkout).

``tiny_root`` is a copy of the benchmark in a temporary directory, with
the port's ``src`` linked beside it and small cells added as files, so
that the harness runs whole on the CPU, through the port's plain kernel
versions.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

# HPL's limits at n = 256 on the CPU, where the port reads lu_gap ~7e-7,
# update_gap ~7e-7 and residual ~0.012, and the TF32 update 1.5e-5, 2.1e-4
# and 0.011 (the residual is the TF32 LU's to fail)
LIMITS = {"lu_gap": 1e-5, "update_gap": 2e-5, "residual": 0.05}
TINY = {
    "hpl.tiny": {"config": "hpl-ai.fp32.b64", "traffic": "n256.eager",
                 "params": {"n": 256, "lookahead": 0}, "trace_units": 2,
                 "limits": LIMITS},
    "hpl.tiny.la1": {"config": "hpl-ai.fp32.b64", "traffic": "n256.la1",
                     "params": {"n": 256, "lookahead": 1},
                     "trace_units": 2, "limits": LIMITS},
    "ptrans.tiny": {"config": "ptrans.fp32.b128", "traffic": "n256.c1",
                    "params": {"n": 256, "nchunks": 1}, "trace_units": 3},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips where there is none")


@pytest.fixture
def card():
    """Skip the test unless a CUDA device is present."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def add_cell(root: Path, name: str, spec: dict) -> None:
    """Add the cell ``name`` to the benchmark under ``root``: its file under
    ``workloads/`` and its entry in ``BENCHMARK.json``, on every metric that
    names cells of its driver."""
    spec = {"name": name, "chips": 1, "why": "a small cell for tests",
            **spec}
    (root / "hpcc_bench" / "workloads" / f"{name}.json").write_text(
        json.dumps(spec))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["workloads"].append({k: spec[k] for k in
                                  ("name", "config", "traffic", "chips",
                                   "why")})
    family = name.split(".")[0] + "."
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        cells = m.get("workloads")
        if cells is not None and any(c.startswith(family) for c in cells):
            cells.append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    shutil.copytree(BENCH, tmp_path / "hpcc_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    (tmp_path / "src").symlink_to(ROOT / "src")
    for name, spec in TINY.items():
        add_cell(tmp_path, name, spec)
    return tmp_path
