"""The port's benchmark driver against ``benchmarks/run.py``.

``MODULES``, ``ALIASES``, ``SWEEP_OPS``, ``PIPELINE_SWEEP`` and
``PIPELINE_DEPTHS`` equal the reference's, read with ``ast`` (importing
``benchmarks/run.py`` sets XLA's device flags). A ``--sweep-schedules
--quick --device cpu`` run of b_eff (the cheapest driver with a collective
op) runs once per ``schedules_for("ring_exchange") + ["auto"]`` and
records those columns in ``torch_schedule_sweep.json``, written into a
temporary results directory; PTRANS also gets its pipeline-depth columns.
``--sweep-schedules`` with ``--schedule`` raises the reference's message.
"""
from __future__ import annotations

import ast
import json
from pathlib import Path

import pytest
import torch

from repro_torch.benchmarks import common
from repro_torch.benchmarks import run as bench_run
from repro_torch.comm.engine import schedules_for

REFERENCE = Path(__file__).resolve().parents[1] / "benchmarks" / "run.py"
NAMES = ("MODULES", "ALIASES", "SWEEP_OPS", "PIPELINE_SWEEP",
         "PIPELINE_DEPTHS")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_constants():
    tree = ast.parse(REFERENCE.read_text())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                getattr(node.targets[0], "id", None) in NAMES:
            out[node.targets[0].id] = ast.literal_eval(node.value)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_constants_equal_reference(name):
    assert getattr(bench_run, name) == _reference_constants()[name]


def test_every_module_is_a_port_driver():
    import importlib

    for name in bench_run.MODULES:
        assert callable(importlib.import_module(
            f"repro_torch.benchmarks.{name}").main)


def test_sweep_and_schedule_are_exclusive():
    with pytest.raises(SystemExit,
                       match="--sweep-schedules and --schedule are "
                             "mutually exclusive"):
        bench_run.main(["--sweep-schedules", "--schedule", "chain", "beff"])


@pytest.fixture
def results(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "RESULTS", tmp_path)
    return tmp_path


@pytest.mark.parametrize("module,op", [("beff", "ring_exchange"),
                                       ("ptrans", "grid_transpose")])
def test_sweep_columns(results, module, op):
    bench_run.main(["--sweep-schedules", "--quick", "--device", "cpu",
                    module])
    rec = json.loads((results / "torch_schedule_sweep.json").read_text())
    name = bench_run.ALIASES[module]
    assert list(rec[name]) == list(schedules_for(op)) + ["auto"]
    if name in bench_run.PIPELINE_SWEEP:
        assert list(rec[f"{name}/pipeline"]) == [
            f"S={s}" for s in bench_run.PIPELINE_DEPTHS]
    else:
        assert f"{name}/pipeline" not in rec
