"""The manifest: every cell, configuration, driver and metric that
``BENCHMARK.json`` names is a file found by its name, the file keeps to the
benchmark's contract, and new cells and metrics are picked up as files
alone."""
from __future__ import annotations

import json
import re

import pytest

import hpcc_harness as hh
import run
from conftest import BENCH, ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["hpcc_bench"]
    assert MANIFEST["command"][1] == "hpcc_bench/run.py"
    assert 1 <= MANIFEST["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(MANIFEST)) < 64 * 1024
    assert sum(w["chips"] == 4 for w in MANIFEST["workloads"]) \
        <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_units_and_text(group):
    entries = MANIFEST[group]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and group in ("configs", "workloads", "per_layer"):
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
        for cell in e.get("workloads", []):
            assert cell in CELLS


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = hh.load_cell(ROOT, cell)
    assert (BENCH / "drivers" / f"{c.driver}.py").is_file()
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        mod = hh.load_module(BENCH / "metrics" / f"{m['name']}.py", "metric")
        assert callable(mod.read)
        assert m["moves"] in names
    assert int(c.workload["trace_units"]) >= 1
    for key in ("n", "b"):
        assert int(c.params[key]) > 0
    assert c.chips == 1


@pytest.mark.parametrize("config", MANIFEST["configs"],
                         ids=lambda c: c["name"])
def test_config_file(config):
    path = ROOT / config["file"]
    assert path.parent == BENCH / "configs"
    data = json.loads(path.read_text())
    assert data["name"] == config["name"]
    assert data["reduced"] == config["reduced"]
    assert (BENCH / "drivers" / f"{data['driver']}.py").is_file()
    used = [w for w in MANIFEST["workloads"] if w["config"] == config["name"]]
    assert used


def test_per_layer_layers_and_rooflines():
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_new_cell_and_metric_are_files_alone(tiny_root, capsys):
    """A cell and a per-layer metric added as files (and entries) only are
    run and read, with no edit of the harness."""
    (tiny_root / "hpcc_bench" / "metrics" / "dummy.units.py").write_text(
        "def read(ctx):\n    return float(ctx.units)\n")
    manifest = json.loads((tiny_root / "BENCHMARK.json").read_text())
    manifest["per_layer"].append({
        "name": "dummy.units", "unit": "solves", "better": "higher",
        "source": "program_counter", "layer": "device",
        "moves": "hpl_gflops", "workloads": ["hpl.tiny"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(manifest))
    rc = run.main(["--workload", "hpl.tiny", "--seed", "5", "--seconds",
                   "0.1", "--trace", "1"], device="cpu", root=tiny_root)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metrics"]["dummy.units"] == {"value": 2.0,
                                              "unit": "solves"}


def test_unknown_cell_exits_without_result(tiny_root, capsys):
    rc = run.main(["--workload", "hpl.nope", "--seed", "1", "--seconds",
                   "1", "--trace", "0"], device="cpu", root=tiny_root)
    assert rc == 2
    assert capsys.readouterr().out == ""
