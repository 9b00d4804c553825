"""A run driven whole on the CPU at small sizes: the last line's shape,
the exit codes, the trace's reduction, and ``correct`` coming out false
under each fault that the cells can have."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import hpcc_harness as hh
import run
from conftest import BENCH, ROOT


def last_line(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def run_cell(root, cell, trace=0, seed=2 ** 33 + 7, seconds="0.2"):
    return run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                     seconds, "--trace", str(trace)], device="cpu",
                    root=root)


@pytest.mark.parametrize("cell", ["hpl.tiny", "hpl.tiny.la1", "ptrans.tiny"])
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(tiny_root, capsys, cell, trace):
    assert run_cell(tiny_root, cell, trace) == 0
    line = last_line(capsys)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    c = hh.load_cell(tiny_root, cell)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device on the CPU: every reader finds nothing to read
        assert set(line["metrics"]) <= {m["name"] for m in c.per_layer}
    else:
        assert set(line["metrics"]) == {m["name"] for m in c.end_to_end}
        for m in c.end_to_end:
            got = line["metrics"][m["name"]]
            assert got["unit"] == m["unit"] and got["value"] > 0
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}


def test_no_card_no_result(tiny_root, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "hpl.tiny", "--seed", "1", "--seconds", "1",
                   "--trace", "0"], root=tiny_root)
    assert rc == 1
    assert capsys.readouterr().out == ""


def test_only_the_benchmark_files(tmp_path):
    """A directory with BENCHMARK.json and hpcc_bench/ alone has no port to
    run: the run exits non-zero and prints no result."""
    shutil.copytree(BENCH, tmp_path / "hpcc_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "hpcc_bench/run.py", "--workload", "ptrans.n49152",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_summarize():
    device = [("void k1<2>(float*, int)", 10.0, 20.0),
              ("void k1<2>(float*, int)", 15.0, 25.0),   # overlaps
              ("Memcpy DtoD", 40.0, 50.0),
              ("void k2(float*)", 90.0, 100.0)]
    host = [("aten::copy_", 24.0, 42.0), ("cudaLaunchKernel", 30.0, 35.0),
            ("aten::mul", 60.0, 95.0)]
    s = hh.summarize(device, host, 120e-6)
    assert s.window_s == pytest.approx(120e-6)
    assert s.busy_s == pytest.approx((15 + 10 + 10) * 1e-6)
    assert s.device_s["k1<2>"] == pytest.approx(20e-6)
    assert s.count() == 4 and s.count("k1") == 2
    assert s.seconds("k2") == pytest.approx(10e-6)
    # gaps 25-40 (mid 32.5: inside cudaLaunchKernel), 50-90 (mid 70:
    # aten::mul); 30 us of the window lie outside 10-100
    assert s.idle_by_host == pytest.approx({
        "cudaLaunchKernel": 15e-6, "aten::mul": 40e-6,
        "window edges (drain, profiler start and stop)": 30e-6})
    assert s.breakdown()["device_ops"][0][0] == "k1<2>"


def test_larger_keeps_nan():
    nan = float("nan")
    assert hh.larger(1.0, 2.0) == 2.0 and hh.larger(3.0, 2.0) == 3.0
    assert hh.larger(1.0, nan) != hh.larger(1.0, nan)
    assert hh.larger(nan, 1.0) != hh.larger(nan, 1.0)


def test_quantile():
    assert hh.quantile([5.0], 0.95) == 5.0
    vals = [float(i) for i in range(1, 101)]
    assert hh.quantile(vals, 0.95) == pytest.approx(95.05)


# --- faults: the timed path broken underneath, correct must come out false


def _unchanged_fact(make):
    def make_broken(*a, **k):
        return lambda a_local: a_local.clone()
    return make_broken


def _half_iterations(orig):
    def it(k, a, g):
        nb = a.shape[0] // g.b
        return a if k >= nb // 2 else orig(k, a, g)
    return it


def _altered_block(orig):
    def lu(a):
        out = orig(a).clone()
        out[1, 0] += 1e-3 * abs(float(out[1, 0])) + 1e-6
        return out
    return lu


@pytest.mark.parametrize("fault", ["state unchanged", "half the work",
                                   "answer altered"])
@pytest.mark.parametrize("cell", ["hpl.tiny", "hpl.tiny.la1"])
def test_hpl_faults(tiny_root, capsys, monkeypatch, cell, fault):
    import repro_torch.core.hpl as hpl
    if fault == "state unchanged":
        monkeypatch.setattr(hpl, "make_factorize",
                            _unchanged_fact(hpl.make_factorize))
    elif fault == "half the work":
        monkeypatch.setattr(hpl, "_iteration", _half_iterations(
            hpl._iteration))
        monkeypatch.setattr(hpl, "_update_writeback", _skip_late_updates(
            hpl._update_writeback))
    else:
        monkeypatch.setattr(hpl, "lu_factor_block",
                            _altered_block(hpl.lu_factor_block))
    assert run_cell(tiny_root, cell) == 0
    line = last_line(capsys)
    assert line["correct"] is False and line["failed"] >= 1


def _skip_late_updates(orig):
    def upd(k, a, lu_blk, u_panel, l_panel, g):
        nb = a.shape[0] // g.b
        return a if k >= nb // 2 else orig(k, a, lu_blk, u_panel, l_panel, g)
    return upd


@pytest.mark.parametrize("fault", ["state unchanged", "half the work",
                                   "answer altered"])
def test_ptrans_faults(tiny_root, capsys, monkeypatch, fault):
    import repro_torch.core.ptrans as ptrans
    orig = ptrans.transpose_add
    if fault == "state unchanged":
        def broken(a, b):
            return b.clone()
    elif fault == "half the work":
        def broken(a, b):
            c = orig(a, b)
            half = c.shape[0] // 2
            c[half:] = b[half:]
            return c
    else:
        def broken(a, b):
            c = orig(a, b)
            c[3, 5] = torch.nextafter(c[3, 5], c[3, 5] + 1)
            return c
    monkeypatch.setattr(ptrans, "transpose_add", broken)
    assert run_cell(tiny_root, "ptrans.tiny") == 0
    line = last_line(capsys)
    assert line["correct"] is False and line["failed"] >= 1


@pytest.mark.card
def test_on_the_card(card, tmp_path):
    """One short run of the PTRANS cell on the card, and its traced run."""
    for trace in ("0", "1"):
        proc = subprocess.run(
            [sys.executable, "hpcc_bench/run.py", "--workload", "ptrans.n49152",
             "--seed", "3", "--seconds", "2", "--trace", trace], cwd=ROOT,
            capture_output=True, text=True, timeout=1200)
        assert proc.returncode == 0, proc.stderr[-2000:]
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        assert line["correct"] is True
        assert line["device"]["platform"] == "gpu"


def test_controls_read_above_the_port(tiny_root, capsys):
    """controls.py on the CPU at the small cells: every HPL number of the
    port under its limit; each control of the update over update_gap's, the
    TF32 LU over every limit; PTRANS exact, its control inexact."""
    import controls
    hpl = controls.main(["--workload", "hpl.tiny", "--seeds", "1",
                         str(2 ** 40 + 3), "--control-seeds", "1"],
                        device="cpu", root=tiny_root)
    lim = hpl["limits"]
    assert all(v <= lim[k] for k, v in hpl["port_max"].items())
    assert set(hpl["control_min"]) == {"tf32", "update.tf32", "update.bf16",
                                       "bf16_route"}
    for name, got in hpl["control_min"].items():
        assert got["update_gap"] > lim["update_gap"], name
    assert all(v > lim[k] for k, v in hpl["control_min"]["tf32"].items()
               if k != "residual")
    pt = controls.main(["--workload", "ptrans.tiny", "--seeds", "2",
                        "--control-seeds", "2"], device="cpu", root=tiny_root)
    assert pt["port_max"] == {"c_gap": 0.0}
    assert pt["control_min"]["bf16"]["c_gap"] > 0


def test_a_reader_that_finds_nothing_fails_on_the_card(tiny_root):
    """On the card (strict) a per-layer metric with nothing to read is an
    error naming it; on the CPU it is left out."""
    cell = hh.load_cell(tiny_root, "hpl.tiny")
    ctx = hh.Context(cell=cell, units=1,
                     trace=hh.summarize([], [], 1.0), launches={},
                     unit_s=None, peaks=None)
    assert "hpl_mfu" not in hh.read_metrics(ctx)
    with pytest.raises(hh.BenchError, match="hpl_mfu"):
        hh.read_metrics(ctx, strict=True)
