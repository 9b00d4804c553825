"""The port's four examples (``python -m repro_torch.examples.<name>``) on
the CPU, against the reference's examples.

Each runs on one process with ``--device cpu`` at its smallest settings
(``--quick`` where the reference example has it, three steps for
``train_lm``): its rows and sections are named as the reference example's
(read from its source), and every gate holds. ``hpcc_suite --ranks 4``
runs the suite on one gloo world (a ring of 4, a 2x2 torus), the file's
one world. On the CPU every kernel runs as its plain version, so no row
launches a kernel (the launch counts are held on the card by
``chip_smoke.py``'s phase launch).
"""
from __future__ import annotations

import re
from pathlib import Path

import pytest
import torch

from repro_torch.examples import (_ranks, hpcc_suite, quickstart, serve_lm,
                                  train_lm)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_rows():
    src = (EXAMPLES / "hpcc_suite.py").read_text()
    return re.findall(r'rows\.append\(\("(\w+)"', src)


def _check_suite(rows):
    names = [r["benchmark"] for r in rows]
    # b_eff, ptrans and hpl once per backend, in the reference's order
    want = _reference_rows()
    assert names == want[:3] * 2 + want[3:]
    assert [r["backend"] for r in rows[:6]] == \
        ["ici_direct"] * 3 + ["host_staged"] * 3
    for r in rows:
        assert r["ok"] and _ranks.gate_ok(r["benchmark"], r["error"]), r
        assert r["launches"] == {}


def test_hpcc_suite_one_rank(capsys):
    _check_suite(hpcc_suite.main(["--quick", "--device", "cpu"]))
    assert "gate" in capsys.readouterr().out


def test_hpcc_suite_four_ranks():
    _check_suite(hpcc_suite.main(["--quick", "--device", "cpu", "--ranks",
                                  "4"]))


def test_gates_refuse():
    assert not _ranks.gate_ok("hpl", 1.0)
    assert not _ranks.gate_ok("ptrans", 1e-7)
    assert not _ranks.gate_ok("fft", 1e-5)
    assert _ranks.gate_ok("fft", 9e-6)
    assert set(_ranks.GATES) == set(_reference_rows())


def test_quickstart(capsys):
    hist = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    src = (EXAMPLES / "quickstart.py").read_text()
    for head in re.findall(r'"\\n-- ([A-Za-z_]+)', src):
        assert f"\n-- {head}" in out, head
    assert len(hist["loss"]) == 20 and hist["loss"][-1] < hist["loss"][0]
    assert "residual" in out and "quickstart done." in out


def test_serve_lm(capsys):
    greedy = serve_lm.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("first row:") == 2
    assert out.startswith("greedy") and "\nsampled" in out
    assert len(greedy) == 24
    # greedy decoding is a function of the weights' seed
    assert serve_lm.main(["--device", "cpu"]) == greedy


def test_train_lm(tmp_path, capsys):
    losses = train_lm.main(["--device", "cpu", "--steps", "3", "--batch",
                            "4", "--seq", "64", "--ckpt",
                            str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert len(losses) == 3 and all(map(torch.isfinite,
                                        torch.tensor(losses)))
    assert "mesh: {'data': 1, 'model': 1}" in out
    assert "dataset entropy floor" in out and "median step" in out
    assert (tmp_path / "ckpt").is_dir()


def test_refuse_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs none")
    with pytest.raises(SystemExit, match="--device cpu"):
        hpcc_suite.main(["--quick"])
