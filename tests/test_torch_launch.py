"""The training launcher and ``make_local_mesh`` against the reference.

* ``make_local_mesh``'s shape equals ``repro.launch.mesh.make_local_mesh``'s
  for worlds of 1 to 16 (the reference's device list and mesh constructor,
  and the port's world size and ``make_mesh``, monkeypatched: no devices or
  processes are made).
* ``python -m repro_torch.launch.train``'s flags, defaults and choices
  equal the reference parser's (captured from ``repro.launch.train.main``
  at ``parse_args``), plus ``--device`` and ``--ranks``; its ``SystemExit``
  texts equal the reference's.
* A reduced ``--device cpu`` run equals a direct ``train_loop`` on the same
  configs bit for bit (``train_loop`` itself is held to the reference by
  tests/test_torch_train_loop.py); ``--mesh --ranks 4`` (a 2x2 mesh of gloo
  processes) gives losses within rtol 1e-5 of the one-rank run (measured
  1e-7: the GSPMD step sums in another order); ``--fail-rank 3@3`` prints
  the recovery line. Those two are the file's launcher worlds.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import RunConfig, get_config, reduced
from repro_torch.data import DataConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as launcher
from repro_torch.train.loop import TrainLoopConfig, train_loop


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_shape(monkeypatch, n, axes):
    from repro.launch import mesh as jmesh
    monkeypatch.setattr(jmesh.jax, "devices", lambda: [None] * n)
    monkeypatch.setattr(jmesh, "_make_mesh", lambda shape, names: shape)
    return tuple(jmesh.make_local_mesh(axes))


def _port_shape(monkeypatch, n, axes):
    monkeypatch.setattr(tmesh, "world", lambda: (0, n))
    monkeypatch.setattr(tmesh, "make_mesh",
                        lambda shape, names: tmesh.single_rank_mesh(names)
                        if n == 1 else tuple(shape))
    got = tmesh.make_local_mesh(axes)
    return tuple(got.shape.values()) if n == 1 else got


@pytest.mark.parametrize("axes", [("data", "model"), ("x",)])
def test_make_local_mesh_shape_equals_reference(monkeypatch, axes):
    for n in range(1, 17):
        want = _reference_shape(monkeypatch, n, axes)
        assert _port_shape(monkeypatch, n, axes) == want, n


def test_make_local_mesh_without_process_group():
    mesh = tmesh.make_local_mesh()
    assert mesh.shape == {"data": 1, "model": 1}
    assert tmesh.make_local_mesh(("x",)).shape == {"x": 1}


class _Parsed(Exception):
    pass


def _reference_parser(monkeypatch):
    from repro.launch import train as jtrain

    def capture(self, *a, **k):
        raise _Parsed(self)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Parsed) as e:
        jtrain.main()
    monkeypatch.undo()
    return e.value.args[0]


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                     a.required, a.nargs, a.const)
            for a in parser._actions if a.dest != "help"}


def test_flags_equal_reference(monkeypatch):
    want = _actions(_reference_parser(monkeypatch))
    got = _actions(launcher.build_parser())
    assert set(got) - set(want) == {"device", "ranks"}
    assert {k: got[k] for k in want} == want
    assert got["device"][1] == "cuda" and got["ranks"][1] == 4


@pytest.mark.parametrize("argv", [
    ["--fail-rank", "3@5"],
    ["--fail-rank", "3@5", "--mesh"],
    ["--fail-rank", "3-5", "--mesh", "--checkpoint-dir", "ckpt"],
])
def test_system_exit_texts_equal_reference(monkeypatch, argv):
    from repro.launch import train as jtrain

    base = ["--arch", "llama3.2-3b", "--steps", "2"]
    monkeypatch.setattr(sys, "argv", ["train"] + base + argv)
    with pytest.raises(SystemExit) as want:
        jtrain.main()
    with pytest.raises(SystemExit) as got:
        launcher.main(base + argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value) != ""


def test_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal needs none")
    with pytest.raises(SystemExit, match="--device cpu"):
        launcher.main(["--arch", "llama3.2-3b", "--steps", "1"])


def _direct(steps):
    cfg = reduced(get_config("llama3.2-3b"))
    run = RunConfig(comm_type="ici_direct", microbatches=1, remat="none",
                    learning_rate=1e-3, warmup_steps=max(steps // 10, 1),
                    checkpoint_dir=None, checkpoint_every=50)
    data = DataConfig(vocab_size=cfg.vocab_size, global_batch=8, seq_len=128)
    return train_loop(cfg, run, data, TrainLoopConfig(steps=steps),
                      device="cpu")["loss"]


ARGS = ["--arch", "llama3.2-3b", "--steps", "4", "--device", "cpu"]


@pytest.fixture(scope="module")
def one_rank():
    return launcher.main(ARGS)


def test_one_rank_equals_direct_train_loop(one_rank):
    assert one_rank["losses"] == _direct(4)
    assert one_rank["params"] == reduced(get_config("llama3.2-3b")).\
        param_count()
    assert one_rank["mesh"] is None
    assert all(v == 0 for v in one_rank["kernel_launches"].values())


def test_mesh_of_four_matches_one_rank(one_rank, capsys):
    rec = launcher.main(ARGS + ["--mesh", "--ranks", "4"])
    assert rec["mesh"] == {"data": 2, "model": 2}
    np.testing.assert_allclose(rec["losses"], one_rank["losses"], rtol=1e-5)
    assert "final loss" in capsys.readouterr().out


def test_fail_rank_prints_recovery(tmp_path, capsys):
    rec = launcher.main(["--arch", "llama3.2-3b", "--steps", "5",
                         "--device", "cpu", "--mesh", "--ranks", "4",
                         "--fail-rank", "3@3", "--checkpoint-dir",
                         str(tmp_path / "ckpt"), "--checkpoint-every", "2"])
    out = capsys.readouterr().out
    assert "recovered from rank loss [3] at step 3: resumed on 2/4 " \
           "devices from step 2" in out
    assert rec["recovery"]["lost_ranks"] == [3]
    assert len(rec["losses"]) == 5 and np.all(np.isfinite(rec["losses"]))
