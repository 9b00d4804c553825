"""End-to-end training driver: train a ~100M-parameter dense LM for a few
hundred steps with checkpointing, fault tolerance, and the (data, model)
mesh over the local processes.

    python -m repro_torch.examples.train_lm [--steps 300] [--arch llama3-8b]
        [--device cuda|cpu] [--ranks 1|4]

Port of ``examples/train_lm.py``: the assigned arch's family scaled to
~100M parameters (d_model 512, 8 layers, vocab 8192), ``train_loop`` on
``make_local_mesh()`` over ``--ranks`` processes (1, the default: the
one-rank mesh; 4: a 2x2 mesh of gloo processes sharing the card, where
the reference takes 8 placeholder devices), with checkpoints every 50
steps under ``--ckpt`` (default: a directory under the system's temporary
directory). For the full config use the launcher,
``python -m repro_torch.launch.train --full``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.examples import _ranks


def train(device, args):
    """The loop on this process: printable lines."""
    from repro_torch.configs import RunConfig, get_config, reduced
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.loop import TrainLoopConfig, train_loop

    # ~100M params: d_model 512, 8 layers of the chosen family
    cfg = reduced(get_config(args.arch), layers=8, d_model=512, vocab=8192)
    lines = [f"arch family {cfg.family}, params ~"
             f"{cfg.param_count() / 1e6:.1f}M"]
    run = RunConfig(learning_rate=3e-4, warmup_steps=args.steps // 10,
                    checkpoint_dir=args.ckpt, checkpoint_every=50,
                    remat="none")
    data = DataConfig(vocab_size=cfg.vocab_size, global_batch=args.batch,
                      seq_len=args.seq)
    mesh = make_local_mesh()
    lines.append(f"mesh: {dict(mesh.shape)}")
    hist = train_loop(cfg, run, data,
                      TrainLoopConfig(steps=args.steps, log_every=20),
                      mesh=mesh, device=device)
    floor = SyntheticLMDataset(data).entropy_floor()
    step = sorted(hist["step_time"])[len(hist["step_time"]) // 2]
    lines += [f"\nloss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f} "
              f"(dataset entropy floor ~{floor:.3f})",
              f"median step: {step * 1e3:.0f} ms",
              f"straggler summary: {hist['straggler']}"]
    return lines, hist["loss"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    _ranks.add_args(ap)
    args = ap.parse_args(argv)
    device = _ranks.check_device(args.device)
    lines, losses = _ranks.run(train, args.ranks, device, args)
    print("\n".join(lines))
    return losses


if __name__ == "__main__":
    main()
