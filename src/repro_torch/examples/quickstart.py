"""Quickstart: the paper's three benchmarks + a tiny LM, in one script.

    python -m repro_torch.examples.quickstart [--device cuda|cpu]
        [--ranks 1|4]

Port of ``examples/quickstart.py``: b_eff over a ring, PTRANS + HPL over
a torus (both communication backends, like the paper's PCIe+MPI vs IEC),
then 20 training steps of a reduced llama-family model. ``--ranks 1``
(the default) runs one process on the card, a ring of one and a 1x1
torus; ``--ranks 4`` four gloo processes sharing it, a ring of 4 and a
2x2 torus, where the reference takes 8 placeholder devices.
"""
from __future__ import annotations

import argparse

from repro_torch.examples import _ranks


def suite(device):
    """The three benchmarks on this process's meshes: printable rows."""
    from repro_torch.comm.types import CommunicationType as CT
    from repro_torch.core.beff import run_beff
    from repro_torch.core.hpl import run_hpl
    from repro_torch.core.ptrans import run_ptrans

    ring, torus = _ranks.meshes()
    lines = [f"\n-- b_eff (paper §2.1): ring over {ring.axis('x').size} "
             "ranks --"]
    for ct in (CT.ICI_DIRECT, CT.HOST_STAGED):
        res = run_beff(ring, ct, max_log=10, reps=1, rounds=2, device=device)
        lines.append(f"  {ct.value:12s} b_eff = {res.metric/1e6:8.2f} MB/s "
                     f"(errors={res.error})")
    pg = torus.shape["rows"]
    lines.append(f"\n-- PTRANS (paper §2.2): C = B + A^T on a {pg}x{pg} "
                 "grid --")
    for ct in (CT.ICI_DIRECT, CT.HOST_STAGED):
        res = run_ptrans(torus, ct, n=256, b=64, reps=1, device=device)
        lines.append(f"  {ct.value:12s} {res.metric:6.3f} GFLOP/s "
                     f"(max err {res.error:.2e})")
    lines.append(f"\n-- HPL (paper §2.3): LU on a {pg}x{pg} torus --")
    for ct, sched in ((CT.ICI_DIRECT, "native"), (CT.ICI_DIRECT, "chain"),
                      (CT.HOST_STAGED, "staged")):
        res = run_hpl(torus, ct, n=256, b=32, schedule=sched, reps=1,
                      device=device)
        lines.append(f"  {ct.value:12s}/{sched:6s} {res.metric:6.3f} GFLOP/s "
                     f"(residual {res.error:.2e})")
    return lines


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    _ranks.add_args(ap)
    args = ap.parse_args(argv)
    device = _ranks.check_device(args.device)

    from repro_torch.configs import RunConfig, get_config, reduced
    from repro_torch.data import DataConfig
    from repro_torch.train.loop import TrainLoopConfig, train_loop

    print("== HPCC-PyTorch quickstart ==")
    print("\n".join(_ranks.run(suite, args.ranks, device)))

    print("\n-- LM training (reduced llama3.2-3b, 20 steps) --")
    cfg = reduced(get_config("llama3.2-3b"))
    run = RunConfig(learning_rate=1e-3, warmup_steps=4)
    data = DataConfig(vocab_size=cfg.vocab_size, global_batch=8, seq_len=64)
    hist = train_loop(cfg, run, data, TrainLoopConfig(steps=20, log_every=5),
                      device=device)
    print(f"  loss: {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f}")
    print("\nquickstart done.")
    return hist


if __name__ == "__main__":
    main()
