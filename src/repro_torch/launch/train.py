"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]``.

Port of ``repro/launch/train.py``: ``parse_fault_args`` (``:23-43``),
which the serving launcher (:mod:`repro_torch.launch.serve`) shares, and
``main`` (``:46-113``), with the reference's flags, defaults and choices.
It runs the fault-tolerant loop (:func:`repro_torch.train.loop.train_loop`)
with the reduced config (``--reduced``, the default) or the full one
(``--full``), on the card unless ``--device`` says otherwise.

The port adds two flags, as the serving launcher does: ``--device``
(default ``cuda``; it raises when no card is present, and the CPU runs
only when asked for) and ``--ranks`` (default 4), which stands in for the
reference's device count under ``--mesh``: ``--mesh`` spawns ``--ranks``
gloo processes, each building ``make_local_mesh()`` (the squarest
``(data, model)`` grid over them), or ``make_local_mesh(("x",))`` for a
rank-loss timeline (``--fail-rank``), whose elastic resume rebuilds a
ring on the survivors (:func:`~repro_torch.train.loop.train_loop_elastic`).
Rank 0 prints (the first survivor, if rank 0 was the one lost).

Besides the reference's lines it prints the parameter count, the losses,
tokens per second of the median step, the peak device memory on the card,
and one ``record:`` line of JSON with those figures and the printing
rank's kernel launches (``ops.launch_counts``).
"""
from __future__ import annotations

import argparse
import json
import logging
import statistics
import time

import torch

from repro_torch.configs import RunConfig, get_config, list_archs, reduced
from repro_torch.data import DataConfig
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.train.loop import (TrainLoopConfig, train_loop,
                                    train_loop_elastic)

# seconds the processes of a --mesh run may take
MESH_TIMEOUT = 3600.0


def parse_fault_args(fault_schedule, fail_rank):
    """Build the FaultSchedule a launcher's fault flags describe.

    ``fault_schedule`` is the :meth:`FaultSchedule.parse` spec string
    (``action@start[-end]:k=v,...`` separated by ``;``); ``fail_rank`` is
    the ``RANK@STEP`` shorthand appended to it as a rank-loss event.
    Returns None when neither flag is set.
    """
    if not fault_schedule and not fail_rank:
        return None
    from repro_torch.comm.faults import FaultInjector, FaultSchedule
    spec = fault_schedule or ""
    if fail_rank:
        try:
            rank, at = fail_rank.split("@")
            part = f"fail_rank@{int(at)}:rank={int(rank)}"
        except ValueError:
            raise SystemExit(f"--fail-rank wants RANK@STEP, got "
                             f"{fail_rank!r}") from None
        spec = f"{spec};{part}" if spec else part
    return FaultSchedule.parse(FaultInjector(), spec)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="train the reduced same-family config (CPU-sized)")
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--comm", default="ici_direct",
                    choices=["ici_direct", "host_staged"])
    ap.add_argument("--mesh", action="store_true",
                    help="use a (data, model) mesh over --ranks processes")
    ap.add_argument("--fault-schedule", default=None, metavar="SPEC",
                    help="scripted fault timeline "
                         "(repro_torch.comm.faults.FaultSchedule.parse), "
                         "e.g. 'degrade@5-20:axis=x,hop=1,beta_scale=64' or "
                         "'down@5-20:axis=x,hop=3;fail_rank@12:rank=3'")
    ap.add_argument("--fail-rank", default=None, metavar="RANK@STEP",
                    help="shorthand: lose rank RANK at step STEP and "
                         "resume elastically on the survivors (needs "
                         "--mesh and --checkpoint-dir)")
    ap.add_argument("--device", default="cuda",
                    help="where to train (default: the card)")
    ap.add_argument("--ranks", type=int, default=4,
                    help="processes of a --mesh run (the reference's device "
                         "count)")
    return ap


def configs(args):
    """(model config, RunConfig, DataConfig, TrainLoopConfig, elastic)
    from the flags, as the reference builds them (``:78-96``)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    run = RunConfig(comm_type=args.comm, microbatches=args.microbatches,
                    remat=args.remat, learning_rate=args.lr,
                    warmup_steps=max(args.steps // 10, 1),
                    checkpoint_dir=args.checkpoint_dir,
                    checkpoint_every=args.checkpoint_every)
    data = DataConfig(vocab_size=cfg.vocab_size, global_batch=args.batch,
                      seq_len=args.seq)
    fault = parse_fault_args(args.fault_schedule, args.fail_rank)
    elastic = fault is not None and any(e.action == "fail_rank"
                                        for e in fault.events)
    return cfg, run, data, TrainLoopConfig(steps=args.steps,
                                           fault_schedule=fault), elastic


def _train(args, device, mesh=None):
    """The loop on this process: ``mesh`` None for one process, else this
    rank's mesh. Returns (history, recovery, peak device bytes)."""
    from repro_torch.kernels import ops

    cfg, run, data, lcfg, elastic = configs(args)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    if elastic:
        hist, recovery = train_loop_elastic(cfg, run, data, lcfg, mesh=mesh,
                                            device=device)
    else:
        hist, recovery = train_loop(cfg, run, data, lcfg, mesh=mesh,
                                    device=device), None
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else None)
    hist["kernel_launches"] = ops.launch_counts()
    return hist, recovery, peak


def _rank(_ring, args, device, elastic):
    """One process of a --mesh run (module level, so that spawned
    processes import it)."""
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(0)
    mesh = make_local_mesh(("x",)) if elastic else make_local_mesh()
    return _train(args, device, mesh) + (dict(mesh.shape),)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --device cpu to "
                         "train on the CPU")
    cfg, run, data, _, elastic = configs(args)
    if elastic and (not args.mesh or not args.checkpoint_dir):
        raise SystemExit("a fail_rank timeline needs --mesh and "
                         "--checkpoint-dir (elastic resume restores "
                         "the resharded checkpoint)")
    print(f"arch={args.arch} ({'reduced' if args.reduced else 'full'}) "
          f"params={cfg.param_count()} batch={args.batch} seq={args.seq} "
          f"remat={args.remat} device={device} "
          f"ranks={args.ranks if args.mesh else 1}", flush=True)
    t0 = time.perf_counter()
    if args.mesh:
        from repro_torch.launch import train as this  # not __main__
        from repro_torch.launch.mesh import spawn_mesh

        results = spawn_mesh(args.ranks, this._rank, args, str(device),
                             elastic, axes=("x",), timeout=MESH_TIMEOUT)
        # rank 0 prints: the first survivor if rank 0 sat out
        hist, recovery, peak, mesh_shape = next(
            (r for r in results if not (r[1] or {}).get("sat_out")),
            results[0])
    else:
        hist, recovery, peak = _train(args, device)
        mesh_shape = None
    wall = time.perf_counter() - t0

    if recovery is not None:
        print(f"recovered from rank loss {recovery['lost_ranks']} at "
              f"step {recovery['fail_step']}: resumed on "
              f"{recovery['new_size']}/{recovery['old_size']} devices "
              f"from step {recovery['resume_step']} in "
              f"{recovery['recovery_s']:.2f}s")
    times = hist["step_time"]
    median = sorted(times)[len(times) // 2]
    print(f"final loss {hist['loss'][-1]:.4f} "
          f"(first {hist['loss'][0]:.4f}); "
          f"median step {median:.3f}s")
    print("straggler summary:", hist["straggler"])
    tokens = args.batch * args.seq
    record = {"arch": args.arch, "full": not args.reduced,
              "params": cfg.param_count(), "batch": args.batch,
              "seq": args.seq, "remat": args.remat, "device": str(device),
              "mesh": mesh_shape, "losses": hist["loss"],
              "step_s": times, "median_step_s": median,
              "median_step_s_after_first": (statistics.median(times[1:])
                                            if len(times) > 1 else median),
              "tokens_per_s": tokens / median,
              "peak_memory_bytes": peak, "recovery": recovery,
              "kernel_launches": hist["kernel_launches"],
              "wall_s": wall}
    print(f"losses {[round(x, 4) for x in hist['loss']]}; "
          f"{record['tokens_per_s']:.1f} tokens/s at the median step"
          + (f"; peak memory {peak / 1e9:.2f} GB" if peak else ""))
    print("record: " + json.dumps(record, default=str))
    return record


if __name__ == "__main__":
    main()
