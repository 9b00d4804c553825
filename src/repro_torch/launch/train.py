"""Training launcher's fault flags.

Port of ``repro/launch/train.py::parse_fault_args`` (``:23-43``), which
the serving launcher (:mod:`repro_torch.launch.serve`) shares. The
training loop itself is :func:`repro_torch.train.loop.train_loop`; the
launcher around it (``main``: argument parsing and the loop on the local
devices) waits for ROADMAP A14.
"""
from __future__ import annotations


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
