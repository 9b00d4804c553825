"""Continuous-batching serving over the paged KV cache: the loop is
:mod:`repro_torch.serve.engine`, admission and slot bookkeeping
:mod:`repro_torch.serve.scheduler`."""
from repro_torch.serve.engine import SERVE_MODES, ServeEngine
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["SERVE_MODES", "ServeEngine", "Request", "Scheduler"]
