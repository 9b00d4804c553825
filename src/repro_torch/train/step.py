"""Train-step factories.

Port of ``repro/train/step.py``. Two step builders mirror the paper's two
``ExecutionImplementation`` s, as in the reference:

* :func:`make_train_step`, the one-rank path (the reference's GSPMD step
  on a mesh whose every axis has size 1): forward and backward through
  autograd, gradient accumulation over ``RunConfig.microbatches`` in the
  reference's batch-major split, the ``RunConfig.remat`` policy, the
  global-norm clip and AdamW;
* :func:`make_dp_train_step_explicit`, the explicit data-parallel step:
  every rank of a :class:`~repro_torch.launch.mesh.ProcessMesh` axis runs
  the step on its rows of the global batch and reduces the gradients by
  hand through the collective engine, ``allreduce_tree`` under the
  ``dp.grads`` callsite, or leaf by leaf with int8 error feedback
  (``RunConfig.grad_compression="int8_ef"``).

The reference's jitted steps donate the state (``donate_argnums``); here
the steps update the state in place, leaf by leaf under ``torch.no_grad``
(:func:`repro_torch.optim.adamw.adamw_update_`), and return it.
Training takes the plain ``attention``, as the reference does: its flash
kernel has no VJP and runs only in prefill.

Not yet ported, with ROADMAP A12's second half (the sharding specs and the
parallel model): ``state_specs``, ``shard_state``,
``whole_model_param_specs``, ``make_whole_model_train_step_explicit``, and
the ``fsdp`` / ZeRO-1 placement of ``make_train_step``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import sharding as sh
from repro_torch.comm import compression
from repro_torch.comm.callsites import DP_GRADS
from repro_torch.comm.engine import CollectiveEngine
from repro_torch.comm.overlap import tree_flatten, tree_unflatten
from repro_torch.comm.types import comm_type
from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import single_rank_mesh
from repro_torch.models.model import Model, next_token_loss
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update_,
                                     clip_scale, global_norm,
                                     make_lr_schedule)


@dataclass
class TrainState:
    """``params``: the model's weights (a parameter module, gradients on);
    ``opt``: ``{'mu', 'nu'}`` fp32 trees shaped like ``params.tree()`` and
    ``'count'``; ``step``: the int32 step on the host; ``error``: the
    compression error-feedback tree, or None."""
    params: object
    opt: Dict
    step: torch.Tensor
    error: Optional[Dict] = None


def init_train_state(model: Model, seed: int = 0, *,
                     compression_on: bool = False,
                     device=None) -> TrainState:
    """Weights from ``model.init(seed)`` with gradients on, zero moments,
    step 0, and a zero error tree when ``compression_on``."""
    params = model.init(seed, device=device)
    params.requires_grad_(True)
    tree = params.tree()
    return TrainState(params=params, opt=adamw_init(tree),
                      step=torch.zeros((), dtype=torch.int32),
                      error=(compression.init_error_tree(tree)
                             if compression_on else None))


def _adamw(run_cfg: RunConfig, adamw: Optional[AdamWConfig]) -> AdamWConfig:
    return adamw or AdamWConfig(lr=run_cfg.learning_rate,
                                weight_decay=run_cfg.weight_decay,
                                max_grad_norm=run_cfg.max_grad_norm)


def _device(params) -> torch.device:
    return next(params.parameters()).device


def _on(batch: Dict, device, rows: slice = slice(None)) -> Dict:
    return {k: torch.as_tensor(v)[rows].to(device) for k, v in batch.items()}


def _backward(params, loss_fn, batch) -> Tuple[torch.Tensor, list]:
    """The loss and its gradient, one tensor per leaf of
    ``params.tree()`` in tree order (zeros for a weight the loss does not
    reach, as the reference's ``value_and_grad`` gives)."""
    leaves = tree_flatten(params.tree(data=False))[0]
    for p in leaves:
        p.grad = None
    loss = loss_fn(params, batch)
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in leaves]
    for p in leaves:
        p.grad = None
    return loss.detach(), grads


def _apply_update(state: TrainState, grads: list, adamw: AdamWConfig,
                  schedule: Callable) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clip by the global norm and take the AdamW step in place; returns
    (grad_norm, lr)."""
    gnorm = global_norm(grads)
    lr = schedule(state.step)
    adamw_update_(grads, state.opt, state.params.tree(data=False), adamw, lr,
                  scale=clip_scale(gnorm, adamw.max_grad_norm))
    state.step = state.step + 1
    return gnorm, lr


# ---------------------------------------------------------------------------
# the one-rank step
# ---------------------------------------------------------------------------


def make_train_step(model: Model, run_cfg: RunConfig, mesh=None, *,
                    adamw: Optional[AdamWConfig] = None,
                    total_steps: int = 10_000) -> Callable:
    """``(state, batch) -> (state, metrics)``, updating ``state`` in place.
    ``mesh`` (default: the one-rank mesh) must have every axis of size 1;
    ``metrics`` holds the fp32 scalars ``loss``, ``grad_norm`` and
    ``lr``."""
    adamw = _adamw(run_cfg, adamw)
    schedule = make_lr_schedule(adamw.lr, run_cfg.warmup_steps, total_steps)
    mesh = mesh if mesh is not None else single_rank_mesh(("x",))
    shard = sh.make_shard_fn(mesh, sh.rules_for(mesh))
    nmicro = max(run_cfg.microbatches, 1)

    def loss_fn(params, batch):
        logits, _, _ = model.apply(params, batch, shard=shard,
                                   remat=run_cfg.remat)
        return next_token_loss(logits, batch["tokens"])

    def compute_grads(params, batch):
        device = _device(params)
        if nmicro == 1:
            return _backward(params, loss_fn, _on(batch, device))
        # gradient accumulation over the batch-major split: microbatch k
        # is rows [k * b / n, (k + 1) * b / n), as the reference's reshape
        b = len(batch["tokens"])
        if b % nmicro:
            raise ValueError(f"a batch of {b} rows does not split into "
                             f"{nmicro} microbatches")
        m = b // nmicro
        acc_loss, acc = None, None
        for k in range(nmicro):
            loss, grads = _backward(params, loss_fn,
                                    _on(batch, device, slice(k * m,
                                                             (k + 1) * m)))
            if acc is None:
                acc_loss = torch.zeros((), dtype=torch.float32,
                                       device=device)
                acc = [torch.zeros(g.shape, dtype=torch.float32,
                                   device=device) for g in grads]
            for a, g in zip(acc, grads):
                a.add_(g.float() / nmicro)
            acc_loss = acc_loss + loss / nmicro
            del grads
        return acc_loss, acc

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        loss, grads = compute_grads(state.params, batch)
        gnorm, lr = _apply_update(state, grads, adamw, schedule)
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


# ---------------------------------------------------------------------------
# the explicit data-parallel step
# ---------------------------------------------------------------------------

# the tuning-table callsite of the bucketed gradient reduction: a measured
# ``allreduce@dp.grads`` entry wins over the isolated allreduce's
GRADS_CALLSITE = DP_GRADS


def make_dp_train_step_explicit(model: Model, run_cfg: RunConfig, mesh, *,
                                axis: str = "x",
                                adamw: Optional[AdamWConfig] = None,
                                schedule_kind: str = "auto",
                                bucket_bytes: Optional[int] = None,
                                total_steps: int = 10_000,
                                cost_model=None) -> Callable:
    """Data-parallel step with hand-written gradient reduction, run by
    every rank of ``mesh``'s ``axis`` on its own process.

    ``(state, batch) -> (state, metrics)``: ``batch`` is the global batch,
    the same on every rank; rank i trains on rows [i * b / n, (i + 1) * b
    / n), the rows ``shard_map``'s ``P(axis)`` gives it in the reference.
    Its gradients, divided by the rank count, are summed over the axis by
    :meth:`~repro_torch.comm.engine.CollectiveEngine.allreduce_tree` in
    ~``bucket_bytes`` buckets (None: the cost model's size) under the
    ``dp.grads`` callsite, with the registered schedule ``schedule_kind``
    (``"auto"`` resolves per bucket through the cost model, or
    ``cost_model`` when given); the loss through ``engine.allreduce``.
    ``run_cfg.comm_type`` picks ICI_DIRECT or HOST_STAGED.

    With ``run_cfg.grad_compression == "int8_ef"`` the gradients reduce
    leaf by leaf through :func:`repro_torch.comm.compression.
    compressed_psum` (per-leaf error state cannot be bucketed without
    re-blocking the quantizer), riding the engine's schedules, and the
    state's error tree carries the residuals. Every rank then holds the
    same reduced gradients and takes the same AdamW step, so the weights
    stay replicated (bit for bit wherever the schedule gives every rank
    the same bits)."""
    adamw = _adamw(run_cfg, adamw)
    schedule = make_lr_schedule(adamw.lr, run_cfg.warmup_steps, total_steps)
    engine = CollectiveEngine.for_mesh(mesh, comm_type(run_cfg.comm_type),
                                       schedule_kind, cost_model=cost_model)
    compress = run_cfg.grad_compression == "int8_ef"
    ax = mesh.axis(axis)
    ndev = ax.size

    def loss_fn(params, batch):
        logits, _, _ = model.apply(params, batch, remat=run_cfg.remat)
        return next_token_loss(logits, batch["tokens"])

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        rows = len(batch["tokens"])
        if rows % ndev:
            raise ValueError(f"a global batch of {rows} rows does not split "
                             f"over {ndev} ranks")
        b = rows // ndev
        local = _on(batch, _device(state.params),
                    slice(ax.index * b, (ax.index + 1) * b))
        loss, grads = _backward(state.params, loss_fn, local)
        grads = [g.float() / ndev for g in grads]
        if compress:
            errors, spec = tree_flatten(state.error)
            red, new_errors = [], []
            for g, e in zip(grads, errors):
                r, ne = compression.compressed_psum(g, axis, e,
                                                    engine=engine)
                red.append(r)
                new_errors.append(ne)
            state.error = tree_unflatten(spec, new_errors)
        else:
            spec = tree_flatten(state.params.tree())[1]
            red = tree_flatten(engine.allreduce_tree(
                tree_unflatten(spec, grads), axis, bucket_bytes=bucket_bytes,
                callsite=GRADS_CALLSITE))[0]
        del grads
        loss = engine.allreduce(loss / ndev, axis)
        gnorm, lr = _apply_update(state, red, adamw, schedule)
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    train_step.engine = engine
    return train_step
